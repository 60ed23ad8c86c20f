"""Belief-state prediction over a horizon (port of
``reak_tpu/ctrl/predictor.py``; ref: ctrl/ctrl_sys/
belief_state_predictor.hpp:79 belief_predicted_trajectory,
discrete_ss_predicted_traj.hpp, maximum_likelihood_mapping.hpp).

The horizon is one loop of invariant-EKF predict steps that returns the
stacked means and covariances; they interpolate in O(1) and feed the
scenario sampler.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from reak_tpu_torch.ctrl.belief import GaussianBelief
from reak_tpu_torch.ctrl.invariant import Retraction, iekf_predict
from reak_tpu_torch.math.linalg import _cholesky


class PredictedBeliefTrajectory(NamedTuple):
    times: torch.Tensor     # (H+1,)
    means: torch.Tensor     # (H+1, n)
    covs: torch.Tensor      # (H+1, n, n)

    def at_time(self, t):
        """Belief at query time (zero-order hold on cov, linear mean —
        the reference's waypoint bisection and interpolation,
        belief_state_predictor.hpp get_point_at_time)."""
        t = torch.as_tensor(t, dtype=self.times.dtype,
                            device=self.times.device)
        i = torch.clamp(torch.searchsorted(self.times, t, right=True) - 1,
                        0, self.times.shape[0] - 2)
        t0, t1 = self.times[i], self.times[i + 1]
        s = torch.where(t1 > t0, (t - t0) / (t1 - t0), torch.zeros_like(t))
        s = torch.clamp(s, 0.0, 1.0)[..., None]
        mean = (1 - s) * self.means[i] + s * self.means[i + 1]
        return GaussianBelief(mean, self.covs[i])

    def ml_trajectory(self):
        """Maximum-likelihood state trajectory (ref:
        maximum_likelihood_mapping.hpp)."""
        return self.times, self.means


def predict_belief_trajectory(F: Callable, ret: Retraction,
                              b0: GaussianBelief, us, Q, dt: float,
                              t0: float = 0.0) -> PredictedBeliefTrajectory:
    """Open-loop belief rollout: H invariant-EKF predict steps (ref:
    belief_state_predictor.hpp:79; the predict step of kalman_filter.hpp:88
    with no updates)."""
    b, t = b0, t0
    means, covs = [b0.mean], [b0.cov]
    for u in us:
        b = iekf_predict(F, ret, b, u, Q, t)
        t = t + dt
        means.append(b.mean)
        covs.append(b.cov)
    H = us.shape[0]
    times = t0 + dt * torch.arange(H + 1, dtype=b0.mean.dtype,
                                   device=b0.mean.device)
    return PredictedBeliefTrajectory(times, torch.stack(means),
                                     torch.stack(covs))


def _scenarios_from_draws(traj: PredictedBeliefTrajectory, eps,
                          ret: Optional[Retraction]):
    """Standard-normal draws eps (n, H+1, dim) → n state trajectories: each
    step's draw through the Cholesky factor of its covariance (+1e-12 I),
    then ``ret.retract(mean, ·)`` (``mean + ·`` without a retraction).  The
    H+1 covariances are factored once for all n scenarios."""
    dim = eps.shape[-1]
    L = _cholesky(traj.covs + 1e-12 * torch.eye(
        dim, dtype=traj.covs.dtype, device=traj.covs.device))
    d = torch.einsum("hij,nhj->nhi", L, eps)
    if ret is None:
        return traj.means + d
    return ret.retract(traj.means, d)


def sample_scenarios(generator: torch.Generator,
                     traj: PredictedBeliefTrajectory, n: int,
                     ret: Optional[Retraction] = None):
    """Draw n state-trajectory scenarios (n, H+1, n_state) from a predicted
    belief trajectory (feeds the scenario-MPC batch; ref:
    gaussian_belief_state.hpp:491 sample_gaussian_point).

    Tangent-space sampling when a retraction is given (quaternion states
    stay on the manifold).  The draws come from ``generator``, which must be
    on the trajectory's device; the JAX package's per-scenario ``fold_in``
    stream is not reproduced."""
    Hp1, nstate = traj.means.shape
    dim = ret.dim if ret is not None else nstate
    eps = torch.randn((n, Hp1, dim), generator=generator,
                      dtype=traj.means.dtype, device=traj.means.device)
    return _scenarios_from_draws(traj, eps, ret)
