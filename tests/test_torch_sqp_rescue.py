"""The SQP line search of the port's make_kte_mpc (reak_tpu_torch.ctrl.mpc)
rescues a multi-pass solve that diverges without it: the port's run of
tests/test_tracking_mpc.py::test_sqp_linesearch_rescues_divergent_multipass
on its own 2-link arm, f64 on the CPU, at H=15 (the JAX test takes H=30;
full-step SQP diverges from H=15 on, and the priced RK4 rollouts of three
passes cost half as much).  Its own file, since those rollouts take most of
a minute of plain torch here."""
import torch

from reak_tpu_torch.ctrl import mpc
from reak_tpu_torch.kte import models

torch.set_num_threads(1)


def test_sqp_linesearch_rescues_divergent_multipass():
    """tests/test_tracking_mpc.py::test_sqp_linesearch_rescues_divergent_
    multipass on the port: full-step SQP at dt=0.05 on the 2-link goes NaN;
    with the line search the solve is finite and its true RK4 cost is no
    worse than the single pass's."""
    spec = models.planar_2link()
    Hh, m = 15, 2
    f64 = dict(dtype=torch.float64)
    prob = mpc.MPCProblem(
        Q=torch.diag(torch.tensor([10.0, 10.0, 1.0, 1.0], **f64)),
        R=torch.eye(m, **f64) * 0.05,
        QN=torch.diag(torch.tensor([50.0, 50.0, 5.0, 5.0], **f64)),
        u_min=torch.full((m,), -30.0, **f64),
        u_max=torch.full((m,), 30.0, **f64), horizon=Hh)
    x0s = torch.zeros(2, 4, **f64)
    x0s[:, 0] = torch.tensor([-0.2, 0.1], **f64)
    us0 = torch.zeros(2, Hh, m, **f64)
    x_ref = torch.tensor([0.5, -0.4, 0.0, 0.0], **f64)

    def run(sqp_iters, linesearch):
        return mpc.make_kte_mpc(spec, prob, 0.05, qp_iters=10,
                                sqp_iters=sqp_iters, rollout="lanes",
                                sqp_linesearch=linesearch)(
            x0s, us0, x_ref=x_ref)[0]

    assert not bool(torch.isfinite(run(3, False)).all())
    us_g = run(3, True)
    assert bool(torch.isfinite(us_g).all())
    cost, _ = mpc.make_traj_cost(spec, prob, 0.05)
    xr_l = mpc.to_lanes(x_ref, 4, Hh, torch.float64, "cpu")
    true_cost = lambda us: cost(x0s, us.permute(1, 2, 0), xr_l)
    assert bool((true_cost(us_g) <= true_cost(run(1, True)) + 1e-6).all())
