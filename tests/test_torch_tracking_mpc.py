"""The closed-loop tracking test of ``tests/test_tracking_mpc.py:123-156``
on the port, at its own bars, on the CPU: ``ctrl.mpc.make_kte_mpc``
(``rollout="lanes"``) re-solved at every step against the RK4 plant
``ctrl.systems.kte_discrete``.  A solve and a plant step take about 1 s
on one CPU thread, so the 60 steps take about a minute: the test has a
file of its own, which the test runner's workers schedule apart."""
import torch

from reak_tpu_torch.ctrl import mpc, systems
from reak_tpu_torch.kte import models

torch.set_num_threads(1)


def test_receding_horizon_tracking_absorbs_model_drift():
    """tests/test_tracking_mpc.py:123-156 on the port, at its bars: the
    2-link arm closed loop — re-solve each step with
    ``make_kte_mpc(rollout="lanes")``, apply u[0] to the RK4 plant
    ``systems.kte_discrete`` — lands on the target (error < 0.05) with its
    rates settled (< 0.1) after 60 steps."""
    spec = models.planar_2link()
    H, m, dt = 20, 2, 0.05
    f64 = torch.float64
    prob = mpc.MPCProblem(
        Q=torch.diag(torch.tensor([10.0, 10.0, 1.0, 1.0], dtype=f64)),
        R=torch.eye(m, dtype=f64) * 1e-3,
        QN=torch.diag(torch.tensor([50.0, 50.0, 5.0, 5.0], dtype=f64)),
        u_min=torch.full((m,), -30.0, dtype=f64),
        u_max=torch.full((m,), 30.0, dtype=f64), horizon=H)
    x_ref = torch.tensor([0.4, -0.3, 0.0, 0.0], dtype=f64)
    solver = mpc.make_kte_mpc(spec, prob, dt, qp_iters=8, sqp_iters=1,
                              rollout="lanes")
    F_true = systems.kte_discrete(spec, dt)  # the plant (RK4)
    x = torch.zeros(4, dtype=f64)
    u0 = torch.zeros((1, H, m), dtype=f64)
    for _ in range(60):
        us, _ = solver(x[None], u0, x_ref=x_ref)
        x = F_true(x, us[0, 0])
    err = (x[0:2] - x_ref[0:2]).abs()
    assert float(err.max()) < 0.05, err
    assert float(x[2:4].abs().max()) < 0.1
