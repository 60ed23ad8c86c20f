"""The port imports without JAX and without CUDA or nvcc, changes no global
torch state at import, and launches no kernel on CPU tensors."""
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_import_leaves_jax_out():
    code = (
        "import sys, torch\n"
        "tf32 = (torch.backends.cuda.matmul.allow_tf32,"
        " torch.backends.cudnn.allow_tf32)\n"
        "import reak_tpu_torch, reak_tpu_torch.ops.kte_step,"
        " reak_tpu_torch.ops.pdip_whole, reak_tpu_torch.ops.chol_lanes,"
        " reak_tpu_torch.math.rot_lanes, reak_tpu_torch.ctrl.mpc,"
        " reak_tpu_torch.ctrl.manifold_lanes, reak_tpu_torch.ctrl.ss_systems,"
        " reak_tpu_torch.convert\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'reak_tpu' or m.startswith('reak_tpu.')"
        " for m in sys.modules), 'reak_tpu was imported'\n"
        "assert tf32 == (torch.backends.cuda.matmul.allow_tf32,"
        " torch.backends.cudnn.allow_tf32), 'import changed torch state'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_enable_full_precision_turns_tf32_off(monkeypatch):
    import reak_tpu_torch

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    reak_tpu_torch.enable_full_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_solve_launches_no_kernel():
    from reak_tpu_torch.ctrl import mpc
    from reak_tpu_torch.kte import models
    from reak_tpu_torch.ops import chol_lanes, kte_step, pdip_whole

    kte_step.launches = 0
    pdip_whole.launches = 0
    chol_lanes.launches.update(solve_lanes=0, solve_lanes_multi=0)
    f64 = dict(dtype=torch.float64)
    prob = mpc.MPCProblem(Q=torch.eye(12, **f64), R=torch.eye(6, **f64) * 0.1,
                          QN=torch.eye(12, **f64) * 5.0,
                          u_min=torch.full((6,), -5.0, **f64),
                          u_max=torch.full((6,), 5.0, **f64), horizon=2)
    us, xs = mpc.make_kte_mpc(models.manip_3r3r(), prob, 0.01, qp_iters=2)(
        torch.full((2, 12), 0.1, **f64), torch.zeros(2, 2, 6, **f64))
    assert bool(torch.isfinite(us).all()) and bool(torch.isfinite(xs).all())
    # two passes: the line search's RK4 pricing solves through chol_lanes
    us2, _ = mpc.make_kte_mpc(models.manip_3r3r(), prob, 0.01, qp_iters=2,
                              sqp_iters=2)(
        torch.full((2, 12), 0.1, **f64), torch.zeros(2, 2, 6, **f64))
    assert bool(torch.isfinite(us2).all())
    assert kte_step.launches == 0
    assert pdip_whole.launches == 0
    assert chol_lanes.launches == {"solve_lanes": 0, "solve_lanes_multi": 0}
