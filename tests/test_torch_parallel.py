"""The port's scenario-batch sharding (``reak_tpu_torch.parallel``) on the
CPU: two processes with the gloo backend run ``distribute_init``, an
``all_reduce`` over the mesh's group inside ``sharded_map`` (the psum of
tests/test_distributed.py), and ``sharded_map`` with ``pmean_scalar``
around the flagship solve (``ctrl.mpc.make_kte_mpc`` on ``manip_3r3r``,
f32, 8 Mehrotra iterations, one SQP pass, ±40; H = 10, the x0 of
tests/test_mesh_equivalence.py:57-73) — the JAX package's ``local_step`` of
tests/test_mesh_equivalence.py:36-56.  The gathered controls must be bit
for bit those of the same solve in one process, and the scalar the mean of
their squares.  Each worker has a wall-clock timeout, as in
tests/test_distributed.py.

64 scenarios, 32 a rank: torch's CPU kernels run the last lanes of a row
that does not fill their widest vector step (32 float32 lanes) through
their scalar loop, whose ``sin``/``cos`` can differ from the vector ones in
the last bit, so in one process the solve of 4 scenarios alone already
differs from the same 4 solved among 8 (by 1.2e-7); from 32 lanes a shard
is solved as the whole batch solves it."""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
H, BATCH = 10, 64

_FLAGSHIP = textwrap.dedent("""
    import numpy as np
    import torch
    from reak_tpu_torch.ctrl import mpc
    from reak_tpu_torch.kte import models

    def flagship(H):
        f32 = dict(dtype=torch.float32)
        w = np.concatenate([np.full(6, 10.0), np.full(6, 1.0)])
        prob = mpc.MPCProblem(
            Q=torch.as_tensor(np.diag(w), **f32),
            R=torch.eye(6, **f32) * 0.05,
            QN=torch.as_tensor(np.diag(5.0 * w), **f32),
            u_min=torch.full((6,), -40.0, **f32),
            u_max=torch.full((6,), 40.0, **f32), horizon=H)
        return mpc.make_kte_mpc(models.manip_3r3r(), prob, 0.01, qp_iters=8,
                                sqp_iters=1)

    def inputs(H, batch):
        x0 = torch.zeros(batch, 12, dtype=torch.float32)
        x0[:, 0] += torch.linspace(0.1, 0.4, batch, dtype=torch.float32)
        return x0, torch.zeros(batch, H, 6, dtype=torch.float32)
""")

_WORKER = _FLAGSHIP + textwrap.dedent("""
    import os, sys
    import torch.distributed as dist
    from reak_tpu_torch.parallel import (distribute_init, make_mesh,
                                         pmean_scalar, shard_batch,
                                         sharded_map)

    torch.set_num_threads(1)
    pid, H, batch = int(os.environ["PROC_ID"]), int(os.environ["H"]), \\
        int(os.environ["BATCH"])
    assert distribute_init(os.environ["COORD"], 2, pid, backend="gloo")
    mesh = make_mesh(device_type="cpu")
    assert dist.get_world_size() == 2 and mesh.size() == 2

    def local_sum(x):
        s = x.sum()
        dist.all_reduce(s, group=mesh.get_group())
        return s.expand(x.shape[0]).clone()

    total = sharded_map(local_sum, mesh)(
        shard_batch(torch.arange(8.0, dtype=torch.float64), mesh))
    assert float(total.to_local()[0]) == 28.0, total
    print(f"proc{pid} psum ok: 28.0", flush=True)

    solver = flagship(H)

    def local_step(x0s, u0s):
        us, xs = solver(x0s, u0s)
        return us, torch.mean(us ** 2)

    x0, u0 = inputs(H, batch)
    us, mean_cost = pmean_scalar(local_step, mesh)(
        shard_batch(x0, mesh), shard_batch(u0, mesh))
    assert us.to_local().shape == (batch // 2, H, 6)
    np.savez(os.environ["OUT"], us=us.full_tensor().numpy(),
             mean_cost=mean_cost.to_local().numpy())
    dist.destroy_process_group()
""")


_UNEVEN = textwrap.dedent("""
    import os
    import torch
    import torch.distributed as dist
    from reak_tpu_torch.parallel import (distribute_init, make_mesh,
                                         pmean_scalar, shard_batch,
                                         sharded_map)

    pid = int(os.environ["PROC_ID"])
    assert distribute_init(os.environ["COORD"], 2, pid, backend="gloo")
    mesh = make_mesh(device_type="cpu")
    x = torch.arange(3.0, dtype=torch.float64)
    calls = {"shard_batch": lambda: shard_batch(x, mesh),
             "sharded_map": lambda: sharded_map(lambda a: a, mesh)(x),
             "pmean_scalar": lambda: pmean_scalar(
                 lambda a: (a, a.sum()), mesh)(x)}
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            assert "not evenly divisible" in str(e), e
            print(f"proc{pid} {name} ValueError", flush=True)
    even = sharded_map(lambda a: 2.0 * a, mesh)(
        shard_batch(torch.arange(4.0, dtype=torch.float64), mesh))
    assert even.full_tensor().tolist() == [0.0, 2.0, 4.0, 6.0]
    print(f"proc{pid} even ok", flush=True)
    dist.destroy_process_group()
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_distribute_init_without_coordinator_is_false():
    from reak_tpu_torch.parallel import distribute_init, make_mesh

    assert distribute_init(None) is False
    assert distribute_init(None, 2, 0, backend="gloo") is False
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="distribute_init"):
            make_mesh(device_type="cpu")


def test_two_process_gloo_mesh_flagship(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    procs, outs = [], []
    for pid in range(2):
        env = dict(os.environ, COORD=coord, PROC_ID=str(pid), H=str(H),
                   BATCH=str(BATCH), OUT=str(tmp_path / f"out{pid}.npz"),
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    # the same solve in this process, while the workers run
    namespace = {}
    exec(_FLAGSHIP, namespace)
    us_one, _ = namespace["flagship"](H)(*namespace["inputs"](H, BATCH))
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            pytest.fail(f"mesh worker hung; partial output:\n{out}")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out}"
        assert f"proc{pid} psum ok: 28.0" in out, out
    want = us_one.numpy()
    assert np.all(np.isfinite(want))
    for pid in range(2):
        got = np.load(tmp_path / f"out{pid}.npz")
        assert np.array_equal(got["us"], want), np.abs(got["us"] - want).max()
        half = BATCH // 2
        shards = torch.stack([torch.mean(us_one[:half] ** 2),
                              torch.mean(us_one[half:] ** 2)])
        assert got["mean_cost"] == ((shards[0] + shards[1]) / 2).numpy()
        np.testing.assert_allclose(got["mean_cost"],
                                   torch.mean(us_one ** 2).numpy(), rtol=1e-6)


def test_two_process_gloo_mesh_refuses_an_uneven_batch(tmp_path):
    """F23: at B = 3 on two ranks ``shard_batch``, ``sharded_map`` and
    ``pmean_scalar`` raise ``ValueError``, as the JAX package's
    ``device_put`` and ``shard_map`` do; a batch of 4 still shards."""
    script = tmp_path / "uneven.py"
    script.write_text(_UNEVEN)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(script)], cwd=REPO,
        env=dict(os.environ, COORD=coord, PROC_ID=str(pid), PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            pytest.fail(f"mesh worker hung:\n{p.communicate()[0]}")
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out}"
        for name in ("shard_batch", "sharded_map", "pmean_scalar"):
            assert f"proc{pid} {name} ValueError" in out, out
        assert f"proc{pid} even ok" in out, out
