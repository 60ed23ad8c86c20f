"""The CUDA-graph helper of the port (reak_tpu_torch.ops.graphs) and the two
routes it serves, on CPU tensors: there the helper calls the function as it
is, and the functions it captures on the card must make no tensor from host
memory once they have run once (a stream that captures refuses such a
copy).  The routes are the RK4 pricing rollout of the SQP line search
(``kte/lanes.make_rollout_lanes``) and the free-base step and linearization
(``kte/lanes.make_kte_manifold_lanes``); their values against the JAX
package are held in tests/test_torch_sqp.py and tests/test_torch_kte_free.py.
"""
import numpy as np
import pytest
import torch

from reak_tpu_torch.kte import lanes, models
from reak_tpu_torch.ops import chol_lanes, graphs, kte_step

torch.set_num_threads(1)


def test_graphed_calls_the_function_on_cpu_tensors(rng):
    calls = []

    def fn(x, u):
        calls.append(1)
        return x * 2.0 + u, x - u

    g = graphs.graphed(fn)
    x = torch.as_tensor(rng.standard_normal((3, 5)))
    u = torch.as_tensor(rng.standard_normal((3, 5)))
    for _ in range(2):
        got = g(x, u)
        want = fn(x, u)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(calls) == 4 and g.captured == {} and g.eager is fn


def test_replays_credit_the_launch_counters():
    """A replay adds to each wrapper's counter what its capture recorded,
    per entry (dict counters) and per module (int counters); a capture
    takes back what it counted."""
    before = graphs._counts()
    delta = {(chol_lanes, "solve_lanes"): 4, (kte_step, None): 2}
    graphs._add_counts(delta)
    after = graphs._counts()
    assert after[(chol_lanes, "solve_lanes")] == \
        before[(chol_lanes, "solve_lanes")] + 4
    assert after[(kte_step, None)] == before[(kte_step, None)] + 2
    graphs._add_counts(delta, -1)
    assert graphs._counts() == before


def test_every_kernel_wrapper_registers_its_counter():
    """Every module of ``ops/`` that counts launches is in the registry
    that the graph helper credits, so no replay goes uncounted."""
    import importlib
    import pkgutil

    import reak_tpu_torch.ops as ops
    from reak_tpu_torch.ops import _build

    counting = set()
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"reak_tpu_torch.ops.{info.name}")
        if hasattr(mod, "launches"):
            counting.add(mod.__name__)
    assert len(counting) == 5
    assert counting == set(_build.launch_counters)
    assert all(_build.launch_counters[m] is importlib.import_module(m)
               for m in counting)


class _HostTensors:
    """Counts the calls that make a tensor from host data."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("as_tensor", "tensor", "from_numpy"):
            real = getattr(torch, name)
            monkeypatch.setattr(torch, name, self._counting(real))

    def _counting(self, real):
        def call(*args, **kwargs):
            self.n += 1
            return real(*args, **kwargs)
        return call


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_line_search_rollout_makes_no_host_tensor_after_first_call(
        rng, monkeypatch, dtype):
    spec = models.manip_3r3r()
    roll = lanes.make_rollout_lanes(spec, 0.01)
    x0 = torch.as_tensor(rng.uniform(-0.5, 0.5, (3, 12)), dtype=dtype)
    us = torch.as_tensor(rng.uniform(-5, 5, (1, 6, 3)), dtype=dtype)
    first = roll(x0, us)
    host = _HostTensors(monkeypatch)
    again = roll(x0, us)
    assert host.n == 0
    assert torch.equal(first, again) and torch.equal(roll.eager(x0, us), first)


def test_free_base_step_and_ltv_make_no_host_tensor_after_first_call(
        rng, monkeypatch):
    spec = models.floating_arm()
    act = np.eye(spec.nv)[:, :8]  # an actuation map: its constant too
    step, ltv = lanes.make_kte_manifold_lanes(spec, 0.02, actuated=act)
    x = np.zeros((spec.nq + spec.nv, 3))
    x[3] = 1.0
    x[7:spec.nq] = rng.uniform(-0.3, 0.3, (spec.nq - 7, 3))
    x[spec.nq:] = rng.uniform(-0.1, 0.1, (spec.nv, 3))
    x, u = torch.as_tensor(x), torch.as_tensor(rng.uniform(-2, 2, (8, 3)))
    first = (step(x, u), ltv(x, u))
    host = _HostTensors(monkeypatch)
    again = (step(x, u), ltv(x, u))
    assert host.n == 0
    assert torch.equal(first[0], again[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1], again[1]))
    assert step.eager is not step and ltv.eager is not ltv
