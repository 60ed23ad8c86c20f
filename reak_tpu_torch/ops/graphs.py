"""CUDA graphs for the port's launch-bound routes.

The JAX package compiles a whole solve into one XLA program; the port runs
its plain torch glue eagerly, one launch per op, from Python.  Where that
glue is a short function called many times with the same shapes (one RK4
step of the SQP line search's pricing rollout, the free-base step and its
linearization), ``graphed`` captures it once into a CUDA graph and replays
it: the launches of its kernels (K3a, K3b) and of its torch ops go to the
card in one call, with no Python between them.

``graphed(fn)`` returns a function of the same tensors.  On CPU tensors it
calls ``fn``.  On CUDA tensors, at the first call for each (input shapes,
types, device) it runs ``fn`` once eagerly on a side stream (the warm-up
that capture needs, whose result the call returns), then captures ``fn``
into a graph on static copies of the inputs; every later call copies its
inputs into them, replays the graph and returns clones of its outputs, so
a replay never overwrites what an earlier call returned.  A capture that
fails raises: there is no eager path on a CUDA tensor, and ``.eager`` is
the uncaptured function for callers that want it.

A replay never enters the kernels' Python wrappers, so their launch
counters (each wrapper registers its own in ``_build.launch_counters``)
would not move: the capture records how far each counter moved (and takes
that back, since a capture launches nothing) and every replay adds it
again.  ``fn`` must make no tensor from host memory and must not
synchronise with the host once it has run once: such a call is refused
while a stream captures.
"""
from __future__ import annotations

import time

import torch

from reak_tpu_torch.ops import _build


def _counts() -> dict:
    """{(module, entry or None): launches} of every registered kernel
    wrapper (``_build.launch_counters``)."""
    out = {}
    for mod in list(_build.launch_counters.values()):
        if isinstance(mod.launches, dict):
            out.update({(mod, e): v for e, v in mod.launches.items()})
        else:
            out[(mod, None)] = mod.launches
    return out


def _add_counts(delta: dict, sign: int = 1) -> None:
    for (mod, entry), v in delta.items():
        if entry is None:
            mod.launches += sign * v
        else:
            mod.launches[entry] += sign * v


def _clone(out):
    if torch.is_tensor(out):
        return out.clone()
    return tuple(o.clone() for o in out)


class _Captured:
    """``fn`` captured at one (shapes, types, device) of its inputs."""

    def __init__(self, fn, args):
        device = args[0].device
        self.inputs = [torch.empty_like(a, memory_format=torch.contiguous_format)
                       .copy_(a) for a in args]
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self.first = fn(*self.inputs)
        main.wait_stream(side)
        for o in (self.first,) if torch.is_tensor(self.first) else self.first:
            o.record_stream(main)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)
        after = _counts()
        # host seconds of the eager warm-up, and of the capture with the
        # graph's instantiation (torch instantiates when a capture ends)
        self.seconds = {"warmup": t1 - t0,
                        "capture": time.perf_counter() - t1}
        self.launches = {key: after[key] - before.get(key, 0)
                         for key in after if after[key] != before.get(key, 0)}
        _add_counts(self.launches, -1)  # the capture launched nothing

    def replay(self, args):
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        _add_counts(self.launches)
        return _clone(self.outputs)


def graphed(fn):
    """``fn(*tensors) → tensor | tuple of tensors``, replayed from a CUDA
    graph on CUDA tensors (one capture per input shapes, types and device)
    and called as it is on CPU tensors."""
    captured = {}

    def call(*args):
        if not args[0].is_cuda:
            return fn(*args)
        key = tuple((tuple(a.shape), a.dtype, a.device) for a in args)
        graph = captured.get(key)
        if graph is None:
            graph = captured[key] = _Captured(fn, args)
            first, graph.first = graph.first, None
            return first
        return graph.replay(args)

    call.eager = fn
    call.captured = captured
    return call
