"""Mesh construction and scenario-batch sharding helpers (port of
``reak_tpu/parallel/mesh.py``).

Replaces nothing in the reference (its only distribution is TCP/UDP row
streaming, core/recorders/network_recorder.cpp).  The JAX package shards
with ``shard_map`` over a ``Mesh`` of devices; torch runs one process per
GPU, so here each process is one rank of a ``torch.distributed`` group
(``distribute_init``), the mesh is a one-dimensional ``DeviceMesh`` over the
ranks, a batch is a ``DTensor`` sharded on its leading axis (the JAX
package's ``P(axis_name)``), and a per-shard function runs on each rank's
local shard.  Collectives inside it take the mesh's group
(``mesh.get_group()``).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.utils._pytree import tree_map


def make_mesh(n_devices: int | None = None, axis_name: str = "scenarios",
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the scenario-batch axis: the first ``n_devices`` ranks
    of the process group (all of them by default), one GPU each.  Call
    ``distribute_init`` first, in every process."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "distribute_init in every process first")
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return DeviceMesh(device_type, list(range(n)),
                      mesh_dim_names=(axis_name,))


def _check_divides(x, mesh):
    """Raise ``ValueError`` unless the leading axis of every tensor of the
    pytree ``x`` divides by the mesh's size (the JAX package's
    ``device_put`` and ``shard_map`` refuse such a batch)."""

    def check(a):
        if isinstance(a, torch.Tensor) and (a.ndim == 0
                                            or a.shape[0] % mesh.size()):
            raise ValueError(
                f"a batch of shape {tuple(a.shape)}: its leading axis is "
                f"not evenly divisible by the mesh's {mesh.size()} ranks")
        return a

    tree_map(check, x)


def shard_batch(x, mesh: DeviceMesh, axis_name: str = "scenarios"):
    """Place a batch pytree with the leading axis sharded over the mesh:
    each tensor becomes a ``DTensor`` of placement ``Shard(0)``.  Every rank
    passes the same global batch; a leading axis that does not divide by
    the mesh's size raises ``ValueError``.  ``axis_name`` names the mesh's
    one axis, as in the JAX package."""
    _check_divides(x, mesh)
    return tree_map(lambda a: distribute_tensor(a, mesh, [Shard(0)]), x)


def _local(x, mesh):
    """A rank's shard of a batch tensor: a DTensor's local tensor, a plain
    tensor sharded as ``shard_batch`` shards it first."""
    if isinstance(x, DTensor):
        return x.to_local()
    if isinstance(x, torch.Tensor):
        return distribute_tensor(x, mesh, [Shard(0)]).to_local()
    return x


def _map_local(fn, mesh, args):
    _check_divides(args, mesh)
    return fn(*tree_map(lambda a: _local(a, mesh), args))


def _sharded(out, mesh):
    return tree_map(lambda a: DTensor.from_local(a, mesh, [Shard(0)])
                    if isinstance(a, torch.Tensor) else a, out)


def sharded_map(fn: Callable, mesh: DeviceMesh,
                axis_name: str = "scenarios"):
    """Run a per-shard batch function on each rank's shard of the scenario
    axis.

    ``fn`` receives the *local* shard of each input (leading axis divided by
    the mesh's size; an axis that does not divide raises ``ValueError``)
    and must be batched internally; its tensors come back as ``Shard(0)``
    DTensors.  Collectives over the mesh
    (``dist.all_reduce(..., group=mesh.get_group())``) are available
    inside.
    """
    return lambda *args: _sharded(_map_local(fn, mesh, args), mesh)


def pmean_scalar(fn: Callable, mesh: DeviceMesh,
                 axis_name: str = "scenarios"):
    """Like ``sharded_map`` for a function returning (per-shard batch,
    scalar summary); the scalar is averaged across the mesh (an
    ``all_reduce`` sum over its group, divided by its size) and comes back
    as a replicated DTensor."""

    def wrapped(*args):
        out, s = _map_local(fn, mesh, args)
        s = s.clone()
        dist.all_reduce(s, group=mesh.get_group())
        s = s / mesh.size()
        return (_sharded(out, mesh),
                DTensor.from_local(s, mesh, [Replicate()]))

    return wrapped


def distribute_init(coordinator: str | None = None,
                    num_processes: int | None = None,
                    process_id: int | None = None, backend: str = "nccl"):
    """Multi-process bring-up: ``init_process_group`` at
    ``tcp://<coordinator>`` (``host:port``) with ``num_processes`` ranks,
    this process being ``process_id``; no-op, returning False, when
    ``coordinator`` is None.  With NCCL, rank r takes GPU r modulo the
    host's count (one process per GPU)."""
    if coordinator is None:
        return False
    rank = -1 if process_id is None else int(process_id)
    if backend == "nccl" and rank >= 0:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=-1 if num_processes is None else int(num_processes),
        rank=rank)
    return True
