"""Scenario-batch sharding over ``torch.distributed`` (port of
``reak_tpu.parallel``).

The reference has no parallelism framework — throughput comes from serial
Monte-Carlo loops.  Here the scaling axis is the *scenario batch* (MPC
scenarios, EKF Monte-Carlo runs, planner edge propagations), sharded over a
one-dimensional ``DeviceMesh`` with one process per GPU; summary reductions
are ``all_reduce`` over the mesh's group (NCCL on the cards, gloo on the
CPU).  Sequence/pipeline/expert parallelism have no workload in this
domain.
"""
from reak_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_batch,
    sharded_map,
    pmean_scalar,
    distribute_init,
)

__all__ = ["make_mesh", "shard_batch", "sharded_map", "pmean_scalar",
           "distribute_init"]
