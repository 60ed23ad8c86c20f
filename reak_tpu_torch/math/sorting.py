"""Sorting and selection, batched over leading axes (port of
``reak_tpu/math/sorting.py``; ref: core/sorting/*.hpp, consumed by DVP-tree
partitioning and the reachability sort, path_planning/reachability_sort.hpp).

Two tiers, as in the JAX package:

* the operation surface (sort, argsort, rank, top-k, median partition,
  two-key lexicographic sort) on ``torch.sort``;
* the bitonic sorting network (``bitonic_sort``, ``bitonic_argsort``,
  ``bitonic_sort_kv``): a fixed compare-exchange schedule of log²n
  elementwise waves over static permutations, plain torch as it is plain JAX
  (no Pallas) in the reference.  The schedule's index tensors are made once
  per (length, device).

Planned differences from torch's defaults, each to give JAX's results:
every argsort is stable (``jnp.argsort`` is; ``rank`` and ``lexsort_2key``
rely on it); ``median_partition`` averages the two middle values of an even
length (``torch.median`` returns the lower one) and gives NaN for a slice
that holds one; ``top_k`` and ``smallest_k`` break ties toward the lower
index, as ``lax.top_k`` does, through a stable sort (``torch.topk`` on
CUDA promises no order among equal keys).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def sort(x, axis=-1):
    return torch.sort(x, dim=axis).values


def argsort(x, axis=-1):
    return torch.argsort(x, dim=axis, stable=True)


def rank(x, axis=-1):
    """Rank of each element in its slice (0 = smallest)."""
    return argsort(argsort(x, axis), axis)


def top_k(x, k):
    """Largest k along the last axis: (values, indices), in descending
    order, equal keys by their index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def smallest_k(x, k):
    """Smallest k along the last axis: (values, indices) — the k-NN selection
    primitive (ref: dvp_tree_detail.hpp nearest-neighbor queue)."""
    v, i = top_k(-x, k)
    return -v, i


def median_partition(x):
    """(median, below-mask) for the last axis — the vantage-point split of
    the DVP tree (ref: dvp_tree_detail.hpp partitioning).  The median of an
    even length is the mean of the two middle values."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    med = (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5
    med = torch.where(torch.isnan(x).any(dim=-1),
                      torch.full_like(med, float("nan")), med)
    return med, x <= med[..., None]


def lexsort_2key(primary, secondary):
    """Indices sorting by ``primary`` then ``secondary`` (the reachability
    dual-key ordering, ref: path_planning/reachability_sort.hpp)."""
    # stable composite: sort by secondary first, then stable-sort by primary
    order2 = torch.argsort(secondary, dim=-1, stable=True)
    p2 = torch.take_along_dim(primary, order2, dim=-1)
    order1 = torch.argsort(p2, dim=-1, stable=True)
    return torch.take_along_dim(order2, order1, dim=-1)


# ---------------------------------------------------------------------------
# bitonic sorting network (ref: core/sorting/*.hpp — the comparison sorts;
# re-designed as a data-independent compare-exchange schedule)
# ---------------------------------------------------------------------------


def _bitonic_schedule_np(n):
    """(partner, want_min) pairs of Batcher's bitonic network on n (a power
    of two) slots, in numpy."""
    idx = np.arange(n)
    stages = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            partner = idx ^ j
            ascending = (idx & k) == 0
            # a position keeps the smaller value iff it is the lower index of
            # its pair in an ascending block, or the upper index in a
            # descending block
            want_min = (idx < partner) == ascending
            stages.append((partner, want_min))
            j //= 2
        k *= 2
    return stages


@functools.lru_cache(maxsize=None)
def _bitonic_schedule(n, device):
    """The schedule of ``_bitonic_schedule_np`` as index and mask tensors on
    ``device``, made once per (n, device): one copy from the host per
    wave would otherwise come with every call."""
    return tuple((torch.as_tensor(p, device=device),
                  torch.as_tensor(w, device=device))
                 for p, w in _bitonic_schedule_np(n))


def _pow2_above(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _pad_inf(x, m):
    n = x.shape[-1]
    if m == n:
        return x
    pad = torch.full(x.shape[:-1] + (m - n,), float("inf"), dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=-1)


def _bitonic_kv_core(keys, payload):
    """Sort the last axis ascending by ``keys``, carrying ``payload`` through
    the same compare-exchanges.  Ties break on the payload (assumed a
    permutation), so the result is always a valid permutation."""
    for partner, want_min in _bitonic_schedule(keys.shape[-1], keys.device):
        kp = keys[..., partner]
        pp = payload[..., partner]
        less = (keys < kp) | ((keys == kp) & (payload < pp))
        take_self = want_min == less
        keys = torch.where(take_self, keys, kp)
        payload = torch.where(take_self, payload, pp)
    return keys, payload


def _iota(m, like):
    return torch.arange(m, device=like.device).expand(like.shape[:-1] + (m,))


def bitonic_sort(x, axis=-1):
    """Ascending sort along ``axis`` via the bitonic network: ~log²n
    elementwise min/max waves over static permutations.  Handles any length
    (pads to the next power of two with +inf)."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    m = _pow2_above(n)
    x = _pad_inf(x, m)
    for partner, want_min in _bitonic_schedule(m, x.device):
        xp = x[..., partner]
        x = torch.where(want_min, torch.minimum(x, xp), torch.maximum(x, xp))
    return torch.movedim(x[..., :n], -1, axis)


def bitonic_sort_kv(keys, values, axis=-1):
    """(sorted_keys, permuted_values) along ``axis``, ascending by keys —
    the key-value compare-exchange form a kernel carries side arrays with.
    Pads to a power of two with +inf keys."""
    keys = torch.movedim(keys, axis, -1)
    values = torch.movedim(values, axis, -1)
    n = keys.shape[-1]
    m = _pow2_above(n)
    keys = _pad_inf(keys, m)
    sk, perm = _bitonic_kv_core(keys, _iota(m, keys))
    if m != n:
        values = torch.cat([values, torch.zeros(
            values.shape[:-1] + (m - n,), dtype=values.dtype,
            device=values.device)], dim=-1)
    sv = torch.take_along_dim(values, perm, dim=-1)
    return (torch.movedim(sk[..., :n], -1, axis),
            torch.movedim(sv[..., :n], -1, axis))


def bitonic_argsort(x, axis=-1):
    """Ascending argsort along ``axis`` through the network (stable under
    the index tie-break: equal keys keep original order)."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    m = _pow2_above(n)
    x = _pad_inf(x, m)
    _, perm = _bitonic_kv_core(x, _iota(m, x))
    return torch.movedim(perm[..., :n], -1, axis)
