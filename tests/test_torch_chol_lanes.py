"""The port's batched Cholesky solves (reak_tpu_torch.ops.chol_lanes, whose
CPU path is the plain recurrence ``ctrl/riccati_soa._chol_solve_lanes``)
against the JAX package's Pallas kernels K3a/K3b run in interpret mode and
its standard-layout ``chol_lanes.solve``, on the same numpy inputs at f64.
At the floating arm's shape (n=12, k=36) the interpreter takes minutes, so
there the reference is the JAX package's own unrolled recurrence
(``ctrl/riccati_soa._chol_solve_lanes`` off the TPU), the code the kernel
mirrors operation for operation.  Bar: ≤1e-12 relative to the largest entry
of the reference."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.ops import chol_lanes as jchol
from reak_tpu_torch.ops import _build, chol_lanes

torch.set_num_threads(1)

B = 1024  # one TPU tile of scenarios


def _spd(rng, n, batch=B):
    """G Gᵀ + 3I per scenario, as bench.py:193-195 makes it."""
    g = rng.standard_normal((n, n, batch))
    return np.einsum("ikz,jkz->ijz", g, g) + 3.0 * np.eye(n)[:, :, None]


def _assert_rel(got, want, rel=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= rel, f"relative error {err:.3e} > {rel:.0e}"


@pytest.mark.parametrize("n", [6, 12])
def test_solve_lanes_matches_pallas_kernel(rng, n):
    G, r = _spd(rng, n), rng.standard_normal((n, B))
    want = jchol.solve_lanes(jnp.asarray(G), jnp.asarray(r), interpret=True)
    before = dict(chol_lanes.launches)
    got = chol_lanes.solve_lanes(torch.as_tensor(G), torch.as_tensor(r))
    _assert_rel(got.numpy(), want)
    assert chol_lanes.launches == before  # CPU tensors never launch


@pytest.mark.parametrize("n,k", [(6, 1), (6, 18), (12, 1), (12, 36)])
def test_solve_lanes_multi_matches_pallas_kernel(rng, n, k):
    from reak_tpu.ctrl.riccati_soa import _chol_solve_lanes

    G, r = _spd(rng, n), rng.standard_normal((n, k, B))
    if (n, k) == (12, 36):
        want = _chol_solve_lanes(jnp.asarray(G), jnp.asarray(r))
    else:
        want = jchol.solve_lanes_multi(jnp.asarray(G), jnp.asarray(r),
                                       interpret=True)
    before = dict(chol_lanes.launches)
    got = chol_lanes.solve_lanes_multi(torch.as_tensor(G),
                                       torch.as_tensor(r))
    _assert_rel(got.numpy(), want)
    assert chol_lanes.launches == before


@pytest.mark.parametrize("n", [6, 12])
def test_standard_layout_solve_matches_jax(rng, n):
    G = np.moveaxis(_spd(rng, n), -1, 0)  # (B, n, n)
    r = rng.standard_normal((B, n))
    want = jchol.solve(jnp.asarray(G), jnp.asarray(r))
    got = chol_lanes.solve(torch.as_tensor(G), torch.as_tensor(r))
    _assert_rel(got.numpy(), want)


def test_right_hand_sides_from_expanded_views(rng):
    """The call sites build right-hand sides from expanded views (an
    identity block beside the jvp columns): the CPU path takes them as they
    are and solves each column."""
    n, batch = 6, 5
    G = torch.as_tensor(_spd(rng, n, batch))
    eye = torch.eye(n, dtype=torch.float64)[:, :, None].expand(n, n, batch)
    inv = chol_lanes.solve_lanes_multi(G, eye)
    want = np.linalg.inv(np.moveaxis(G.numpy(), -1, 0))
    np.testing.assert_allclose(np.moveaxis(inv.numpy(), -1, 0), want,
                               rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("n", [17, 32, 33, 48, 64])
def test_wrapper_takes_systems_up_to_32(n):
    """No width cap: the kernel unrolls n <= 12 (one thread factors a
    scenario) and takes any other n in its run-time instance (one warp a
    scenario), and off the CPU the wrapper lets every n through its size
    check: a meta tensor, standing in for a device tensor, is refused for
    its device only."""
    text = (_build.CSRC / "chol_lanes.cu").read_text()
    cases = {int(c) for c in re.findall(r"REAK_CHOL_CASE\((\d+)\)", text)}
    unrolled = int(re.search(r"kUnrolledMax = (\d+);", text).group(1))
    assert cases == set(range(1, unrolled + 1)) and "default:" in text
    assert not hasattr(chol_lanes, "MAX_N") and "n > 32" not in text
    G = torch.empty(n, n, 4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        chol_lanes.solve_lanes(G, torch.empty(n, 4, dtype=torch.float64,
                                              device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        chol_lanes.solve_lanes_multi(
            G, torch.empty(n, 3, 4, dtype=torch.float64, device="meta"))


@pytest.mark.parametrize("n", [17, 32])
def test_solves_past_16_match_jax(rng, n):
    """At the widths the kernel now takes, the CPU path against the JAX
    package's recurrence ``_chol_solve_lanes`` (which the Pallas kernels
    mirror), one and 5 right-hand sides."""
    from reak_tpu.ctrl.riccati_soa import _chol_solve_lanes

    G, r = _spd(rng, n, 64), rng.standard_normal((n, 5, 64))
    want = _chol_solve_lanes(jnp.asarray(G), jnp.asarray(r))
    got = chol_lanes.solve_lanes_multi(torch.as_tensor(G), torch.as_tensor(r))
    _assert_rel(got.numpy(), want)
    got1 = chol_lanes.solve_lanes(torch.as_tensor(G), torch.as_tensor(r[:, 0]))
    _assert_rel(got1.numpy(), np.asarray(want)[:, 0])


def test_wrapper_refuses_what_the_kernel_does_not_take(rng):
    """Off the CPU the wrapper checks shape, type and device before it
    builds or launches anything (a meta tensor stands in for a device
    tensor); a wide system is refused for its device alone."""
    meta = dict(dtype=torch.float64, device="meta")
    G = torch.empty(33, 33, 4, **meta)
    with pytest.raises(ValueError, match="CUDA device"):
        chol_lanes.solve_lanes(G, torch.empty(33, 4, **meta))
    with pytest.raises(ValueError, match="expected \\(n, n, B\\)"):
        chol_lanes.solve_lanes(torch.empty(33, 32, 4, **meta),
                               torch.empty(33, 4, **meta))
    with pytest.raises(ValueError, match="rhs has shape"):
        chol_lanes.solve_lanes_multi(G, torch.empty(33, 4, **meta))
    with pytest.raises(TypeError, match="float32 or float64"):
        chol_lanes.solve_lanes(G.to(torch.float16),
                               torch.empty(33, 4, dtype=torch.float16,
                                           device="meta"))
    G_cpu = torch.as_tensor(_spd(rng, 3, 4))
    with pytest.raises(ValueError):
        chol_lanes.solve_lanes_multi(G_cpu, torch.empty(3, 2, 4, **meta))


@pytest.mark.parametrize("n,k", [(40, 1), (40, 5), (64, 1), (64, 5)])
def test_plain_path_past_32_matches_numpy(rng, n, k):
    """Past the old cap of 32 the CPU path against ``np.linalg.solve`` at
    f64 (both wrappers), ≤1e-10 relative."""
    G, r = _spd(rng, n, 8), rng.standard_normal((n, k, 8))
    want = np.linalg.solve(np.moveaxis(G, -1, 0), np.moveaxis(r, -1, 0))
    want = np.moveaxis(want, 0, -1)
    got = chol_lanes.solve_lanes_multi(torch.as_tensor(G), torch.as_tensor(r))
    _assert_rel(got.numpy(), want, rel=1e-10)
    got1 = chol_lanes.solve_lanes(torch.as_tensor(G), torch.as_tensor(r[:, 0]))
    _assert_rel(got1.numpy(), want[:, 0], rel=1e-10)


def test_plain_path_at_40_matches_jax(rng):
    """At n = 40 the CPU path against the JAX package's recurrence
    ``_chol_solve_lanes`` on the same inputs, 3 right-hand sides."""
    from reak_tpu.ctrl.riccati_soa import _chol_solve_lanes

    G, r = _spd(rng, 40, 8), rng.standard_normal((40, 3, 8))
    want = _chol_solve_lanes(jnp.asarray(G), jnp.asarray(r))
    got = chol_lanes.solve_lanes_multi(torch.as_tensor(G), torch.as_tensor(r))
    _assert_rel(got.numpy(), want)


@pytest.mark.parametrize("n,itemsize,needed", [
    (12, 8, False), (240, 8, False), (241, 8, True), (340, 4, False),
    (341, 4, True)])
def test_workspace_where_a_factor_leaves_shared_memory(n, itemsize, needed):
    """The wrapper's device-memory work area starts where one scenario's
    packed triangle (padded to an odd length) passes the kernel's
    shared-memory limit, which the wrapper mirrors."""
    text = (_build.CSRC / "chol_lanes.cu").read_text()
    assert f"kSmemMax = {chol_lanes.SMEM_MAX};" in text
    values = chol_lanes.workspace_values(n, 77, itemsize)
    stride = (n * (n + 1) // 2) | 1
    assert values == (96 * stride if needed else 0)


@pytest.mark.parametrize("n,k", [(17, 1), (40, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_vectorized_plain_is_the_plain_version(rng, n, k, dtype):
    """``chip_smoke.chol_rows_plain``, the plain recurrence taken a row
    sweep at a time (which the card's check uses past n = 70), equals the
    plain version bit for bit."""
    from chip_smoke import chol_rows_plain
    from reak_tpu_torch.ctrl.riccati_soa import _chol_solve_lanes

    G = torch.as_tensor(_spd(rng, n, 5), dtype=dtype)
    r = torch.as_tensor(rng.standard_normal((n, k, 5)), dtype=dtype)
    assert torch.equal(chol_rows_plain(G, r), _chol_solve_lanes(G, r))
