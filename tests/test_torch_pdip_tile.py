"""What Python decides for the tile kernels of the port — the whole-solve
PDIP (``csrc/pdip_whole.cu``) and the per-pass kernels (K4a–c of
``csrc/riccati_bwd.cu``), all on ``csrc/riccati_tile.cuh``.  The kernels run
on the card only; held here are the launch shape of each instance
(``ops/_tile.tile_config`` against an H100 block's limits and against the
constants of the header), which instance a width runs on, the C entry points
the wrappers name (a regex over the sources), the libraries the build is
split into, and the plain versions at the ragged batch sizes the card is
held to (B=1 and B=5) against the JAX package's scan at f64 (≤1e-10)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu_torch.ctrl import riccati_soa
from reak_tpu_torch.ops import _build, _tile, pdip_whole, riccati_bwd

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64)
# the exact widths and the bytes of a shared-memory row each takes: 128 B
# up to n = 12, 64 B above, halved where the rows would not fit a block
MAIN_WIDTHS = {(12, 6): 128, (24, 12): 64, (32, 16): 32}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nm", MAIN_WIDTHS)
def test_main_widths_run_exact_instances_within_a_block(nm, dtype):
    """(12, 6), (24, 12) and (32, 16) run instances of their own widths,
    inside an H100 block's shared memory and threads, with whole 32 B
    sectors a row."""
    tile = _tile.tile_config(*nm, dtype)
    size = 4 if dtype == torch.float32 else 8
    assert tile.exact and tile.widths == nm
    assert tile.shared_bytes <= 232448 == _tile.MAX_SHARED_BYTES
    assert tile.threads == tile.scenarios * nm[0] <= 1024 == _tile.MAX_THREADS
    assert tile.threads % 32 == 0
    assert (tile.scenarios * size) % 32 == 0
    assert tile.scenarios * size == MAIN_WIDTHS[nm]


@pytest.mark.parametrize("nm,dtype,shape", [
    ((12, 6), torch.float32, (32, 384, 107280)),
    ((12, 6), torch.float64, (16, 192, 108576)),
    ((24, 12), torch.float32, (16, 384, 207936)),
    ((24, 12), torch.float64, (8, 192, 213120)),
    ((32, 16), torch.float32, (8, 256, 187392)),
    ((32, 16), torch.float64, (4, 128, 196608))])
def test_launch_shapes_of_the_exact_instances(nm, dtype, shape):
    """(12, 6) and (24, 12) keep the scenarios, threads and shared memory
    they had before the (32, 16) bound; (32, 16) takes the largest tile
    that fits a block: 8 scenarios in f32, 4 in f64 (at 16 and 8 it would
    need 365,568 and 374,784 B)."""
    tile = _tile.tile_config(*nm, dtype)
    assert (tile.scenarios, tile.threads, tile.shared_bytes) == shape


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nm,bound", [((6, 3), (16, 8)), ((13, 7), (16, 8)),
                                      ((16, 8), (16, 8)), ((4, 2), (16, 8)),
                                      ((16, 9), (24, 12)),
                                      ((17, 3), (24, 12)),
                                      ((12, 7), (16, 8)),
                                      ((25, 6), (32, 16)),
                                      ((12, 13), (32, 16)),
                                      ((26, 13), (32, 16)),
                                      ((32, 15), (32, 16))])
def test_other_widths_run_the_padded_instance_of_their_bound(nm, bound,
                                                             dtype):
    tile = _tile.tile_config(*nm, dtype)
    assert not tile.exact
    assert tile.bound == tile.widths == bound == pdip_whole.instance_for(*nm)
    assert tile.shared_bytes <= _tile.MAX_SHARED_BYTES
    assert tile.threads <= _tile.MAX_THREADS


@pytest.mark.parametrize("nm", [(33, 6), (12, 17), (30, 30)])
def test_beyond_the_widest_instance_raises(nm):
    """Past (32, 16) nothing is refused any more (fault F7): the widths
    take the runtime-width instance (no bound), NB = max(n, m) columns and
    MB = m, its rows in shared memory at these widths, inside a block."""
    for dtype in DTYPES:
        tile = _tile.tile_config(*nm, dtype)
        assert tile.bound is None and tile.runtime and not tile.exact
        assert tile.widths == (max(nm), nm[1])
        assert tile.branch == "shared"
        assert 0 < tile.shared_bytes <= _tile.MAX_SHARED_BYTES
        assert tile.scenarios >= 1 and tile.threads <= _tile.MAX_THREADS
        assert tile.block_values > 0
    assert _tile.instance_for(*nm) is None
    assert pdip_whole.entry_point(None, torch.float64) in pdip_whole.SIGNATURES


def _any_tile_field(text, field, env):
    """``t.<field> = <expression>;`` of ``riccati_tile.cuh::any_tile``,
    evaluated as Python over ``env``."""
    m = re.search(rf"t\.{field} =\s*([^;]+);", text)
    assert m, field
    expr = re.sub(r"\s+", " ", m.group(1)).replace("t.", "t_")
    expr = re.sub(r"static_cast<(?:long long|int)>", "", expr)

    def top(e):
        """``a ? b : c`` at parenthesis depth 0 of ``e`` as Python."""
        depth, q = 0, None
        for i, ch in enumerate(e):
            depth += (ch == "(") - (ch == ")")
            if depth == 0 and ch == "?" and q is None:
                q = i
            elif depth == 0 and ch == ":" and q is not None:
                return (f"(({e[q + 1:i]}) if ({e[:q]}) else "
                        f"({top(e[i + 1:])}))")
        return e

    while True:  # the innermost parentheses that hold a ternary first
        inner = re.search(r"\(([^()]*\?[^()]*)\)", expr)
        if inner is None:
            break
        expr = (expr[:inner.start()] + "(" + top(inner.group(1)) + ")"
                + expr[inner.end():])
    return eval(top(expr).replace("/", "//"), {}, env)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nm", [(33, 17), (48, 24), (80, 40), (20, 24),
                                (62, 31)])
def test_runtime_tile_mirrors_the_header(nm, dtype):
    """Past the widest bound ``tile_config`` is
    ``riccati_tile.cuh::any_tile``: NB = max(n, m) columns, MB = m, TS
    from a 64 B row halved while TS × NB passes 1,024 threads and then
    while the rows do not fit a block (down to 1); where they do not fit
    even at TS = 1 the branch is device memory (no shared memory, TS as
    the threads allow).  A thread takes every nc-th column; the work area
    of a block holds its columns' rows and, on the device branch, its rows
    and constants."""
    text = (_build.CSRC / "riccati_tile.cuh").read_text()
    for name, value in (("ANY_GRID", _tile.ANY_GRID),
                        ("ANY_THREADS", _tile.ANY_THREADS)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    m = re.search(r"constexpr int MAX_SHARED_BYTES = (\d+);",
                  (_build.CSRC / "riccati_tile.cuh").read_text())
    assert int(m.group(1)) == _tile.MAX_SHARED_BYTES
    size = 4 if dtype == torch.float32 else 8
    tile = _tile.tile_config(*nm, dtype)
    nb, mb = max(nm), nm[1]
    assert tile.bound is None and tile.widths == (nb, mb)
    env = {"nb": nb, "mb": mb, "size": size, "t_nb": nb, "t_mb": mb}
    for field in ("rows", "consts", "col_rows"):
        env[f"t_{field}"] = _any_tile_field(text, field, env)
    fits = lambda ts: size * (env["t_rows"] * ts + env["t_consts"]) <= \
        _tile.MAX_SHARED_BYTES
    ts0 = 64 // size
    while ts0 > 1 and ts0 * nb > _tile.ANY_THREADS:
        ts0 //= 2
    assert tile.branch == ("shared" if fits(1) else "device")
    if tile.branch == "shared":
        assert fits(tile.scenarios) and (tile.scenarios == ts0
                                         or not fits(2 * tile.scenarios))
    else:
        assert tile.scenarios == ts0
    env.update({"t_ts": tile.scenarios, "t_shared": tile.branch == "shared"})
    assert tile.shared_bytes == _any_tile_field(text, "smem_bytes", env)
    assert tile.block_values == _any_tile_field(text, "block_values", env)
    assert 1 <= tile.scenarios and tile.threads <= _tile.MAX_THREADS
    assert tile.threads == tile.scenarios * min(nb, _tile.ANY_THREADS
                                                // tile.scenarios)
    assert tile.shared_bytes <= _tile.MAX_SHARED_BYTES
    assert tile.blocks(33) == -(-33 // tile.scenarios)
    assert tile.blocks(10 ** 6) == _tile.ANY_GRID
    assert tile.padded_batch(33) % tile.scenarios == 0


@pytest.mark.parametrize("dtype,first", [(torch.float64, (62, 31)),
                                         (torch.float32, (88, 44))])
def test_device_branch_starts_where_a_scenario_stops_fitting(dtype, first):
    """At m = n / 2, the smallest width whose rows do not fit a block at
    TS = 1 (the device-memory branch) is (62, 31) in f64 and (88, 44) in
    f32; the width below stays in shared memory."""
    assert _tile.tile_config(*first, dtype).branch == "device"
    below = (first[0] - 2, first[1] - 1)
    assert _tile.tile_config(*below, dtype).branch == "shared"


def test_other_types_raise():
    with pytest.raises(TypeError):
        _tile.tile_config(12, 6, torch.float16)


def test_launch_shape_does_not_depend_on_the_horizon():
    """The stages stream through two buffers: ``tile_config`` takes no
    horizon, and the scratch of the whole-solve kernel grows with H while
    its shared memory does not."""
    import inspect

    assert "H" not in inspect.signature(_tile.tile_config).parameters
    assert pdip_whole.scratch_values(256, 12, 6) == \
        256 * pdip_whole.scratch_values(1, 12, 6)


@pytest.mark.parametrize("B,padded,blocks", [(1, 32, 1), (32, 32, 1),
                                             (33, 64, 2), (1000, 1024, 32),
                                             (8192, 8192, 256)])
def test_scratch_is_padded_to_whole_tiles(B, padded, blocks):
    tile = _tile.tile_config(12, 6, torch.float32)
    assert tile.scenarios == 32
    assert tile.padded_batch(B) == padded and tile.blocks(B) == blocks


def _cuh_python(expr):
    """A C expression of the header as Python over NB, MB, size and the
    other constants (``a ? b : c`` as ``a and b or c``, ints divided by
    ``//``)."""
    expr = expr.replace("NB_", "NB").replace("MB_", "MB")
    expr = expr.replace("int(sizeof(T))", "size").replace("?", " and ")
    return re.sub(r"\s+", " ", expr.replace(":", " or ").replace("/", "//"))


def _cuh_constant(name):
    """``static constexpr int <name> = <expression>;`` of the header, as
    Python source."""
    text = (_build.CSRC / "riccati_tile.cuh").read_text()
    m = re.search(rf"static constexpr int {name} =\s*([^;]+);", text)
    assert m, name
    return _cuh_python(m.group(1))


def _cuh_env():
    """The header's free constants and its ``fit_rows``, as Python."""
    text = (_build.CSRC / "riccati_tile.cuh").read_text()
    m = re.search(r"constexpr int MAX_SHARED_BYTES = (\d+);", text)
    env = {"MAX_SHARED_BYTES": int(m.group(1))}
    m = re.search(r"constexpr int fit_rows\(int ts, int most\) \{\s*"
                  r"return ([^;]+);", text)
    body = _cuh_python(m.group(1))
    env["fit_rows"] = lambda ts, most: eval(body, {},
                                            {**env, "ts": ts, "most": most})
    return env


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nm", [(12, 6), (24, 12), (6, 3), (16, 9),
                                (32, 16), (26, 13)])
def test_tile_config_mirrors_the_header(nm, dtype):
    """The shared memory and threads that ``tile_config`` hands the launch
    are what ``riccati_tile.cuh::Tile`` computes for the same instance (the
    C entry point refuses a launch whose size differs)."""
    tile = _tile.tile_config(*nm, dtype)
    env = {**_cuh_env(), "NB": tile.widths[0], "MB": tile.widths[1],
           "size": 4 if dtype == torch.float32 else 8}
    assert env["MAX_SHARED_BYTES"] == _tile.MAX_SHARED_BYTES
    for name in ("AB_ROWS", "WORK_ROWS", "VEC_ROWS", "ROWS", "CONSTS", "TS",
                 "NT", "SMEM"):
        env[name] = eval(_cuh_constant(name), {}, dict(env))
    assert env["TS"] == tile.scenarios
    assert env["NT"] == tile.threads
    assert env["SMEM"] == tile.shared_bytes


def test_exact_widths_mirror_the_header():
    """``ExactWidths`` of the header, keyed by the whole bound (its
    specializations; the bound itself otherwise), is ``_tile.EXACT``."""
    text = (_build.CSRC / "riccati_tile.cuh").read_text()
    special = {(int(a), int(b)): (int(c), int(d)) for a, b, c, d in re.findall(
        r"struct ExactWidths<(\d+), (\d+)> \{\s*static constexpr int "
        r"N = (\d+), M = (\d+);", text)}
    assert special == {(16, 8): (12, 6)}
    assert re.search(r"struct ExactWidths \{\s*static constexpr int "
                     r"N = NMAX, M = MMAX;", text)
    assert set(_tile.EXACT) == set(_tile.INSTANCES)
    for bound, exact in _tile.EXACT.items():
        assert special.get(bound, bound) == exact


def _entry_points(source, bound, suffix):
    """The ``extern "C"`` functions ``csrc/<source>.cu`` defines when it is
    built for one bound and type (``bound=None``: its runtime-width
    instance): its entry macro, expanded by hand."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    assert 'extern "C" {' in text
    names = re.findall(r"^  int (reak_\w+(?:##\w+)+)\(", text, flags=re.M)
    names = [nm for nm in names if ("_any_##" in nm) == (bound is None)]
    fill = {"SUFFIX": suffix}
    if bound is not None:
        fill.update({"NM": str(bound[0]), "MM": str(bound[1])})
    return {"".join(fill.get(tok, tok) for tok in name.split("##"))
            for name in names}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bound", (*_tile.INSTANCES, None))
def test_signatures_name_entry_points_of_the_sources(bound, dtype):
    """Every function a wrapper declares exists in its ``.cu``, and its
    argument list is as long as the C one: a renamed or re-typed entry point
    is caught without nvcc."""
    suffix = "f32" if dtype == torch.float32 else "f64"
    k2 = _entry_points("pdip_whole", bound, suffix)
    assert k2 == {pdip_whole.entry_point(bound, dtype)}
    assert pdip_whole.LIBRARIES[pdip_whole.library(bound, dtype)].keys() == k2
    k4 = _entry_points("riccati_bwd", bound, suffix)
    want = {riccati_bwd.entry_point(e, bound, dtype)
            for e in riccati_bwd.launches}
    assert k4 == want
    assert riccati_bwd.LIBRARIES[riccati_bwd.library(bound,
                                                     dtype)].keys() == want
    for source, table in (("pdip_whole", pdip_whole.SIGNATURES),
                          ("riccati_bwd", riccati_bwd.SIGNATURES)):
        text = (_build.CSRC / f"{source}.cu").read_text()
        for macro_name in re.findall(r"^  int (reak_\w+(?:##\w+)+)\(", text,
                                     flags=re.M):
            if ("_any_##" in macro_name) != (bound is None):
                continue
            params = text[text.index(macro_name):]
            params = params[params.index("(") + 1:params.index(") {")]
            c_args = [a for a in params.replace("\\", "").split(",")
                      if a.strip()]
            fill = {"SUFFIX": suffix}
            if bound is not None:
                fill.update({"NM": str(bound[0]), "MM": str(bound[1])})
            name = "".join(fill.get(t, t) for t in macro_name.split("##"))
            assert len(table[name]) == len(c_args), name


def test_instance_libraries_select_one_bound_and_type():
    """``name@<NMAX>x<MMAX>_<type>`` compiles ``csrc/<name>.cu`` with the
    macros the source asks for; a plain name compiles it as it is; the
    library's path depends on them."""
    source, defines = _build._source_and_defines("pdip_whole@24x12_f64")
    assert source == _build.CSRC / "pdip_whole.cu"
    assert defines == ["-DREAK_NMAX=24", "-DREAK_MMAX=12",
                       "-DREAK_TYPE=double", "-DREAK_SUFFIX=f64"]
    text = source.read_text()
    for d in defines:
        assert d[2:].split("=")[0] in text
    assert _build._source_and_defines("kte_step") == (
        _build.CSRC / "kte_step.cu", [])
    paths = {_build.library_path(name) for name in
             (*pdip_whole.LIBRARIES, *riccati_bwd.LIBRARIES)}
    assert len(paths) == 4 * (len(_tile.INSTANCES) + 1) == 16
    assert pdip_whole.library((16, 8), torch.float32) == \
        _build.instance_library("pdip_whole", (16, 8), "f32")
    assert _build._source_and_defines("riccati_bwd@any_f32") == (
        _build.CSRC / "riccati_bwd.cu",
        ["-DREAK_RUNTIME=1", "-DREAK_TYPE=float", "-DREAK_SUFFIX=f32"])


def test_both_kernels_include_the_shared_stage_code():
    """The reverse, vector and forward stages of the tile live once, in
    ``riccati_tile.cuh``: the per-pass kernels run them at compile-time and
    at run-time widths (the width policy ``wd``), the whole-solve kernel at
    run-time widths; its compile-time instances run the TMA pipeline of
    ``pdip_whole.cu`` on the primitives of ``hopper.cuh`` (the tile's
    factor and substitutions, no cp.async).  The one-thread-per-scenario
    design, its header and a second copy of the passes for run-time widths
    are gone."""
    for source in ("pdip_whole", "riccati_bwd"):
        text = (_build.CSRC / f"{source}.cu").read_text()
        assert '#include "riccati_tile.cuh"' in text
        assert "reverse_pass(wd," in text
        assert "__launch_bounds__" in text
        assert "vector_pass<" in text and "forward_pass(wd," in text
        assert "const AnyWidths<T> wd" in text
        assert "lanes.cuh" not in text and "tile_any" not in text
    assert "const TL wd{}" in (_build.CSRC / "riccati_bwd.cu").read_text()
    k2 = (_build.CSRC / "pdip_whole.cu").read_text()
    assert '#include "hopper.cuh"' in k2 and "pdip_pipe_kernel" in k2
    for call in ("tma_load(", "mbar_wait(", "mbar_arrive_expect_tx(",
                 "named_sync(", "regs_inc<", "regs_dec<",
                 "fence_proxy_async_global()", "tile_chol_factor(pol,",
                 "tile_chol_apply(", "__grid_constant__"):
        assert call in k2, call
    pipe = k2[k2.index("struct Pipe {"):]
    assert "cp_async" not in pipe and "__syncthreads();\n  // the roles" in pipe
    k4 = (_build.CSRC / "riccati_bwd.cu").read_text()
    assert "vector_pass<TL, true>" in k4 and "chol_factor(" not in k4
    assert not (_build.CSRC / "lanes.cuh").exists()
    assert not (_build.CSRC / "riccati_tile_any.cuh").exists()
    header = (_build.CSRC / "riccati_tile.cuh").read_text()
    for fn in ("reverse_pass", "vector_pass", "forward_pass"):
        assert header.count(f"inline void {fn}(") == 1
    assert "cp.async" in header and "cudaFuncAttributeMaxDynamicShared" \
        "MemorySize" in (_build.CSRC / "pdip_whole.cu").read_text()


def test_tile_shape_experiment_still_fits_the_sources():
    """``ops/tile_shapes.py`` patches copies of the sources; each text it
    replaces is there exactly once, and its first shape is what ships."""
    from reak_tpu_torch.ops import tile_shapes

    for name, old, _ in tile_shapes.PATCHES:
        assert (_build.CSRC / name).read_text().count(old) == 1, name
    tile = _tile.tile_config(12, 6, torch.float32)
    shared, ts = tile_shapes._shared_bytes(tile_shapes.SHAPES[0][0])
    assert (shared, ts) == (tile.shared_bytes, tile.scenarios)


def _problem(rng, H, n, m, B):
    return dict(
        A=rng.standard_normal((H, n, n, B)) * 0.1 + np.eye(n)[None, :, :, None],
        Bm=rng.standard_normal((H, n, m, B)) * 0.2,
        c=rng.standard_normal((H, n, B)) * 0.05,
        x0=rng.standard_normal((n, B)),
        Q=np.eye(n), QN=np.eye(n) * 5.0, R=np.eye(m) * 0.1,
        lb=np.full(m, -1.5), ub=np.full(m, 1.5),
        x_ref=rng.standard_normal((H, n, B)) * 0.1,
        u_ref=rng.standard_normal((H, m, B)) * 0.1)


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("mode", ["regulator", "x_ref+u_ref"])
def test_plain_scan_at_ragged_batches_matches_jax(rng, B, mode):
    """``_fused_scan`` (K2's plain version) at batches no tile divides,
    against the JAX package's scan at f64 (≤1e-10)."""
    from reak_tpu.ctrl.riccati_soa import \
        solve_box_mpc_riccati_soa_fused as jax_fused

    p = _problem(rng, 6, 4, 2, B)
    keys = ("A", "Bm", "c", "Q", "QN", "R", "x0", "lb", "ub")
    refs = ("x_ref", "u_ref") if mode != "regulator" else ()
    u_j, x_j = jax_fused(*(jnp.asarray(p[k]) for k in keys), iters=6,
                         use_kernels="never",
                         **{k: jnp.asarray(p[k]) for k in refs})
    u_t, x_t = riccati_soa._fused_scan(
        *(torch.as_tensor(p[k]) for k in keys), iters=6,
        **{k: torch.as_tensor(p[k]) for k in refs})
    assert u_t.shape == (6, 2, B) and x_t.shape == (6, 4, B)
    assert np.max(np.abs(u_t.numpy() - np.asarray(u_j))) <= 1e-10
    assert np.max(np.abs(x_t.numpy() - np.asarray(x_j))) <= 1e-10


@pytest.mark.parametrize("B", [1, 5])
def test_plain_fused_backward_at_ragged_batches_matches_jax(rng, B):
    """``fused_backward_plain`` (K4a's plain version) at B=1 and B=5 against
    the fused reverse pass of the JAX package's scan at f64 (≤1e-10)."""
    from reak_tpu.ctrl import riccati_soa as jrs

    H, n, m = 6, 4, 2
    p = _problem(rng, H, n, m, B)
    q = rng.standard_normal((H, n, B))
    u_eff = rng.standard_normal((H, m, B))
    D = rng.uniform(0.5, 2.0, (H, m, B))
    got = riccati_soa.fused_backward_plain(
        *(torch.as_tensor(a) for a in (p["A"], p["Bm"], q, u_eff, D, p["Q"],
                                       p["QN"], p["R"])))
    # the same pass from the JAX package's unfused pieces: the Riccati
    # matrix recursion with R_t = R + diag(D_t), then the adjoint and the
    # affine vector recursion written out
    R_seq = p["R"][None, :, :, None] + np.eye(m)[None, :, :, None] \
        * D[:, :, None, :]
    Ks, Gs = jrs.lqr_backward_soa(jnp.asarray(p["A"]), jnp.asarray(p["Bm"]),
                                  jnp.asarray(p["Q"]), jnp.asarray(p["QN"]),
                                  jnp.asarray(R_seq))
    Ks, Gs = np.asarray(Ks), np.asarray(Gs)
    lam, v = np.zeros((n, B)), np.zeros((n, B))
    grad, ks = np.zeros((H, m, B)), np.zeros((H, m, B))
    for t in reversed(range(H)):
        At, Bt = p["A"][t], p["Bm"][t]
        lam_full = q[t] + lam
        grad[t] = np.einsum("ij,jb->ib", p["R"], u_eff[t]) \
            + np.einsum("kib,kb->ib", Bt, lam_full)
        w = grad[t] + np.einsum("kib,kb->ib", Bt, v)
        ks[t] = np.linalg.solve(np.moveaxis(Gs[t], -1, 0),
                                w.T[:, :, None])[:, :, 0].T
        v = np.einsum("kib,kb->ib", At, v) - np.einsum("kib,kb->ib", Ks[t], w)
        lam = np.einsum("kib,kb->ib", At, lam_full)
    for g, want in zip(got, (grad, Ks, Gs, ks)):
        assert g.shape == want.shape
        assert np.max(np.abs(g.numpy() - want)) <= 1e-10


def _pipe_constants(nb, mb, size):
    """The constants of ``pdip_whole.cu::Pipe`` at (NB, MB) and a type of
    ``size`` bytes, evaluated as Python."""
    text = (_build.CSRC / "pdip_whole.cu").read_text()
    body = text[text.index("struct Pipe {"):]
    body = body[:body.index("\n};")]
    env = {**_cuh_env(), "NB": nb, "MB": mb, "size": size}
    for name in ("SIZE", "RING", "BAR_BYTES", "SLOT_VEC", "SLOT_ROWS",
                 "WORK_ROWS", "VEC_ROWS", "CONSTS", "CONST_BYTES", "ROWS",
                 "TS", "ROW", "NC", "SMEM", "REALLOC", "PRODUCER", "NT",
                 "ENTRY_REGS", "PRODUCER_REGS", "CONSUMER_REGS"):
        m = re.search(rf"static constexpr (?:int|bool) {name} =\s*([^;]+);",
                      body)
        assert m, name
        expr = _cuh_python(m.group(1)).replace("&&", " and ")
        env[name] = eval(expr, {}, dict(env))
    return env


PIPE_WIDTHS = [(12, 6), (24, 12), (32, 16), (14, 7), (6, 3), (13, 7),
               (26, 13)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nm", PIPE_WIDTHS)
def test_pipe_config_mirrors_the_source(nm, dtype):
    """``_tile.pipe_config`` (what the wrapper hands the C entry point,
    which refuses a launch whose shared memory differs) is
    ``pdip_whole.cu::Pipe`` of the same instance: scenarios, threads with
    the producer, shared bytes, the ring and whether setmaxnreg runs."""
    cfg = _tile.pipe_config(*nm, dtype)
    env = _pipe_constants(*cfg.widths, 4 if dtype == torch.float32 else 8)
    assert env["RING"] == cfg.ring == _tile.RING
    assert env["BAR_BYTES"] == _tile.BAR_BYTES
    assert (env["TS"], env["NC"], env["NT"], env["SMEM"]) == (
        cfg.scenarios, cfg.consumers, cfg.threads, cfg.shared_bytes)
    assert bool(env["REALLOC"]) == cfg.realloc
    assert _tile.k2_config(*nm, dtype) == cfg


@pytest.mark.parametrize("dtype,nm,shape", [
    (torch.float32, (12, 6), (32, 512, 209792, True, 160)),
    (torch.float64, (12, 6), (16, 224, 211072, False, 248)),
    (torch.float32, (14, 7), (16, 384, 178432, True, 240)),
    (torch.float64, (14, 7), (8, 160, 180736, False, 248)),
    (torch.float32, (24, 12), (8, 224, 192896, False, 248)),
    (torch.float64, (24, 12), (4, 128, 198016, False, 248)),
    (torch.float32, (32, 16), (4, 160, 171520, False, 248)),
    (torch.float64, (32, 16), (2, 96, 180736, False, 248))])
def test_pipe_launch_shapes(dtype, nm, shape):
    """The pipeline's instances: a ring of three slots, TS × NB consumers in
    whole warps and a producer, one block an SM within an H100 block's
    shared memory, rows of whole 16 B for TMA.  The flagship's (12, 6) in
    f32 keeps the tile's 32 scenarios; its block of 512 threads enters
    with 128 registers a thread (ptxas shares the SM's among whole
    warpgroups), and the producer warpgroup's 104 a thread given up buy
    the consumers 160; setmaxnreg needs the consumers to be whole
    warpgroups, and elsewhere a producer warp and 255 a thread fit."""
    cfg = _tile.pipe_config(*nm, dtype)
    env = _pipe_constants(*cfg.widths, cfg.size)
    assert (cfg.scenarios, cfg.threads, cfg.shared_bytes, cfg.realloc,
            env["CONSUMER_REGS"]) == shape
    assert cfg.ring >= 3
    assert cfg.threads == cfg.consumers + (128 if cfg.realloc else 32)
    assert cfg.consumers % 32 == 0 and cfg.threads <= _tile.MAX_THREADS
    assert cfg.shared_bytes <= _tile.MAX_SHARED_BYTES
    assert cfg.blocks_per_sm == 1
    assert (cfg.scenarios * cfg.size) % 16 == 0
    if cfg.realloc:
        # the producer warpgroup gives up what the consumers take, and the
        # SM keeps 1,024 of its 65,536 spare
        assert cfg.consumers % 128 == 0 and cfg.threads % 128 == 0
        entry, prod = env["ENTRY_REGS"], env["PRODUCER_REGS"]
        given = 128 * (entry - prod)
        taken = cfg.consumers * (env["CONSUMER_REGS"] - entry)
        assert 0 < taken <= given
        assert (cfg.consumers * env["CONSUMER_REGS"] + 128 * prod + 1024
                <= _tile.SM_REGISTERS)
    else:
        assert (cfg.consumers + 32) * 255 <= _tile.SM_REGISTERS or \
            cfg.consumers % 128 != 0


def _tma_boxes():
    """{map: (rank, its box as C expressions)} of the tensor maps the
    whole-solve kernel's launch encodes (``pdip_whole.cu::launch``)."""
    text = (_build.CSRC / "pdip_whole.cu").read_text()
    text = text[text.index("int launch(const void* A"):]
    found = re.findall(r"map\(&a\.(\w+), [^,]+, (\d), \{[^}]*\},\s*"
                       r"\{([^}]*)\}\);", text)
    return {name: (int(rank), [e.strip() for e in box.split(",")])
            for name, rank, box in found}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nm", [(12, 6), (24, 12), (32, 16), (14, 7)])
def test_tma_boxes_take_a_stage_in_one_load(nm, dtype):
    """Each stage's array is one TMA box: the launch's maps are 3- or 4-D
    over the scenario-last arrays ((B, n, n, H) for A), so no box dimension
    passes TMA's 256 even at (24, 12) and (32, 16), where a 2-D (n·n, B)
    map would need 576 and 1,024 rows, i.e. several boxes a stage; the
    inner dimension is TS scenarios of whole 16 B; every box but the
    unused refs' is loaded into a slot of its rows (``SlotRows``)."""
    cfg = _tile.pipe_config(*nm, dtype)
    nb, mb = cfg.widths
    env = {"TS": cfg.scenarios, "NB": nb, "MB": mb}
    boxes = {name: (rank, [eval(e, {}, env) for e in box])
             for name, (rank, box) in _tma_boxes().items()}
    assert set(boxes) == {"A", "Bm", "c", "xr", "ur", "K", "L", "it", "xs",
                          "dx"}
    for name, (rank, box) in boxes.items():
        assert len(box) == rank in (3, 4), name
        assert all(1 <= d <= 256 for d in box), name
        assert box[0] == cfg.scenarios and (box[0] * cfg.size) % 16 == 0
    rows = {name: int(np.prod(box)) // cfg.scenarios
            for name, (_, box) in boxes.items()}
    assert rows["A"] == nb * nb and rows["Bm"] == nb * mb
    assert rows["K"] == mb * nb and rows["L"] == mb * mb
    assert rows["it"] == rows["ur"] == mb
    assert rows["xs"] == rows["dx"] == rows["c"] == rows["xr"] == nb
    if nm in ((24, 12), (32, 16)):
        assert nb * nb > 256  # a 2-D map's rows: past one box


@pytest.mark.parametrize("dtype,B,padded", [
    (torch.float32, 1, 4), (torch.float32, 77, 80), (torch.float32, 1001, 1004),
    (torch.float32, 8192, 8192), (torch.float64, 1, 2), (torch.float64, 77, 78),
    (torch.float64, 100, 100), (torch.float64, 1001, 1002)])
def test_tma_batch_pads_rows_to_whole_16_bytes(dtype, B, padded):
    """TMA describes a scenario-last array only where a row of B values is
    a whole number of 16 B: the wrapper copies a batch that is not into
    one padded with zero scenarios (4 a quantum in f32, 2 in f64) and
    passes one that is as it is."""
    cfg = _tile.pipe_config(12, 6, dtype)
    assert cfg.batch_quantum == (4 if dtype == torch.float32 else 2)
    g = torch.Generator().manual_seed(B)
    A = torch.randn(3, 12, 12, B, generator=g, dtype=dtype)
    Bm = torch.randn(3, 12, 6, B, generator=g, dtype=dtype)
    c = torch.randn(3, 12, B, generator=g, dtype=dtype)
    x0 = torch.randn(12, B, generator=g, dtype=dtype)
    ur = torch.randn(3, 6, B, generator=g, dtype=dtype)
    out = pdip_whole._tma_batch(cfg, A, Bm, c, x0, [None, ur])
    *arrays, refs, Bq = out
    assert Bq == padded and refs[0] is None
    for got, want in zip([*arrays, refs[1]], [A, Bm, c, x0, ur]):
        assert got.shape[-1] == padded and got.is_contiguous()
        assert torch.equal(got[..., :B], want)
        assert not got[..., B:].any()
        assert (got is want) == (padded == B)


def test_tma_batch_copies_a_misaligned_base():
    """A contiguous input whose base is not 16 B aligned (a view at an
    offset) is copied, at the same batch."""
    cfg = _tile.pipe_config(12, 6, torch.float32)
    big = torch.zeros(3 * 12 * 12 * 8 + 1)
    A = big[1:].view(3, 12, 12, 8)
    assert A.is_contiguous() and A.data_ptr() % 16 != 0
    others = [torch.zeros(3, 12, 6, 8), torch.zeros(3, 12, 8),
              torch.zeros(12, 8)]
    *arrays, _, Bq = pdip_whole._tma_batch(cfg, A, *others, [None, None])
    assert Bq == 8 and arrays[0] is not A and torch.equal(arrays[0], A)
    assert arrays[0].data_ptr() % 16 == 0


def test_phase_stamps_fit_the_source(tmp_path):
    """``ops/k2_phases.py`` builds K2 with its stamps: the source calls
    only the hooks the stamps define, empty unless they are inserted, each
    phase slot of a solve once in its order, the spans in their slots, and
    the stamped copy defines the hooks before the source's first
    include."""
    from reak_tpu_torch.ops import k2_phases

    text = (_build.CSRC / "pdip_whole.cu").read_text()
    hooks = set(re.findall(r"\b(REAK_K2_\w+)\(", text))
    assert hooks == {"REAK_K2_BEGIN", "REAK_K2_STAMP", "REAK_K2_SPAN_BEGIN",
                     "REAK_K2_SPAN_END", "REAK_K2_END"}
    for hook in hooks:
        assert f"#define {hook}(" in text and f"#define {hook}(" in \
            k2_phases.STAMPS
    stamps = [int(s) for s in re.findall(r"REAK_K2_STAMP\((\d+)\);", text)]
    assert stamps == list(range(len(k2_phases.SLOTS)))
    spans = {int(s) for s in re.findall(r"REAK_K2_SPAN_END\([^,]+, (\d+)\)",
                                        text)}
    first = len(k2_phases.SLOTS)
    assert spans == set(range(first, first + len(k2_phases.SPANS)))
    assert first + len(k2_phases.SPANS) <= k2_phases.N_SLOTS
    k2_phases.stamped_source(_build.CSRC, tmp_path / "csrc")
    stamped = (tmp_path / "csrc" / "pdip_whole.cu").read_text()
    at = stamped.index("#define REAK_K2_STAMPS 1")
    assert at < stamped.index('#include "hopper.cuh"')
    assert stamped.count("reak_k2_cycles_read") == 1
