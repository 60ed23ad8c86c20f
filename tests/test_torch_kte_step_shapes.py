"""What Python decides for the rollout-step kernel (K1) and its core
instance (K5), both in ``csrc/kte_step.cu``, and the plain versions they are
held to on a chain that takes every branch of the kernel.

The kernels run on the card only (``chip_smoke.py``).  Held here: the launch
shape of each instance (``ops/kte_step.launch_shape``, which both wrappers
use) against an H100 block's limits and against the constants of the
source; which library a chain runs on; the C entry points the wrappers name
(a regex over the source, no nvcc); the size of the chain table the kernel
takes by value; and, on the mixed chain of 8 links that ``chip_smoke.py``
checks (``kte/models.mixed_chain``: FIXED and PRISMATIC joints, offset
quaternions, springs, dampers, full inertia tensors), the port's plain
terms, core and step against the JAX package's ``make_terms_lanes`` and its
jvp along every state direction, the core's solves and the step's series
taken from them as ``make_rollout_ltv_lanes`` takes them, in numpy (B=4,
f64, ≤1e-10), the chain carried across by ``convert.spec_from``.  The JAX
side runs op by op: under ``jax.jit`` its rollout of this chain compiles for
most of a minute on a CPU."""
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu.kte import lanes as jlanes
from reak_tpu.kte import spec as jspec
from reak_tpu_torch import convert
from reak_tpu_torch.kte import lanes, models
from reak_tpu_torch.ops import _build, _tile, kte_core, kte_step

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64)
SOURCE = _build.CSRC / "kte_step.cu"


def _mixed_chain_jax():
    """The JAX package's spec of ``kte/models.mixed_chain``: 8 links, 6
    dofs (a FIXED first link and one inside, two PRISMATIC joints, offset
    quaternions, springs, dampers, off-diagonal inertia tensors, a tilted
    gravity)."""
    return jspec.ChainSpec.build(**models.mixed_chain_fields())


def _states(rng, nv, B):
    return np.concatenate([rng.uniform(-0.5, 0.5, (nv, B)),
                           rng.uniform(-0.3, 0.3, (nv, B))])


def _assert_rel(got, want, rel=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)
    assert err <= rel, f"relative error {err:.3e} > {rel:.0e}"


# ---- launch shapes --------------------------------------------------------

def _split_top(expr, sep):
    """``expr`` split at the first ``sep`` outside parentheses, or None."""
    depth = 0
    for i, ch in enumerate(expr):
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0 and expr.startswith(sep, i):
            return expr[:i], expr[i + len(sep):]
    return None


def _c_to_python(expr):
    """A C expression of the source as Python: ``int(sizeof(T))`` is
    ``size``, ``a ? b : c`` is ``(b if a else c)`` (right-associative, at
    any depth of parentheses), ``&&``/``||``/``!=`` and ``/`` on ints
    ``//``."""
    expr = re.sub(r"\s+", " ", expr).strip()
    expr = expr.replace("int(sizeof(T))", "size")
    cond = _split_top(expr, "?")
    if cond is not None:
        then, other = _split_top(cond[1], ":")
        return (f"(({_c_to_python(then)}) if ({_c_to_python(cond[0])}) "
                f"else ({_c_to_python(other)}))")
    # parenthesised parts may hold ternaries of their own
    out, i = "", 0
    while i < len(expr):
        if expr[i] == "(":
            depth, j = 1, i + 1
            while depth:
                depth += expr[j] == "("
                depth -= expr[j] == ")"
                j += 1
            out += "(" + _c_to_python(expr[i + 1:j - 1]) + ")"
            i = j
        else:
            out += expr[i]
            i += 1
    out = out.replace("&&", " and ").replace("||", " or ")
    out = re.sub(r"!(?!=)", " not ", out)
    out = out.replace("true", "True").replace("false", "False")
    return out.replace("/", "//").replace("////", "//")


def _source_constant(text, name):
    """``constexpr <type> <name> = <expression>;`` of the source, as Python
    over NJ, NV, size and the other constants."""
    m = re.search(rf"constexpr (?:int|bool) {name} =\s*([^;]+);", text)
    assert m, name
    return _c_to_python(m.group(1))


def _source_function(text, name, env):
    """``constexpr int <name>(int a, ...) { return <expression>; }`` of the
    source as a Python function over ``env`` (it may call itself and the
    other functions of ``env``)."""
    m = re.search(rf"constexpr int {name}\(([^)]*)\) \{{\s*return ([^;]+);",
                  text)
    assert m, name
    params = [p.split()[-1] for p in m.group(1).split(",")]
    body = _c_to_python(m.group(2))
    return lambda *args: eval(body, {}, {**env, **dict(zip(params, args))})


def _source_shape(text, widths, size, core, split=False):
    """{name: value} of ``kte_step.cu::StepShape`` for one instance (in the
    split mode where ``split``), evaluated from the source's own
    expressions."""
    env = {"NJ": widths[0], "NV": widths[1], "size": size, "kCoreOnly": core,
           "kSplit": split}
    for name in ("SLOTS", "STEP_THREADS", "TILE_THREADS", "STEP_SHARED",
                 "REG_WARPS_NARROW", "REG_WARPS_WIDE"):
        env[name] = eval(_source_constant(text, name), {}, dict(env))
    for name in ("warps_of", "tile_rows", "fit_tile"):
        env[name] = _source_function(text, name, env)
    for name in ("N", "COPIES", "TS0", "TS", "Q_WARPS", "NT", "QD_SLOT",
                 "PRIMAL_SLOT", "ROWS", "REG_WARPS",
                 "WANT_BLOCKS", "OUTER_SHARED", "SMEM", "MIN_BLOCKS"):
        env[name] = eval(_source_constant(text, name), {}, dict(env))
    return env


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("core", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("widths", [(6, 6), (2, 2), (8, 6), (8, 8), (1, 1),
                                    (9, 9), (16, 16), (16, 8)])
def test_launch_shape_mirrors_the_source(widths, dtype, core, split):
    """TS, threads, the primal slot, the blocks an SM and shared memory of
    ``launch_shape`` are what ``kte_step.cu::StepShape`` computes for the
    same instance, in either mode (the C entry point refuses a launch
    whose shared size differs), inside an H100 block: tiles of TS0 = 16
    scenarios unless the threads would pass ``TILE_THREADS`` or the rows
    ``STEP_SHARED``, which halves TS; the split mode's threads are twice
    the pair slots' warps (the q̇ directions on warps of their own) at one
    block an SM."""
    text = SOURCE.read_text()
    size = 4 if dtype == torch.float32 else 8
    env = _source_shape(text, widths, size, core, split)
    assert env["SLOTS"] == kte_step.SLOTS
    assert env["STEP_THREADS"] == kte_step.STEP_THREADS
    assert env["TILE_THREADS"] == kte_step.TILE_THREADS
    assert env["STEP_SHARED"] == kte_step.STEP_SHARED == _tile.MAX_SHARED_BYTES
    shape = kte_step.launch_shape(*widths, dtype, core=core, split=split)
    assert shape.widths == widths and not shape.runtime
    assert shape.split == split and env["COPIES"] == (2 if split else 1)
    if split:
        assert shape.blocks_per_sm == 1
        assert env["QD_SLOT"] * shape.scenarios == shape.threads // 2
    assert (shape.scenarios, shape.threads, shape.shared_bytes) == (
        env["TS"], env["NT"], env["SMEM"])
    assert (shape.primal_slot, shape.outer_shared, shape.blocks_per_sm) == (
        env["PRIMAL_SLOT"], env["OUTER_SHARED"], env["MIN_BLOCKS"])
    assert shape.threads <= kte_step.TILE_THREADS
    assert shape.threads <= 1024 == _tile.MAX_THREADS
    assert shape.shared_bytes * shape.blocks_per_sm <= 232448
    ts = shape.scenarios
    if ts < env["TS0"]:  # halved: twice the scenarios would not fit
        assert (env["COPIES"] * 32 * env["warps_of"](2 * ts * widths[1])
                > kte_step.TILE_THREADS
                or env["tile_rows"](*widths, core) * 2 * ts * size
                > kte_step.STEP_SHARED)
    assert (ts * size) % 16 == 0 or ts < 4
    assert shape.blocks(8192) * ts == 8192


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("widths", [(6, 6), (7, 7), (2, 2), (1, 1), (3, 3),
                                    (8, 6), (16, 16), (9, 9)])
def test_warp_roles(widths, dtype):
    """Every warp runs one kind of direction at a time: the block is nv
    pair slots of TS threads in whole warps, every slot inside one warp,
    the thread of slot j running the q direction j and then the q̇
    direction nv + j, so all lanes of a warp run q code, then q̇ code, and
    every warp carries the same work; only a spare slot, which runs the
    primal phase where a warp leaves one, differs.  No ``setmaxnreg``: no
    warpgroup has registers to give another."""
    shape = kte_step.launch_shape(*widths, dtype)
    nv = widths[1]
    ts = shape.scenarios
    assert shape.threads % 32 == 0
    assert 32 % ts == 0 or ts % 32 == 0
    assert shape.threads // ts >= nv > (shape.threads - 32) // ts
    slots = list(range(shape.threads // ts))
    pairs = [(j, nv + j) for j in slots if j < nv]
    assert sorted(d for p in pairs for d in p) == list(range(2 * nv))
    spare = shape.threads // ts > nv
    assert shape.primal_slot == (nv if spare else nv - 1)
    text = SOURCE.read_text()
    assert "regs_inc" not in text and "regs_dec" not in text


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("widths", [(6, 6), (7, 7), (2, 2), (1, 1), (3, 3),
                                    (8, 6), (13, 13), (16, 16)])
def test_split_mode_warp_roles(widths, dtype):
    """The split mode runs a thread a direction and still no warp on two
    kinds of direction: the q directions on the pair slots' warps (slot j:
    q direction j), the q̇ ones on as many warps after them (slot
    ``QD_SLOT`` + j: q̇ direction nv + j), every direction once; the primal
    phase on a spare slot of the q warps, or else on the last q̇ slot."""
    text = SOURCE.read_text()
    size = 4 if dtype == torch.float32 else 8
    env = _source_shape(text, widths, size, False, split=True)
    shape = kte_step.launch_shape(*widths, dtype, split=True)
    nv, ts = widths[1], shape.scenarios
    qd = env["QD_SLOT"]
    kind = {}
    for slot in range(shape.threads // ts):
        if slot < nv:
            kind[slot] = ("q", slot)
        elif qd <= slot < qd + nv:
            kind[slot] = ("qd", nv + slot - qd)
        else:
            kind[slot] = ("spare", None)
    dirs = sorted(d for k, d in kind.values() if k != "spare")
    assert dirs == list(range(2 * nv))
    for w in range(shape.threads // 32):
        kinds = {kind[t // ts][0] for t in range(32 * w, 32 * w + 32)}
        assert not {"q", "qd"} <= kinds, (w, kinds)
    assert kind[shape.primal_slot][0] == "spare" or \
        shape.primal_slot == qd + nv - 1
    assert shape.primal_slot == env["PRIMAL_SLOT"]


@pytest.mark.parametrize("widths,dtype", [
    ((6, 6), torch.float32), ((7, 7), torch.float32), ((6, 6), torch.float64),
    ((7, 7), torch.float64), ((2, 2), torch.float64), ((1, 1), torch.float64),
    ((3, 3), torch.float64), ((8, 6), torch.float64),
    ((16, 16), torch.float64)])
def test_blocks_an_sm_and_registers(widths, dtype):
    """The blocks an SM: as many as ``REG_WARPS_NARROW`` warps (f32, at
    most six joints) or ``REG_WARPS_WIDE`` warps allow, and their shared
    memory; the registers a thread are what that many warps leave of each
    scheduler's quarter of the SM's 65,536 (168 at twelve warps, 255 at
    eight)."""
    shape = kte_step.launch_shape(*widths, dtype)
    warps = shape.threads // 32
    narrow = dtype == torch.float32 and widths[0] <= 6
    reg_warps = kte_step.REG_WARPS_NARROW if narrow else \
        kte_step.REG_WARPS_WIDE
    want = max(1, reg_warps // warps)
    assert shape.blocks_per_sm == min(want, 232448 // shape.shared_bytes)
    on_sm = warps * shape.blocks_per_sm
    assert shape.registers == min(255, 16384 // (32 * -(-on_sm // 4)) // 8
                                  * 8)
    assert kte_step.registers_a_thread(384) == 168
    assert kte_step.registers_a_thread(256) == 255


@pytest.mark.parametrize("widths,dtype,shape", [
    ((6, 6), torch.float32, (16, 96)), ((6, 6), torch.float64, (16, 96)),
    ((2, 2), torch.float64, (16, 32)), ((8, 6), torch.float64, (16, 96)),
    ((7, 7), torch.float32, (16, 128))])
def test_shipped_instances_keep_their_launch_shape(widths, dtype, shape):
    """The instances the flagship arm, ``planar_2link``, the mixed chain
    and the SSRMS run take the scenarios and threads a block of the design
    of pair slots: a pair slot a dof, 16 scenarios a tile (the SSRMS's seven
    slots round up to four warps, the eighth slot spare)."""
    got = kte_step.launch_shape(*widths, dtype)
    assert (got.scenarios, got.threads) == shape


def test_source_constants_agree():
    """The widest compile-time instance, the thread caps, the shared cap,
    the knobs, the runtime instance's grid cap and the anchor slots of the
    source are the wrapper's, and the last slot ends where SLOTS says."""
    text = SOURCE.read_text()
    assert int(_source_constant(text, "UNROLLED_JOINTS")) == \
        kte_step.UNROLLED_JOINTS == 16
    assert int(_source_constant(text, "RT_GRID")) == kte_step.RT_GRID
    assert int(_source_constant(text, "STEP_THREADS")) == \
        kte_step.STEP_THREADS
    assert int(_source_constant(text, "TILE_THREADS")) == \
        kte_step.TILE_THREADS
    assert int(_source_constant(text, "REG_WARPS_NARROW")) == \
        kte_step.REG_WARPS_NARROW
    assert int(_source_constant(text, "REG_WARPS_WIDE")) == \
        kte_step.REG_WARPS_WIDE
    slots = dict(re.findall(r"(S_[A-Z]+) = (\d+)", text))
    assert int(slots["S_COM"]) + 3 == kte_step.SLOTS
    assert "__launch_bounds__" in text and "__grid_constant__" in text
    assert "use_fast_math" not in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize("B,blocks", [(1, 1), (16, 1), (77, 5), (1001, 63),
                                      (8192, 512)])
def test_ragged_batches_take_whole_tiles(B, blocks):
    assert kte_step.launch_shape(6, 6, torch.float32).blocks(B) == blocks


def test_shape_entry_reports_the_fields_in_order():
    """The library's ``shape`` entry point, which ``ops/kte_variants.py``
    reads a patched copy's launch shape from, writes ``StepShape``'s
    fields in the order of ``kte_step.SHAPE_FIELDS``."""
    text = SOURCE.read_text()
    m = re.search(r"int shape_of\(int\* out\) \{.*?\{([^}]*)\};", text,
                  flags=re.S)
    assert m
    fields = [f.strip().replace("Shape::", "") for f in m.group(1).split(",")]
    assert fields == ["TS", "NT", "SMEM", "PRIMAL_SLOT", "OUTER_SHARED",
                      "MIN_BLOCKS"]
    assert len(kte_step.SHAPE_FIELDS) == len(fields)
    assert kte_step.SHAPE_FIELDS[:3] == ("scenarios", "threads",
                                         "shared_bytes")
    assert kte_step.SHAPE_FIELDS[3:] == ("primal_slot", "outer_shared",
                                         "blocks_per_sm")


def test_variants_patch_every_knob(tmp_path, monkeypatch):
    """``ops/kte_variants.py`` reads the shipped knobs from the source (the
    TS ``launch_shape`` gives, the thread cap and the register warps) and
    each variant's patched copy reads back as that variant, whose
    ``StepShape`` at (6, 6) and (7, 7) takes the patched knobs and fits an
    H100 SM (no nvcc; the measurement reads each patched library's own
    shape)."""
    from reak_tpu_torch.ops import kte_variants

    base = kte_variants.shipped(SOURCE.read_text())
    assert base == {"ts": kte_step.launch_shape(6, 6, torch.float32).scenarios,
                    "tile_threads": kte_step.TILE_THREADS,
                    "narrow": kte_step.REG_WARPS_NARROW,
                    "wide": kte_step.REG_WARPS_WIDE}
    monkeypatch.setattr(kte_variants.subprocess, "Popen",
                        lambda *args, **kwargs: None)
    monkeypatch.setattr(kte_variants._build, "_nvcc", lambda: "nvcc")
    seen = set()
    for other in kte_variants.OTHERS:
        variant = {**base, **other}
        d, _, _ = kte_variants._variant(tmp_path, variant, base)
        text = (d / "kte_step.cu").read_text()
        assert kte_variants.shipped(text) == variant
        for nj in (6, 7):
            env = _source_shape(text, (nj, nj), 4, False)
            assert (env["TS0"], env["TILE_THREADS"], env["REG_WARPS"]) == (
                variant["ts"], variant["tile_threads"],
                variant["narrow"] if nj <= 6 else variant["wide"])
            assert env["NT"] <= env["TILE_THREADS"]
            assert env["SMEM"] * env["MIN_BLOCKS"] <= kte_step.STEP_SHARED
        seen.add(d.name)
    assert len(seen) == len(kte_variants.OTHERS)


def test_wrappers_take_the_one_launch_shape():
    for fn in (kte_step.make_step_lanes, kte_core.make_core_lanes):
        assert "launch(" in inspect.getsource(fn)
    src = inspect.getsource(kte_step.launch)
    assert "launch_shape(" in src and "chain_table(" in src
    assert "joint_table(" in src


# ---- the runtime-width instance ------------------------------------------

def _rt_expr(text, field):
    """``r.<field> = <expression>;`` of ``rt_shape`` as Python over nj, nv,
    r.n, core and the constants."""
    m = re.search(rf"r\.{field} =\s*([^;]+);", text)
    assert m, field
    expr = m.group(1).replace("r.", "r_")
    expr = re.sub(r"static_cast<long long>\((\w+)\)", r"\1", expr)
    return _c_to_python(expr)


@pytest.mark.parametrize("core", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("joints", [17, 24, 64])
def test_runtime_launch_shape_mirrors_the_source(joints, dtype, core):
    """Past 16 joints ``launch_shape`` is the runtime instance's: TS from a
    128 B row halved while TS × n passes the block's threads (down to 1), a
    thread taking every ``directions``-th direction, no shared memory, and
    a work area a block of the scenario rows and each (direction,
    scenario) slot's values — the sizes ``kte_step.cu::rt_shape``
    computes."""
    text = SOURCE.read_text()
    size = 4 if dtype == torch.float32 else 8
    shape = kte_step.launch_shape(joints, joints, dtype, core=core)
    assert shape.runtime and shape.widths == (joints, joints)
    assert shape.shared_bytes == 0
    assert 1 <= shape.scenarios and shape.threads <= kte_step.STEP_THREADS
    assert shape.threads == shape.scenarios * shape.directions <= 1024
    n = 2 * joints
    assert shape.directions == min(n, kte_step.STEP_THREADS // shape.scenarios)
    assert shape.scenarios == 1 or shape.scenarios * n <= kte_step.STEP_THREADS
    assert shape.scenarios * 2 * n > kte_step.STEP_THREADS or \
        shape.scenarios * size == 128
    env = {"nj": joints, "nv": joints, "r_n": n, "core": core,
           "SLOTS": kte_step.SLOTS, "size": size}
    env["r_chol_rows"] = eval(_rt_expr(text, "chol_rows"), {}, env)
    fk, series = 2 * kte_step.SLOTS * joints, (0 if core else
                                               joints * n + joints ** 2
                                               + n * n)
    env["r_rows"] = env["r_chol_rows"] + max(fk, series)
    env["r_dir_values"] = eval(_rt_expr(text, "dir_values"), {}, env)
    env["r_ts"] = shape.scenarios
    block = eval(_rt_expr(text, "block_values"), {}, env)
    assert block == shape.block_values
    assert shape.blocks(77) == -(-77 // shape.scenarios)
    assert shape.blocks(10 ** 6) == kte_step.RT_GRID
    assert shape.work_values(77) == shape.blocks(77) * block


# ---- libraries per chain ------------------------------------------------

@pytest.mark.parametrize("chain,widths", [
    (models.manip_3r3r, (6, 6)), (models.planar_2link, (2, 2)),
    (lambda: models.flexible_beam(9), (9, 9)),
    (lambda: models.flexible_beam(16), (16, 16))],
    ids=["manip_3r3r", "planar_2link", "flexible_beam_9", "flexible_beam_16"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_library_per_chain(chain, widths, dtype):
    spec = chain()
    assert kte_step.instance_for(spec) == widths
    suffix = "f32" if dtype == torch.float32 else "f64"
    name = kte_step.library(widths, dtype)
    assert name == f"kte_step@{widths[0]}x{widths[1]}_{suffix}"
    source, defines = _build._source_and_defines(name)
    assert source == SOURCE
    assert defines[:2] == [f"-DREAK_NMAX={widths[0]}",
                           f"-DREAK_MMAX={widths[1]}"]


def test_mixed_chain_runs_its_own_width():
    spec = convert.spec_from(_mixed_chain_jax())
    assert kte_step.instance_for(spec) == (8, 6)
    names = {kte_step.library(w, dt) for w in ((8, 6), (6, 6), (2, 2))
             for dt in DTYPES}
    assert len({_build.library_path(n) for n in names}) == 6


def _meta(*shape):
    """A device tensor that is not on the CPU and holds no data."""
    return torch.empty(shape, dtype=torch.float64, device="meta")


def test_chains_the_kernel_does_not_take_raise():
    """Only a chain with a free base is refused, at the first call on a
    device tensor (a meta tensor stands in for a CUDA one); a chain of more
    than 16 joints takes the runtime-width instance (fault F7 repaired).
    Building the wrappers, and the rollout and the MPC solver on top of
    them, raises nothing, and on CPU tensors they take the plain
    versions."""
    free = models.floating_arm()
    step = kte_step.make_step_lanes(free, 0.01)
    core = kte_core.make_core_lanes(free)
    x, u = _meta(2 * free.nv, 4), _meta(free.nv, 4)
    for fn in (step, core):
        with pytest.raises(NotImplementedError, match="fixed-base"):
            fn(x, u)
    roll = lanes.make_rollout_ltv_fullfused(free, 1e-2, 2)
    with pytest.raises(NotImplementedError, match="free base"):
        roll(_meta(4, 2 * free.nv), _meta(4, 2, free.nv))
    for joints in (17, 24, 64):
        beam = models.flexible_beam(joints)
        assert kte_step.instance_for(beam) is None
        for dtype in DTYPES:
            name = kte_step.library(None, dtype)
            assert name == f"kte_step@any_{kte_step.type_suffix(dtype)}"
            assert _build._source_and_defines(name)[1][0] == \
                "-DREAK_RUNTIME=1"


# ---- entry points and the table -------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("widths", [(6, 6), (2, 2), (8, 6), None])
def test_signatures_name_entry_points_of_the_source(widths, dtype):
    """Every function the two wrappers declare exists in ``kte_step.cu``
    (its entry macro expanded by hand), with as many arguments: the
    compile-time instances' and the runtime-width instance's
    (``widths=None``)."""
    text = SOURCE.read_text()
    suffix = "f32" if dtype == torch.float32 else "f64"
    fill = {"SUFFIX": suffix}
    if widths is not None:
        fill.update({"NJ": str(widths[0]), "NV": str(widths[1])})
    c_args = {}
    for macro_name in re.findall(r"^  int (reak_\w+(?:##\w+)+)\(", text,
                                 flags=re.M):
        if ("_any_##" in macro_name) != (widths is None):
            continue
        params = text[text.index(macro_name):]
        params = params[params.index("(") + 1:params.index(") {")]
        name = "".join(fill.get(t, t) for t in macro_name.split("##"))
        c_args[name] = [a for a in params.replace("\\", "").split(",")
                        if a.strip()]
    declared = kte_step.signatures(widths, dtype)
    assert set(declared) == set(c_args)
    for name, args in declared.items():
        assert len(args) == len(c_args[name]), name


@pytest.mark.parametrize("joints", [8, 16])
def test_table_by_value_fits_a_kernel_parameter(joints):
    """The kernel takes the chain table by value: at 8 joints in f64 it is
    8 × 27 + 3 values, at the cap of 16 joints 16 × 27 + 3, inside 4 KB."""
    spec = (convert.spec_from(_mixed_chain_jax()) if joints == 8
            else models.flexible_beam(joints))
    table = kte_step.chain_table(spec, "cpu", torch.float64)
    assert table.shape == (joints * 27 + 3,)
    assert table.numel() * table.element_size() <= 4096
    assert table.device.type == "cpu"


# ---- the plain versions on the mixed chain against JAX ---------------------

@pytest.fixture(scope="module")
def mixed_case():
    jspec_ = _mixed_chain_jax()
    spec = convert.spec_from(jspec_)
    rng = np.random.default_rng(11)
    x = _states(rng, spec.nv, 4)
    u = rng.uniform(-5.0, 5.0, (spec.nv, 4))
    return jspec_, spec, x, u


@pytest.fixture(scope="module")
def mixed_jax(mixed_case):
    """JAX's M (nv, nv, B), f (nv, B) and their tangents along each of the
    n unit state directions, dM (n, nv, nv, B) and df (n, nv, B): one
    ``jax.jvp`` of ``make_terms_lanes`` over the scenarios repeated n times,
    the copy d moving along direction d (the n pulls of
    ``make_rollout_ltv_lanes`` in one pass)."""
    jspec_, spec, x, _ = mixed_case
    nv, n, B = spec.nv, 2 * spec.nv, x.shape[1]
    terms = jlanes.make_terms_lanes(jspec_)
    tangent = np.repeat(np.eye(n), B, axis=1)  # column d·B + b: direction d
    (M, f), (dM, df) = jax.jvp(lambda xx: terms(xx[:nv], xx[nv:]),
                               (jnp.asarray(np.tile(x, (1, n))),),
                               (jnp.asarray(tangent),))
    M, f = np.asarray(M)[..., :B], np.asarray(f)[..., :B]
    dM = np.moveaxis(np.asarray(dM).reshape(nv, nv, n, B), 2, 0)
    df = np.moveaxis(np.asarray(df).reshape(nv, n, B), 1, 0)
    return M, f, dM, df


def _core_and_step_of(x, u, M, f, dM, df, dt, order=4):
    """q̈, ∂q̈/∂x, M⁻¹ from (M, f) and their tangents, and the step of
    ``make_rollout_ltv_lanes`` on them (its exponential series), per
    scenario in numpy."""
    nv, B = f.shape
    n = 2 * nv
    qdd, dqdd, minv = (np.empty((nv, B)), np.empty((nv, n, B)),
                       np.empty((nv, nv, B)))
    Ad, Bd, cd, xn = (np.empty((n, n, B)), np.empty((n, nv, B)),
                      np.empty((n, B)), np.empty((n, B)))
    for b in range(B):
        Mb = M[:, :, b]
        qdd[:, b] = np.linalg.solve(Mb, f[:, b] + u[:, b])
        rhs = df[:, :, b].T - np.einsum("dkl,l->kd", dM[..., b], qdd[:, b])
        dqdd[:, :, b] = np.linalg.solve(Mb, rhs)
        minv[:, :, b] = np.linalg.inv(Mb)
        A = np.zeros((n, n))
        A[:nv, nv:] = np.eye(nv)
        A[nv:] = dqdd[:, :, b]
        Bc = np.concatenate([np.zeros((nv, nv)), minv[:, :, b]])
        S = term = np.eye(n) * dt
        for k in range(2, order + 1):
            term = (dt / k) * A @ term
            S = S + term
        Ad[:, :, b] = np.eye(n) + A @ S
        Bd[:, :, b] = S @ Bc
        xn[:, b] = x[:, b] + S @ np.concatenate([x[nv:, b], qdd[:, b]])
        cd[:, b] = xn[:, b] - Ad[:, :, b] @ x[:, b] - Bd[:, :, b] @ u[:, b]
    return (qdd, dqdd, minv), (Ad, Bd, cd, xn)


def test_mixed_chain_converts_exactly(mixed_case):
    """``convert.spec_from`` carries the JAX spec across unchanged, and it
    is the port's ``models.mixed_chain``, which ``chip_smoke.py`` checks."""
    jspec_, spec, _, _ = mixed_case
    assert spec.joint_types == tuple(int(t) for t in jspec_.joint_types)
    assert spec.nv == 6 and spec.n_joints == 8
    own = models.mixed_chain()
    assert own.joint_types == spec.joint_types
    for field in ("axes", "offsets_pos", "offsets_quat", "com_pos", "masses",
                  "inertias", "stiffness", "rest_q", "damping", "gravity"):
        np.testing.assert_array_equal(np.asarray(getattr(spec, field)),
                                      np.asarray(getattr(jspec_, field)))
        np.testing.assert_array_equal(np.asarray(getattr(own, field)),
                                      np.asarray(getattr(spec, field)))


def test_mixed_chain_terms_match_jax(mixed_case, mixed_jax):
    _, spec, x, _ = mixed_case
    nv = spec.nv
    M_t, f_t = lanes.make_terms_lanes(spec)(torch.as_tensor(x[:nv]),
                                            torch.as_tensor(x[nv:]))
    _assert_rel(M_t, mixed_jax[0])
    _assert_rel(f_t, mixed_jax[1])


def test_mixed_chain_step_matches_jax(mixed_case, mixed_jax):
    """The plain core of K5 and the plain step of K1 against JAX's terms
    and their linearization taken through ``make_rollout_ltv_lanes``' step
    (the solves and the series in numpy); on CPU tensors both wrappers are
    those plain versions and count no launch."""
    _, spec, x, u = mixed_case
    core_j, step_j = _core_and_step_of(x, u, *mixed_jax, 0.01)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    before = (kte_step.launches, kte_core.launches)
    step = kte_step.make_step_lanes(spec, 0.01)(xt, ut)
    core = kte_core.make_core_lanes(spec)(xt, ut)
    assert (kte_step.launches, kte_core.launches) == before
    for got, want in zip(core, core_j):
        _assert_rel(got, want)
    for got, want in zip(step, step_j):
        _assert_rel(got, want)


def test_phase_stamps_fit_the_source(tmp_path):
    """``ops/k1_phases.py`` builds K1/K5 with its stamps: the source calls
    only the hooks the stamps define, empty unless they are inserted, each
    slot of ``NEW_SLOTS`` once in its order, within the stamps' slots and
    recorders (a recorder a pair slot, and the primal slot); the stamped
    copy of the shipped source takes the new design's slots and defines
    the hooks before the source's first include (no nvcc)."""
    from reak_tpu_torch.ops import k1_phases

    text = SOURCE.read_text()
    hooks = set(re.findall(r"\b(REAK_K1_\w+)\(", text))
    assert hooks == {"REAK_K1_BEGIN", "REAK_K1_STAMP", "REAK_K1_END"}
    for hook in hooks:
        assert f"#define {hook}(" in text
        assert f"#define {hook}(" in k1_phases.STAMPS
    stamps = [int(s) for s in re.findall(r"REAK_K1_STAMP\((\d+)\);", text)]
    assert stamps == list(range(len(k1_phases.NEW_SLOTS)))
    cap = lambda name: int(re.search(rf"#define {name} (\d+)",
                                     k1_phases.STAMPS).group(1))
    assert len(k1_phases.NEW_SLOTS) <= cap("REAK_K1_SLOTS")
    widest = kte_step.launch_shape(16, 16, torch.float64)
    assert widest.threads // widest.scenarios <= cap("REAK_K1_WHO")
    slots = k1_phases.stamped_source(_build.CSRC, tmp_path / "csrc")
    assert slots == k1_phases.NEW_SLOTS
    stamped = (tmp_path / "csrc" / "kte_step.cu").read_text()
    at = stamped.index("#define REAK_K1_STAMPS 1")
    assert stamped.index("#define REAK_K1_STAMP(slot)") < at
    assert at < stamped.index('#include "hyperdual.cuh"')
    assert stamped.count("reak_k1_stamps_read") == 1
    assert (tmp_path / "csrc" / "hyperdual.cuh").exists()
