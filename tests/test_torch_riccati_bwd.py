"""The port's per-pass PDIP (reak_tpu_torch.ops.riccati_bwd and the plain
passes of reak_tpu_torch.ctrl.riccati_soa) against the JAX package's
per-pass Pallas kernels (reak_tpu/ops/riccati_bwd_pallas.py) run in
interpret mode, on the same numpy inputs at f64 — monkeypatching as in
tests/test_riccati_soa.py::test_pdip_pallas_pass_kernels_match_scan.

Bars: each plain pass ≤1e-12 absolute against its JAX kernel; the whole
``use_kernels="passes"`` solve ≤1e-10 against the JAX solver on its
per-pass kernels, in the regulator, x_ref and x_ref + u_ref modes, and
≤1e-12 against the port's own plain scan."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reak_tpu_torch.ctrl import riccati_soa
from reak_tpu_torch.ops import pdip_whole, riccati_bwd

torch.set_num_threads(1)

H, N, M, B = 6, 4, 2, 4
MODES = {"regulator": (), "x_ref": ("x_ref",), "x_ref+u_ref": ("x_ref",
                                                               "u_ref")}


@pytest.fixture
def rbp(monkeypatch):
    """The JAX package's per-pass kernels in interpret mode at tile 2."""
    import reak_tpu.ops.riccati_bwd_pallas as rbp

    monkeypatch.setattr(rbp, "_TILE", 2)
    monkeypatch.setattr(rbp, "FORCE_INTERPRET", True)
    return rbp


def _problem(rng):
    return dict(
        A=rng.standard_normal((H, N, N, B)) * 0.1 + np.eye(N)[None, :, :, None],
        Bm=rng.standard_normal((H, N, M, B)) * 0.2,
        c=rng.standard_normal((H, N, B)) * 0.05,
        x0=rng.standard_normal((N, B)),
        Q=np.eye(N), QN=np.eye(N) * 5.0, R=np.eye(M) * 0.1,
        lb=np.full(M, -1.5), ub=np.full(M, 1.5),
        x_ref=rng.standard_normal((H, N, B)) * 0.1,
        u_ref=rng.standard_normal((H, M, B)) * 0.1)


def _pass_inputs(rng):
    """Inputs of the three passes: stage costs q, inputs u_eff, a positive
    barrier diagonal D, and (K, G) from the plain fused backward pass."""
    p = _problem(rng)
    bwd = dict(A=p["A"], Bm=p["Bm"], q=rng.standard_normal((H, N, B)),
               u_eff=rng.standard_normal((H, M, B)),
               D=rng.uniform(0.5, 2.0, (H, M, B)), Q=p["Q"], QN=p["QN"],
               R=p["R"])
    t = {k: torch.as_tensor(v) for k, v in bwd.items()}
    _, K, G, _ = riccati_soa.fused_backward_plain(*t.values())
    vec = dict(A=p["A"], Bm=p["Bm"], rhs=rng.standard_normal((H, M, B)),
               K=K.numpy(), G=G.numpy())
    fwd = dict(A=p["A"], Bm=p["Bm"], K=K.numpy(),
               k=rng.standard_normal((H, M, B)), dx0=rng.standard_normal((N,
                                                                          B)))
    return {"fused_backward": bwd, "vector_backward": vec, "forward": fwd}


PLAIN = {"fused_backward": riccati_soa.fused_backward_plain,
         "vector_backward": riccati_soa.vector_backward_plain,
         "forward": riccati_soa.forward_plain}


@pytest.mark.parametrize("name", list(PLAIN))
def test_plain_pass_matches_jax_kernel(rng, rbp, name):
    """Each plain pass against the per-pass Pallas kernel with its contract
    (K4a make_fused_backward, K4b make_vector_backward, K4c make_forward)."""
    make = {"fused_backward": rbp.make_fused_backward,
            "vector_backward": rbp.make_vector_backward,
            "forward": rbp.make_forward}[name]
    inputs = _pass_inputs(rng)[name]
    want = make(H, N, M, tile=2, interpret=True)(
        *(jnp.asarray(v) for v in inputs.values()))
    got = PLAIN[name](*(torch.as_tensor(v) for v in inputs.values()))
    if name == "vector_backward":
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= 1e-12


@pytest.mark.parametrize("mode", list(MODES))
def test_passes_solve_matches_jax_per_pass_kernels(rng, rbp, mode):
    from reak_tpu.ctrl.riccati_soa import \
        solve_box_mpc_riccati_soa_fused as jax_fused

    p = _problem(rng)
    keys = ("A", "Bm", "c", "Q", "QN", "R", "x0", "lb", "ub")
    refs = MODES[mode]
    u_j, x_j = jax_fused(*(jnp.asarray(p[k]) for k in keys), iters=6,
                         use_kernels="passes",
                         **{k: jnp.asarray(p[k]) for k in refs})
    args = [torch.as_tensor(p[k]) for k in keys]
    kw = {k: torch.as_tensor(p[k]) for k in refs}
    before = dict(riccati_bwd.launches)
    u_t, x_t = riccati_soa.solve_box_mpc_riccati_soa_fused(
        *args, iters=6, use_kernels="passes", **kw)
    assert riccati_bwd.launches == before
    assert np.max(np.abs(u_t.numpy() - np.asarray(u_j))) <= 1e-10
    assert np.max(np.abs(x_t.numpy() - np.asarray(x_j))) <= 1e-10
    assert np.any(np.abs(u_t.numpy()) > 1.5 - 1e-6)  # an active bound
    u_n, x_n = riccati_soa.solve_box_mpc_riccati_soa_fused(
        *args, iters=6, use_kernels="never", **kw)
    assert float((u_t - u_n).abs().max()) <= 1e-12
    assert float((x_t - x_n).abs().max()) <= 1e-12


@pytest.mark.parametrize("name", list(PLAIN))
def test_wrapper_takes_plain_pass_on_cpu(rng, name):
    """On CPU tensors each wrapper is its plain pass, and no launch is
    counted."""
    inputs = [torch.as_tensor(v) for v in _pass_inputs(rng)[name].values()]
    before = dict(riccati_bwd.launches)
    got = getattr(riccati_bwd, name)(*inputs)
    want = PLAIN[name](*inputs)
    if name == "vector_backward":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert riccati_bwd.launches == before


def test_every_pass_is_built_for_the_whole_solve_bounds():
    """Three passes × the (16, 8), (24, 12) and (32, 16) instances and the
    runtime-width one × f32 and f64; beyond (32, 16) the per-pass kernels
    take the runtime-width instance (fault F7 repaired)."""
    assert len(riccati_bwd.SIGNATURES) == \
        3 * (len(pdip_whole.INSTANCES) + 1) * 2
    assert pdip_whole.INSTANCES[-1] == (32, 16)
    for name in PLAIN:
        for bound in (*pdip_whole.INSTANCES, None):
            for dtype in (torch.float32, torch.float64):
                assert riccati_bwd.entry_point(name, bound, dtype) \
                    in riccati_bwd.SIGNATURES
    assert pdip_whole.instance_for(25, 6) == (32, 16)
    assert pdip_whole.instance_for(33, 6, what="the per-pass kernels") is None
    with pytest.raises(ValueError, match="per-pass"):
        pdip_whole.instance_for(0, 6, what="the per-pass kernels")


@pytest.mark.parametrize("name", list(PLAIN))
def test_wrappers_leave_their_inputs_unchanged(rng, rbp, name):
    """The wrappers are pure, as the JAX functions are: the solver hands the
    vector pass its right-hand sides and the forward pass its gains k and
    reads them again.  On CPU tensors each wrapper returns what the JAX
    kernel returns (the forward pass from a nonzero dx0) and leaves every
    input as it was."""
    make = {"fused_backward": rbp.make_fused_backward,
            "vector_backward": rbp.make_vector_backward,
            "forward": rbp.make_forward}[name]
    inputs = _pass_inputs(rng)[name]
    if name == "forward":
        assert np.all(inputs["dx0"] != 0.0)
    want = make(H, N, M, tile=2, interpret=True)(
        *(jnp.asarray(v) for v in inputs.values()))
    args = [torch.as_tensor(v) for v in inputs.values()]
    before = [a.clone() for a in args]
    got = getattr(riccati_bwd, name)(*args)
    if name == "vector_backward":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= 1e-12
    for a, b in zip(args, before):
        assert torch.equal(a, b)


def test_unknown_kernel_choice_raises(rng):
    p = _problem(rng)
    args = [torch.as_tensor(p[k]) for k in ("A", "Bm", "c", "Q", "QN", "R",
                                            "x0", "lb", "ub")]
    with pytest.raises(ValueError, match="use_kernels"):
        riccati_soa.solve_box_mpc_riccati_soa_fused(*args,
                                                    use_kernels="pass")
