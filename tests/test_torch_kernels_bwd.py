"""The port's learner kernels against the JAX package's Pallas kernels, on
the CPU: the flash-attention backward, the reverse discounted scan and the
RMSNorm gradient.

The port's wrappers run their plain PyTorch versions here; the JAX side runs
its Pallas kernels in interpret mode, called directly (the JAX jit cache
ignores `repro`'s dispatch mode). Inputs are made from a seed with numpy and
handed to both. Tolerances: 1e-4 on gradients and 2e-5 on fp32 forwards,
as tests/test_kernels.py; 2e-2 on bf16.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
(marked `cuda`) and chip_smoke.py hold them against these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import (
    flash_attention_bwd_dkv as jax_bwd_dkv,
    flash_attention_bwd_dq as jax_bwd_dq,
    flash_attention_bwd_preprocess as jax_bwd_preprocess,
    flash_attention_fwd as jax_flash_fwd,
)
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.kernels.vtrace_scan.ops import reverse_discounted_scan as jax_scan
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ops import (
    dkv_design,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_preprocess_ref,
    attention_bwd_ref,
)
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.vtrace_scan.ops import (
    reverse_discounted_scan,
    reverse_discounted_scan_p,
)
from repro_torch.kernels.vtrace_scan.ref import reverse_discounted_scan_ref

GRAD_TOL = 1e-4
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same values as a jax array and a torch tensor of `dtype`."""
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


# -- the plain backward against the three Pallas backward kernels -----------------

# B, H, KV, T (true), Tpad, d, block, causal, window, cap
BWD_KERNEL_CASES = [
    (2, 4, 2, 37, 48, 32, 16, True, 0, 0.0),      # odd T (padded rows), G=2
    (1, 2, 2, 32, 32, 16, 16, False, 0, 0.0),     # bidirectional, G=1
    (1, 4, 1, 40, 48, 16, 16, True, 8, 30.0),     # window + softcap, G=4
    (1, 6, 2, 32, 32, 8, 16, True, 12, 0.0),      # window, G=3
]


@pytest.mark.parametrize("B,H,KV,T,Tp,d,blk,causal,window,cap", BWD_KERNEL_CASES)
def test_attention_bwd_ref_matches_pallas_bwd_kernels(B, H, KV, T, Tp, d, blk, causal,
                                                      window, cap):
    """delta against `flash_attention_bwd_preprocess`, dq against
    `flash_attention_bwd_dq` and dk/dv against `flash_attention_bwd_dkv`
    summed over each KV head's query heads, from the same o, lse and dO.
    Inputs are zero-padded to the Pallas block as `repro`'s ops.py pads;
    rows past the true T are compared for dk/dv only (dO is zero there).
    The port's dq wrapper returns delta too (its kernel computes it in the
    prologue): on the CPU it is the plain preprocess, equal to the JAX one."""
    rng = np.random.default_rng(10)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Tp, d), (B, KV, Tp, d), (B, KV, Tp, d), (B, H, Tp, d))]
    for a in arrs:
        a[:, :, T:] = 0.0
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = (_pair(a) for a in arrs)
    scale = d ** -0.5
    kw = dict(scale=scale, causal=causal, window=window, cap=cap)
    oj, lj = jax_flash_fwd(qj, kj, vj, **kw, block_q=blk, block_k=blk, kv_len=T,
                           interpret=True)
    delta_j = jax_bwd_preprocess(oj, gj, block_q=blk, interpret=True)
    pk = dict(**kw, block_q=blk, block_k=blk, kv_len=T, interpret=True)
    dq_j = jax_bwd_dq(qj, kj, vj, gj, lj, delta_j, **pk)
    dkh, dvh = jax_bwd_dkv(qj, kj, vj, gj, lj, delta_j, **pk)
    G = H // KV
    dk_j = dkh.reshape(B, KV, G, Tp, d).sum(2)
    dv_j = dvh.reshape(B, KV, G, Tp, d).sum(2)

    ot, lt = torch.tensor(np.asarray(oj)), torch.tensor(np.asarray(lj))
    delta, dq, dk, dv = attention_bwd_ref(qt, kt, vt, ot, lt, gt, **kw, kv_len=T)
    _close(delta, delta_j, TOL["float32"])
    _close(dq[:, :, :T], dq_j[:, :, :T], GRAD_TOL)
    _close(dk, dk_j, GRAD_TOL)
    _close(dv, dv_j, GRAD_TOL)
    # the two wrappers' CPU paths are the same plain version
    dq2, delta2 = flash_attention_bwd_dq(qt, kt, vt, ot, gt, lt, **kw, kv_len=T)
    assert torch.equal(delta2, attention_bwd_preprocess_ref(ot, gt))
    assert torch.equal(delta2, delta) and torch.equal(dq2, dq)
    _close(delta2, delta_j, TOL["float32"])
    dk2, dv2 = flash_attention_bwd_dkv(qt, kt, vt, gt, lt, delta, **kw, kv_len=T)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


def test_attention_bwd_ref_zeroes_rows_without_live_keys():
    """A row with no live key has lse = 0 from the port's forward; the
    explicit mask, not exp(NEG_INF - lse), gives it p = 0 and ds = 0."""
    rng = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((1, 2, 12, 16), (1, 1, 12, 16), (1, 1, 12, 16), (1, 2, 12, 16)))
    kw = dict(scale=2.0, causal=True, window=2)
    lse = torch.zeros(1, 2, 12)
    o = torch.zeros(1, 2, 12, 16)
    _, dq, dk, dv = attention_bwd_ref(q, k, v, o, lse, g, **kw, kv_len=4)
    assert torch.isfinite(dq).all() and (dq[:, :, 5:] == 0).all()   # rows 5.. see no key < 4
    assert (dk[:, :, 4:] == 0).all() and (dv[:, :, 4:] == 0).all()  # keys past kv_len


# -- the differentiable flash attention against repro's custom_vjp -----------------

# B, H, KV, T, d, window, cap, dtype: the grid of tests/test_kernels.py:275-340
VJP_CASES = [
    (1, 3, 1, 37, 16, 16, 30.0, "float32"),     # odd T, odd head count, G=3
    (2, 8, 2, 100, 24, 16, 30.0, "float32"),    # G=4, T % block != 0
    (1, 4, 4, 52, 16, 16, 30.0, "float32"),     # MHA, G=1
    (1, 6, 3, 33, 8, 16, 30.0, "float32"),      # G=2, tiny d
    (2, 4, 2, 96, 32, 0, 0.0, "float32"),       # plain causal
    (2, 4, 2, 96, 32, 16, 0.0, "float32"),      # window
    (2, 4, 2, 96, 32, 0, 25.0, "float32"),      # softcap
    (2, 4, 2, 96, 32, 24, 40.0, "float32"),     # window + softcap
    (1, 4, 2, 64, 32, 16, 30.0, "bfloat16"),    # bf16 primals
]


@pytest.mark.parametrize("B,H,KV,T,d,window,cap,dtype", VJP_CASES)
def test_flash_attention_grads_match_repro_custom_vjp(B, H, KV, T, d, window, cap, dtype):
    rng = np.random.default_rng(12)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, T, d), (B, KV, T, d), (B, KV, T, d), (B, H, T, d))]
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = (_pair(a, dtype) for a in arrs)
    scale = d ** -0.5
    f = lambda q, k, v: jax_flash_attention(q, k, v, scale, True, window, cap, 32, 32, True)
    oj, vjp = jax.vjp(f, qj, kj, vj)
    grads_j = vjp(gj)
    qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
    ot = flash_attention(qt, kt, vt, scale=scale, causal=True, window=window, cap=cap)
    grads_t = torch.autograd.grad(ot, (qt, kt, vt), gt)
    tol = TOL[dtype]
    _close(ot, oj, tol)
    for a, b in zip(grads_t, grads_j):
        assert a.dtype == TDT[dtype]
        _close(a, b, GRAD_TOL if dtype == "float32" else tol)


def test_flash_attention_grads_through_the_model_layout():
    """Strided (B, T, H, d) views, as models/attention.py passes them, give
    the grads of contiguous inputs, back in the model's layout."""
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
               for s in ((2, 9, 4, 32), (2, 9, 2, 32), (2, 9, 2, 32)))
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=0.3)
    gq, gk, gv = torch.autograd.grad(o.transpose(1, 2).square().sum(), (q, k, v))
    qc, kc, vc = (t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    oc = flash_attention(qc, kc, vc, scale=0.3)
    rq, rk, rv = torch.autograd.grad(oc.square().sum(), (qc, kc, vc))
    assert gq.shape == q.shape
    for a, b in ((gq, rq), (gk, rk), (gv, rv)):
        assert torch.equal(a, b.transpose(1, 2))


def test_flash_bwd_wrappers_reject_bad_inputs():
    q, k = torch.zeros(1, 4, 8, 32), torch.zeros(1, 2, 8, 32)
    lse, delta = torch.zeros(1, 4, 8), torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):                     # dO does not match q
        flash_attention_bwd_dq(q, k, k, q[:, :, :4], q[:, :, :4], lse, scale=1.0)
    with pytest.raises(ValueError):                     # lse in the wrong dtype
        flash_attention_bwd_dkv(q, k, k, q, lse.double(), delta, scale=1.0)
    with pytest.raises(ValueError):                     # o and dO differ
        flash_attention_bwd_dq(q, k, k, q, q.to(torch.bfloat16), lse, scale=1.0)


def test_flash_bwd_delta_for_keyless_rows_and_an_empty_q_tile():
    """With kv_len 40 and window 8, positions from 47 on have no live key,
    and positions 64..95 of G = 2 heads fill a whole 64-row tile of the dq
    kernel that sweeps no KV tile. `flash_attention_bwd` is
    `attention_bwd_ref` on the CPU, and the dq wrapper's delta, which dk/dv
    read, is rowsum(dO * O) on every row, keyless ones included."""
    rng = np.random.default_rng(18)
    B, H, KV, T, d = 1, 4, 2, 100, 32
    q, o, g = (torch.from_numpy(rng.standard_normal((B, H, T, d)).astype(np.float32))
               for _ in range(3))
    k, v = (torch.from_numpy(rng.standard_normal((B, KV, T, d)).astype(np.float32))
            for _ in range(2))
    lse = torch.from_numpy(rng.standard_normal((B, H, T)).astype(np.float32))
    kw = dict(scale=d ** -0.5, causal=True, window=8, cap=30.0, kv_len=40)
    want = attention_bwd_ref(q, k, v, o, lse, g, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, g, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want[1:]))
    dq, delta = flash_attention_bwd_dq(q, k, v, o, g, lse, **kw)
    assert delta.shape == (B, H, T) and delta.dtype == torch.float32
    assert torch.equal(delta, want[0]) and torch.equal(delta, (o * g).sum(-1))
    assert (delta[:, :, 47:] != 0).all()                 # keyless rows get their delta too
    assert (dq[:, :, 47:] == 0).all() and torch.isfinite(dq).all()
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw)
    assert torch.equal(dk, want[2]) and torch.equal(dv, want[3])


def test_flash_bwd_cpu_calls_launch_nothing():
    counters = (flash_attention_bwd_dq, flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    q = torch.ones(1, 2, 4, 32)
    flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 4), q, scale=1.0)
    assert [c.launches for c in counters] == before


# B, H, KV, Tk, d, dv, dtype -> the dk/dv kernel `dkv_design` picks
DKV_ROUTES = [
    ((1, 64, 64, 8192, 192, 128, torch.bfloat16), "wgmma"),    # kimi's MLA cell
    ((1, 96, 8, 8192, 128, 128, torch.bfloat16), "wgmma"),     # mistral-large b1, G = 12
    ((4, 96, 8, 2048, 128, 128, torch.bfloat16), "wgmma"),     # mistral-large b4
    ((1, 64, 4, 4096, 128, 128, torch.bfloat16), "wgmma"),     # qwen3-moe, G = 16
    ((2, 64, 8, 128, 128, 128, torch.bfloat16), "wgmma"),      # one whole key tile
    ((1, 64, 1, 1030, 128, 128, torch.bfloat16), "wgmma"),     # G = 64: one position a tile
    ((1, 8, 8, 300, 192, 128, torch.bfloat16), "wgmma"),
    ((1, 32, 1, 300, 192, 128, torch.bfloat16), "wgmma"),      # G = 32: one position a tile
    ((1, 64, 1, 300, 192, 128, torch.bfloat16), "mma_sync"),   # G = 64 at d 192: none
    ((1, 128, 1, 4096, 128, 128, torch.bfloat16), "mma_sync"),  # G = 128: no position fits
    ((2, 64, 8, 127, 128, 128, torch.bfloat16), "mma_sync"),   # Tk below a key tile
    ((512, 4, 2, 26, 128, 128, torch.bfloat16), "mma_sync"),   # an env step's T = 26
    ((2, 4, 1, 77, 192, 128, torch.bfloat16), "mma_sync"),
    ((1, 4, 2, 4096, 32, 32, torch.bfloat16), "mma_sync"),     # the league's policies
    ((512, 4, 2, 26, 32, 32, torch.bfloat16), "mma_sync"),
    ((1, 25, 5, 4096, 64, 64, torch.bfloat16), "mma_sync"),    # hymba
    ((1, 16, 16, 4096, 80, 80, torch.bfloat16), "mma_sync"),   # hubert
    ((1, 8, 2, 4096, 256, 256, torch.bfloat16), "mma_sync"),
    ((1, 4, 2, 4096, 32, 32, torch.float32), "mma_sync"),      # fp32 learners
    ((1, 16, 1, 4096, 128, 128, torch.float32), "mma_sync"),
]


@pytest.mark.parametrize("shape,design", DKV_ROUTES)
def test_dkv_design_routes_by_shape_and_dtype(shape, design):
    """The warpgroup-MMA dk/dv kernel takes bf16 at (128, 128) and (192,
    128) once Tk holds a 128-key tile and a tile of stacked rows (64 at d
    128, 32 at d 192) holds a position of the group; every other input
    keeps the mma.sync and fp32 kernels. The
    rule reads shapes and dtype only, so meta tensors answer it, and a
    meta call checks the inputs and launches nothing."""
    B, H, KV, Tk, d, dv, dtype = shape
    q = torch.empty(B, H, Tk, d, dtype=dtype, device="meta")
    k = torch.empty(B, KV, Tk, d, dtype=dtype, device="meta")
    v = torch.empty(B, KV, Tk, dv, dtype=dtype, device="meta")
    assert dkv_design(q, k, v) == design
    # the model's (B, T, H, d) layout answers the same
    assert dkv_design(*(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))) == design
    before = (flash_attention_bwd_dkv.launches, dict(flash_attention_bwd_dkv.design_launches))
    stats = torch.empty(B, H, Tk, device="meta")
    dk, dvg = flash_attention_bwd_dkv(q, k, v, torch.empty(B, H, Tk, dv, dtype=dtype, device="meta"),
                                      stats, stats, scale=d ** -0.5)
    assert dk.shape == k.shape and dvg.shape == v.shape
    assert (flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dkv.design_launches) == before


@pytest.mark.parametrize("d,dv,T", [(128, 128, 130), (192, 128, 128), (128, 128, 40)])
def test_flash_bwd_dkv_cpu_calls_move_no_design_count(d, dv, T):
    """On the CPU the plain version runs whichever kernel the rule would
    pick on the card, and neither `.launches` nor a design's count moves."""
    rng = np.random.default_rng(32)
    q, do = (torch.from_numpy(rng.standard_normal((1, 4, T, w)).astype(np.float32))
             .to(torch.bfloat16) for w in (d, dv))
    k = torch.from_numpy(rng.standard_normal((1, 2, T, d)).astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((1, 2, T, dv)).astype(np.float32)).to(torch.bfloat16)
    lse = torch.from_numpy(rng.standard_normal((1, 4, T)).astype(np.float32))
    assert dkv_design(q, k, v) == ("wgmma" if T >= 128 else "mma_sync")
    before = (flash_attention_bwd_dkv.launches, dict(flash_attention_bwd_dkv.design_launches))
    dk, dvg = flash_attention_bwd_dkv(q, k, v, do, lse, lse, scale=d ** -0.5)
    assert dk.shape == k.shape and dvg.shape == v.shape and torch.isfinite(dk.float()).all()
    assert (flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dkv.design_launches) == before


# -- the reverse scan ---------------------------------------------------------------

@pytest.mark.parametrize("B,T,dtype", [(32, 16, "float32"), (1, 300, "float32"),
                                       (13, 100, "float32"), (4, 40, "bfloat16"),
                                       (5, 1, "float32"), (2, 4097, "float32"),
                                       (3, 4096, "bfloat16"), (7, 1, "bfloat16")])
def test_reverse_scan_matches_pallas_interpret(B, T, dtype):
    rng = np.random.default_rng(14)
    dj, dt = _pair(rng.standard_normal((B, T)).astype(np.float32), dtype)
    cj, ct = _pair((rng.random((B, T)) * 0.99).astype(np.float32), dtype)
    ij, it = _pair(rng.standard_normal(B).astype(np.float32))
    yj = jax_scan(dj, cj, ij, interpret=True)
    yt = reverse_discounted_scan_p(dt, ct, it)
    assert yt.dtype == torch.float32 and yt.shape == (B, T)
    _close(yt, yj, TOL["float32"])
    assert torch.equal(reverse_discounted_scan_ref(dt, ct, it), yt)


@pytest.mark.parametrize("B,T,dtype", [(8, 64, "float32"), (5, 33, "float32"),
                                       (4, 40, "bfloat16"), (5, 1, "float32"),
                                       (2, 4097, "float32"), (3, 4097, "bfloat16")])
def test_reverse_scan_closed_form_grads_match_repro(B, T, dtype):
    """The cases of tests/test_kernels.py::test_reverse_scan_closed_form_grads:
    the port's closed-form backward against `repro`'s (interpret mode), with
    each grad in its primal's dtype."""
    rng = np.random.default_rng(15)
    dj, dt = _pair(rng.standard_normal((B, T)).astype(np.float32), dtype)
    cj, ct = _pair((rng.random((B, T)) * 0.95).astype(np.float32), dtype)
    ij, it = _pair(rng.standard_normal(B).astype(np.float32))
    g = rng.standard_normal((B, T)).astype(np.float32)
    loss = lambda d, c, i: jnp.sum(jax_scan(d, c, i, interpret=True) * jnp.asarray(g))
    grads_j = jax.grad(loss, argnums=(0, 1, 2))(dj, cj, ij)
    dt, ct, it = (t.requires_grad_() for t in (dt, ct, it))
    y = reverse_discounted_scan(dt, ct, it)
    grads_t = torch.autograd.grad((y * torch.from_numpy(g)).sum(), (dt, ct, it))
    tol = 1e-5 if dtype == "float32" else TOL["bfloat16"]
    for a, b in zip(grads_t, grads_j):
        assert a.dtype == (TDT[dtype] if a.dim() == 2 else torch.float32)
        _close(a, b, tol)


def test_reverse_scan_default_init_and_counts():
    dispatch.stats(reset=True)
    before = reverse_discounted_scan_p.launches
    d = torch.ones(3, 5)
    y = dispatch.reverse_scan(d, torch.full((3, 5), 0.5))
    assert torch.allclose(y[:, 0], torch.full((3,), 2.0 - 0.5 ** 4))
    assert dispatch.stats(reset=True) == {"reverse_scan|reference": 1}
    assert reverse_discounted_scan_p.launches == before          # CPU: no launch


def test_reverse_scan_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        reverse_discounted_scan_p(torch.zeros(2, 4), torch.zeros(2, 5), torch.zeros(2))
    with pytest.raises(ValueError):
        reverse_discounted_scan_p(torch.zeros(2, 4), torch.zeros(2, 4), torch.zeros(3))


# -- RMSNorm gradients ---------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((8, 128), "float32"), ((3, 7, 96), "float32"),
                                         ((4, 5, 64), "bfloat16")])
def test_rmsnorm_grads_match_repro(shape, dtype):
    """Autograd through the plain version on the saved x and w, as `repro`'s
    custom_vjp differentiates its reference."""
    rng = np.random.default_rng(16)
    xj, xt = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    wj, wt = _pair((1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32))
    g = rng.standard_normal(shape).astype(np.float32)
    gj, gt = _pair(g, dtype)
    _, vjp = jax.vjp(lambda x, w: jax_rmsnorm(x, w, interpret=True), xj, wj)
    dx_j, dw_j = vjp(gj)
    xt, wt = xt.requires_grad_(), wt.requires_grad_()
    dx_t, dw_t = torch.autograd.grad(rmsnorm(xt, wt), (xt, wt), gt)
    assert dx_t.dtype == TDT[dtype] and dw_t.dtype == torch.float32
    tol = GRAD_TOL if dtype == "float32" else TOL["bfloat16"]
    _close(dx_t, dx_j, tol)
    # dw sums over every row: hold it relative to its size
    np.testing.assert_allclose(_np(dw_t), _np(dw_j), rtol=tol,
                               atol=tol * np.abs(_np(dw_j)).max())


def test_rmsnorm_grads_per_model_weights():
    """The grouped (M, d) weights differentiate per model row."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32)).requires_grad_()
    dx, dw = torch.autograd.grad(rmsnorm(x, w).sum(), (x, w))
    for m in range(2):
        xm, wm = x[m].detach().requires_grad_(), w[m].detach().requires_grad_()
        rx, rw = torch.autograd.grad(rmsnorm(xm, wm).sum(), (xm, wm))
        torch.testing.assert_close(dx[m], rx, atol=1e-6, rtol=0)
        torch.testing.assert_close(dw[m], rw, atol=1e-5, rtol=0)
