"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs the Pallas kernels in interpret mode, called directly (not through
`repro`'s `dispatch.force`: the JAX jit cache ignores the dispatch mode). Inputs are
made from a seed with numpy and handed to both. Tolerances as
tests/test_kernels.py: 2e-5 for fp32, 2e-2 for bf16.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
(marked `cuda`, skipped where there is none) and chip_smoke.py hold them
against the plain versions.
"""
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_flash_fwd
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ops import (
    aligned,
    check_aligned,
    check_head_dim,
    flash_attention,
    flash_attention_fwd,
)
from repro_torch.kernels.flash_attention.ref import attention_fwd_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of `dtype` (both
    round fp32 to bf16 to nearest even)."""
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


# -- rmsnorm ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((8, 128), "float32"), ((37, 96), "float32"), ((3, 5, 64), "bfloat16"),
    ((2, 7, 256), "bfloat16"),
    ((37, 128), "bfloat16"),          # odd rows: the kernel's last half-warp has no row
    ((37, 256), "float32"),           # d = 256 fp32: two vectors per lane
    ((5, 26, 4, 32), "bfloat16"),     # the q/k-norm width, head_dim 32
])
def test_rmsnorm_matches_pallas_interpret(shape, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    ref = jax_rmsnorm(xj, jnp.asarray(w), interpret=True)
    out = rmsnorm(xt, torch.from_numpy(w))
    assert out.dtype == xt.dtype and out.shape == xt.shape
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype], rtol=0)


def test_rmsnorm_per_model_weights_match_per_model_calls():
    """(M, d) weights normalise each model's rows with its own weight row,
    as the grouped InfServer forward needs."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 5, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal((2, 64))).astype(np.float32)
    out = rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    for m in range(2):
        ref = jax_rmsnorm(jnp.asarray(x[m]), jnp.asarray(w[m]), interpret=True)
        np.testing.assert_allclose(out[m], np.asarray(ref), atol=TOL["float32"], rtol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rmsnorm_grouped_weights_straddling_warps_match_per_model_calls(dtype):
    """(2, 3, 5, 128): 15 rows per model, so on the card one warp's two
    rows at d = 128 bf16 belong to two models; each model's rows still take
    its own weight row."""
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((2, 3, 5, 128)).astype(np.float32), dtype)
    w = (1.0 + 0.1 * rng.standard_normal((2, 128))).astype(np.float32)
    out = rmsnorm(xt, torch.from_numpy(w))
    assert out.dtype == xt.dtype
    for m in range(2):
        ref = jax_rmsnorm(xj[m], jnp.asarray(w[m]), interpret=True)
        np.testing.assert_allclose(_np(out[m]), _np(ref), atol=TOL[dtype], rtol=0)


def test_rmsnorm_wrapper_rejects_bad_weights():
    x = torch.zeros(4, 32)
    with pytest.raises(ValueError):
        rmsnorm(x, torch.ones(16))
    with pytest.raises(ValueError):
        rmsnorm(x, torch.ones(3, 32))          # M=3 but x's leading axis is 4


# -- flash attention forward -------------------------------------------------------

def _live_rows(Tq, Tk, kv_len, causal, window):
    qp, kp = np.arange(Tq)[:, None], np.arange(Tk)[None, :]
    mask = np.broadcast_to(kp < kv_len, (Tq, Tk))
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (qp - kp < window)
    return mask.any(axis=1)


# B, H, KV, T (true), Tpad, d, block, causal, window, cap, dtype, mixed
FLASH_CASES = [
    (2, 4, 2, 37, 48, 32, 16, True, 0, 0.0, "float32", False),      # odd T, GQA
    (1, 2, 2, 24, 32, 64, 16, False, 0, 0.0, "float32", False),     # bidirectional
    (1, 4, 2, 40, 48, 32, 16, True, 8, 30.0, "float32", False),     # window + softcap
    (1, 4, 1, 26, 32, 32, 16, True, 0, 0.0, "bfloat16", False),     # bf16, G=4
    (2, 4, 2, 26, 32, 32, 16, True, 0, 0.0, "bfloat16", True),      # bf16 mixed
]


@pytest.mark.parametrize("B,H,KV,T,Tp,d,blk,causal,window,cap,dtype,mixed", FLASH_CASES)
def test_flash_fwd_matches_pallas_interpret(B, H, KV, T, Tp, d, blk, causal, window, cap,
                                            dtype, mixed):
    """Pre-padded inputs with kv_len, both o and lse. Rows with a live key
    match the Pallas kernel; rows with none (padded rows past a window's
    reach) give o = 0 and lse = 0 (see flash_attention/ref.py)."""
    rng = np.random.default_rng(2)
    qn = rng.standard_normal((B, H, Tp, d)).astype(np.float32)
    kn = rng.standard_normal((B, KV, Tp, d)).astype(np.float32)
    vn = rng.standard_normal((B, KV, Tp, d)).astype(np.float32)
    qn[:, :, T:] = kn[:, :, T:] = vn[:, :, T:] = 0.0        # the wrapper's zero padding
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (qn, kn, vn))
    scale = d ** -0.5
    oj, lj = jax_flash_fwd(qj, kj, vj, scale=scale, causal=causal, window=window,
                           cap=cap, block_q=blk, block_k=blk, kv_len=T,
                           interpret=True, mixed=mixed)
    ot, lt = flash_attention_fwd(qt, kt, vt, scale=scale, causal=causal, window=window,
                                 cap=cap, kv_len=T, mixed=mixed)
    assert ot.dtype == qt.dtype and lt.dtype == torch.float32
    live = _live_rows(Tp, Tp, T, causal, window)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(ot)[:, :, live], _np(oj)[:, :, live], atol=tol, rtol=0)
    np.testing.assert_allclose(lt.numpy()[:, :, live], np.asarray(lj)[:, :, live],
                               atol=tol, rtol=0)
    assert not np.isnan(_np(ot)).any() and not np.isnan(lt.numpy()).any()
    assert (_np(ot)[:, :, ~live] == 0).all() and (lt.numpy()[:, :, ~live] == 0).all()


def test_flash_fwd_window_rows_without_live_keys_exist():
    """The window case above really exercises rows with no live key."""
    assert not _live_rows(48, 48, 40, True, 8).all()


def test_flash_wrapper_takes_strided_model_layout():
    """The model passes (B, T, H, d) activations as (B, H, T, d) views."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 9, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 9, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 9, 2, 32)).astype(np.float32))
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=0.3)
    ref = flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), scale=0.3)
    assert torch.equal(o, ref)


@pytest.mark.parametrize("bad", ["kv_heads", "dtype", "mixed_fp32", "rank"])
def test_flash_wrapper_rejects_bad_inputs(bad):
    q, k, v = torch.zeros(1, 4, 8, 32), torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32)
    kw = {"scale": 1.0}
    if bad == "kv_heads":
        k = v = torch.zeros(1, 3, 8, 32)
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "mixed_fp32":
        kw["mixed"] = True
    else:
        q = q[0]
    with pytest.raises((ValueError, TypeError)):
        flash_attention_fwd(q, k, v, **kw)


@pytest.mark.parametrize("d", [32, 64, 80, 128, 256])
def test_head_dims_the_kernels_take(d):
    check_head_dim(d)


@pytest.mark.parametrize("d", [8, 16, 48, 96, 512])
def test_head_dims_the_kernels_refuse(d):
    with pytest.raises(ValueError):
        check_head_dim(d)


def _bthd(dtype, B=2, T=26, H=4, d=32, pad=0):
    """The model's (B, T, H, d) activations as a (B, H, T, d) view; `pad`
    extra elements per head row leave the head dim a strided slice."""
    return torch.zeros(B, T, H, d + pad, dtype=dtype)[..., :d].transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("make", [
    lambda dt: torch.zeros(2, 4, 26, 32, dtype=dt),            # contiguous (B, H, T, d)
    lambda dt: _bthd(dt),                                       # the model's strided view
    lambda dt: _bthd(dt, pad=8),                                # rows of d + 8: 16 bytes apart in bf16
    lambda dt: torch.zeros(3, 1, 5, 64, dtype=dt)[1:],          # offset by whole batches
    lambda dt: torch.zeros(1, 1, 7, 40, dtype=dt)[..., :32],    # size-1 dims' strides unused
], ids=["bhtd", "bthd", "padded-rows", "batch-offset", "size-1-dims"])
def test_aligned_accepts_16_byte_rows(make, dtype):
    t = make(dtype)
    assert aligned(t)
    check_aligned(t, t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("make", [
    lambda dt: torch.zeros(2 * 4 * 26 * 32 + 1, dtype=dt)[1:].view(2, 4, 26, 32),  # base + 1 element
    lambda dt: torch.zeros(2, 26, 4, 33, dtype=dt)[..., :32].transpose(1, 2),      # odd row pitch
    lambda dt: torch.zeros(2, 26, 4, 34, dtype=dt)[..., :32].transpose(1, 2),      # pitch of 34 elements
    lambda dt: torch.zeros(2, 4, 26, 64, dtype=dt)[..., ::2],                      # strided head dim
    lambda dt: torch.zeros(2, 4, 32, 26, dtype=dt).transpose(2, 3),                # (d, T) storage
], ids=["base-offset", "odd-pitch", "pitch-34", "head-dim-step", "transposed"])
def test_aligned_refuses_what_cp_async_cannot_copy(make, dtype):
    t = make(dtype)
    assert not aligned(t)
    with pytest.raises(ValueError):
        check_aligned(torch.zeros(1, 1, 2, 32, dtype=dtype), t)


def test_cpu_path_takes_unaligned_views():
    """Only the kernels need 16-byte rows: the plain version on the CPU
    takes any view, so the alignment rule costs the CPU path nothing."""
    rng = np.random.default_rng(5)
    base = torch.from_numpy(rng.standard_normal((1, 9, 2, 33)).astype(np.float32))
    q = base[..., :32].transpose(1, 2)
    assert not aligned(q)
    o, lse = flash_attention_fwd(q, q, q, scale=0.2)
    ro, rlse = attention_fwd_ref(q.contiguous(), q.contiguous(), q.contiguous(), scale=0.2)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)


def test_cpu_calls_launch_nothing():
    """The launch counters count kernel launches only: CPU calls run the
    plain versions and leave them alone."""
    n_rms, n_flash = rmsnorm.launches, flash_attention_fwd.launches
    rmsnorm(torch.ones(4, 32), torch.ones(32))
    flash_attention(torch.ones(1, 2, 4, 32), torch.ones(1, 2, 4, 32),
                    torch.ones(1, 2, 4, 32), scale=1.0)
    assert (rmsnorm.launches, flash_attention_fwd.launches) == (n_rms, n_flash)


# -- dispatch --------------------------------------------------------------------

def test_dispatch_resolves_by_device_and_mode(monkeypatch):
    """The device alone picks the tier: no environment variable or mode
    sends CUDA tensors to the plain versions."""
    monkeypatch.setenv("REPRO_KERNELS", "reference")     # repro's switch: ignored
    assert dispatch.resolve(torch.zeros(2, 4)) == "reference"
    assert dispatch.resolve(SimpleNamespace(device=torch.device("cuda", 0))) == "kernel"
    with pytest.raises(ValueError):
        dispatch.resolve(torch.zeros(2, 4, device="meta"))
    assert not any(hasattr(dispatch, n) for n in ("mode", "set_mode", "force"))


def test_dispatch_counts_every_call():
    """The port is eager: one count per executed call (repro counts per trace)."""
    dispatch.stats(reset=True)
    x, w = torch.ones(3, 32), torch.ones(32)
    for _ in range(3):
        dispatch.rmsnorm(x, w)
    q = torch.ones(1, 2, 4, 32)
    dispatch.attention(q, q, q, scale=1.0)
    st = dispatch.stats(reset=True)
    assert st == {"rmsnorm|reference": 3, "attention|reference": 1}
    assert dispatch.stats() == {}


def test_dispatch_plain_versions_match_ops():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 4, 6, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 6, 32)).astype(np.float32))
    out = dispatch.attention(q, k, k, scale=0.2, window=3, cap=5.0)
    ref = attention_fwd_ref(q, k, k, scale=0.2, window=3, cap=5.0)[0]
    assert torch.equal(out, ref)
    x, w = q[0], torch.ones(32)
    assert torch.equal(dispatch.rmsnorm(x, w), rmsnorm_ref(x, w))


def test_infer_mode_is_serving_scoped_and_thread_local(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS_INFER", "bf16")
    assert dispatch.infer_mode() is None
    seen = []
    with dispatch.serving():
        assert dispatch.infer_mode() == "bf16"
        t = threading.Thread(target=lambda: seen.append(dispatch.infer_mode()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [None]
    assert dispatch.infer_mode() is None
    monkeypatch.setenv("REPRO_KERNELS_INFER", "fp8")
    with dispatch.serving():
        assert dispatch.infer_mode() is None
