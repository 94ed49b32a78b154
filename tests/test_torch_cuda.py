"""The port's CUDA kernels against their plain PyTorch versions, on the card,
the learner's league side (the DataServer's staging, manifests of card
tensors, the Learner) against its CPU run, the envs' steps on the card
against the CPU's (bitwise), an Actor segment's exact kernel launches, and
a decode step of each moe, ssm, hybrid and vlm smoke config with no host
sync.

Marked `cuda`: every test skips where there is no CUDA device, since a CUDA
kernel has no CPU mode. This file imports neither jax nor `repro`, so the
card's machine, which has no jax, runs it without the JAX conftest:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 2e-5 (RMSNorm) and 1e-4 (attention: the kernel sums the
score and p.V products in another order than the plain version's matmuls);
bf16 2e-2. The attention backward is held at 1e-4 (fp32) and 2e-2 (bf16) of
max(1, max |plain|); the reverse scan at 1e-5 of max |y|, since it
reassociates the recurrence. AdamW's update is held to the plain body bit
for bit (it spells out each of the plain ops' fp32 roundings); the global
norm to 1e-6 of `tree_global_norm`, since both sum in fp32 in other orders.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.actors.policy import make_obs_policy
from repro_torch.configs import get_arch
from repro_torch.infserver import InfServer
from repro_torch.kernels.flash_attention.ops import (
    dkv_design,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
)
from repro_torch.kernels.adamw import adamw_update, global_norm
from repro_torch.kernels.adamw.ref import adamw_ref, clip_scale_ref
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_fwd_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.vtrace_scan.ops import (
    reverse_discounted_scan,
    reverse_discounted_scan_p,
)
from repro_torch.kernels.vtrace_scan.ref import reverse_discounted_scan_ref
from repro_torch.core import LeagueMgr, SelfPlayPFSPGameMgr
from repro_torch.learners import DataServer, Learner, build_env_train_step, build_seq_train_step
from repro_torch.models import init_params
from repro_torch.optim import Optimizer, adamw
from repro_torch.params import build_manifest, leaf_hash
from repro_torch.utils import tree_flatten_with_path, tree_global_norm, tree_leaves, tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape,dtype,models,offset", [
    ((37, 96), torch.float32, 1, 0),        # 16-byte vector path
    ((6656, 128), torch.bfloat16, 1, 0),    # policy-s serving rows
    ((5, 7, 33), torch.bfloat16, 1, 0),     # odd d: scalar path
    ((9, 64), torch.float32, 1, 1),         # misaligned x: scalar path
    ((2, 50, 96), torch.float32, 2, 0),     # one weight row per model
    ((2, 128, 26, 128), torch.bfloat16, 2, 0),  # grouped theta + phi flush, policy-s
    ((2, 128, 26, 256), torch.bfloat16, 2, 0),  # grouped theta + phi flush, policy-m
    ((37, 128), torch.bfloat16, 1, 0),      # odd rows: the last half-warp has no row
    ((2, 3, 5, 128), torch.bfloat16, 2, 0),  # 15 rows per model: a warp straddles two
    ((37, 256), torch.float32, 1, 0),       # two vectors per lane
    ((5, 26, 4, 32), torch.bfloat16, 1, 0),  # the q/k-norm width: 8 rows per warp
    ((3, 7, 32), torch.float32, 1, 0),
    ((9, 128), torch.bfloat16, 1, 1),       # misaligned bf16 x: scalar path
    ((131072, 128), torch.bfloat16, 1, 0),  # more rows than the card holds: strided, prefetched
    ((2, 40000, 128), torch.bfloat16, 2, 0),  # strided rows crossing the model boundary
    ((50000, 96), torch.float32, 1, 0),     # the two-pass kernel, strided
    # the families' hidden widths (hymba 1600, pixtral 5120, kimi-k2 7168)
    # at a decode step's rows, 4 prompts and one past a multiple of 4096
    *[((rows, d), torch.bfloat16, 1, 0) for d in (1600, 5120, 7168) for rows in (1, 4, 4097)],
    ((4097, 1600), torch.float32, 1, 0),
])
def test_rmsnorm_kernel_matches_plain(gen, shape, dtype, models, offset):
    n = int(np.prod(shape))
    x = torch.randn(n + offset, generator=gen, device="cuda").to(dtype)[offset:].view(shape)
    wshape = (models, shape[-1]) if models > 1 else (shape[-1],)
    w = 1.0 + 0.1 * torch.randn(wshape, generator=gen, device="cuda")
    before = rmsnorm.launches
    y = rmsnorm(x, w)
    assert rmsnorm.launches == before + 1 and y.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(y.float(), rmsnorm_ref(x, w).float(), atol=tol, rtol=0)


# B, H, KV, Tq, Tk, d, dtype, causal, window, cap, kv_len, mixed
FLASH = [
    (256, 4, 2, 26, 26, 32, torch.bfloat16, True, 0, 0.0, None, False),
    (256, 8, 4, 26, 26, 32, torch.bfloat16, True, 0, 0.0, None, True),
    (3, 4, 2, 37, 37, 64, torch.float32, True, 0, 0.0, None, False),
    (2, 4, 1, 37, 37, 128, torch.float32, True, 5, 20.0, None, False),
    (2, 8, 2, 37, 37, 256, torch.float32, True, 0, 0.0, None, False),
    (2, 4, 2, 33, 33, 32, torch.float32, False, 0, 0.0, None, False),
    (2, 4, 2, 5, 40, 32, torch.float32, False, 0, 0.0, None, False),    # Tq != Tk
    (2, 4, 2, 48, 48, 32, torch.float32, True, 8, 30.0, 40, False),     # rows with no live key
    (1, 4, 2, 1024, 1024, 32, torch.float32, True, 100, 30.0, None, False),
    (512, 4, 2, 26, 26, 32, torch.bfloat16, True, 0, 0.0, None, False),   # env step
    # the tensor-core regime beyond d = 32; T off multiples of 16; G in {1, 2, 4}
    (2, 4, 4, 37, 37, 64, torch.bfloat16, True, 0, 0.0, None, False),
    (2, 4, 2, 50, 50, 128, torch.bfloat16, True, 16, 20.0, None, False),
    (2, 8, 2, 65, 65, 256, torch.bfloat16, True, 0, 0.0, 60, False),
    (2, 4, 1, 37, 65, 64, torch.bfloat16, False, 0, 0.0, None, True),     # Tq != Tk
    (2, 4, 2, 65, 65, 32, torch.bfloat16, True, 8, 30.0, 50, False),      # rows with no live key
    (2, 4, 4, 50, 50, 32, torch.float32, True, 0, 0.0, None, False),
    (1, 8, 2, 65, 37, 64, torch.float32, False, 0, 10.0, None, False),
    # the families' groups: G = 5 (hymba, 25/5 heads of 64, every layer
    # windowed), G = 8 (kimi-k2, 64/8 of 128), G = 16 (qwen3-moe, 64/4);
    # T off the tile multiples
    (2, 25, 5, 67, 67, 64, torch.bfloat16, True, 16, 0.0, None, False),
    (1, 25, 5, 37, 37, 64, torch.float32, True, 8, 0.0, None, False),
    (2, 64, 8, 50, 50, 128, torch.bfloat16, True, 0, 0.0, None, False),
    (1, 64, 8, 33, 33, 128, torch.float32, True, 0, 0.0, None, False),
    (2, 64, 4, 37, 37, 128, torch.bfloat16, True, 0, 0.0, None, False),
    (1, 16, 1, 45, 45, 128, torch.float32, True, 0, 0.0, None, False),
    # head dim 80 (hubert: 16 heads of 80, bidirectional): both regimes, the
    # fp32 one's last 16-column pass; causal, window, cap and tail too
    (2, 16, 16, 67, 67, 80, torch.bfloat16, False, 0, 0.0, None, False),
    (1, 16, 16, 67, 67, 80, torch.float32, False, 0, 0.0, None, False),
    (2, 4, 2, 50, 50, 80, torch.bfloat16, True, 16, 20.0, None, False),
    (2, 4, 2, 65, 65, 80, torch.float32, True, 8, 30.0, 50, False),
    (2, 4, 1, 37, 65, 80, torch.bfloat16, False, 0, 0.0, None, True),
]


@pytest.mark.parametrize("B,H,KV,Tq,Tk,d,dtype,causal,window,cap,kv_len,mixed", FLASH)
@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
def test_flash_kernel_matches_plain(gen, B, H, KV, Tq, Tk, d, dtype, causal, window, cap,
                                    kv_len, mixed, layout):
    def make(heads, T):
        if layout == "bhtd":
            return torch.randn(B, heads, T, d, generator=gen, device="cuda").to(dtype)
        # the model's (B, T, H, d) activations, viewed as (B, H, T, d)
        return torch.randn(B, T, heads, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)

    q, k, v = make(H, Tq), make(KV, Tk), make(KV, Tk)
    kw = dict(scale=d ** -0.5, causal=causal, window=window, cap=cap, kv_len=kv_len,
              mixed=mixed)
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, **kw)
    assert flash_attention_fwd.launches == before + 1
    assert o.stride() == q.stride()           # o comes back in q's layout
    ro, rl = attention_fwd_ref(q, k, v, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, rl, atol=tol, rtol=0)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()


def test_flash_rows_without_live_keys_are_zero(gen):
    q = torch.randn(1, 2, 48, 32, generator=gen, device="cuda")
    k = torch.randn(1, 2, 48, 32, generator=gen, device="cuda")
    o, lse = flash_attention_fwd(q, k, k, scale=0.2, window=4, kv_len=30)
    dead = torch.arange(48, device="cuda") - 4 + 1 > 29      # window starts past kv_len
    assert dead.any()
    assert (o[:, :, dead] == 0).all() and (lse[:, :, dead] == 0).all()


@pytest.mark.parametrize("bad", ["head_dim", "fp16", "last_dim_stride", "misaligned_base",
                                 "misaligned_rows"])
def test_flash_kernel_rejects_what_it_does_not_take(gen, bad):
    d = 48 if bad == "head_dim" else 32
    q = torch.randn(1, 2, 8, d, generator=gen, device="cuda")
    if bad == "fp16":
        q = q.half()
    if bad == "last_dim_stride":
        q = torch.randn(1, 2, 8, 2 * d, generator=gen, device="cuda")[..., ::2]
    if bad == "misaligned_base":
        q = torch.randn(16 * d + 1, generator=gen, device="cuda")[1:].view(1, 2, 8, d)
    if bad == "misaligned_rows":     # rows 33 floats apart: not 16-byte multiples
        q = torch.randn(1, 8, 2, d + 1, generator=gen, device="cuda")[..., :d].transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        flash_attention_fwd(q, q, q, scale=1.0)
    if bad.startswith("misaligned"):
        lse = torch.zeros(1, 2, 8, device="cuda")
        with pytest.raises(ValueError):
            flash_attention_bwd_dkv(q, q, q, q, lse, lse, scale=1.0)


def _perturb_norms(tree, gen):
    """Every norm scale set to 1 + 0.1 * N(0, 1) (init sets them to one)."""
    return {k: (1.0 + 0.1 * torch.randn(v.shape, generator=gen, dtype=v.dtype)
                if k == "scale" else _perturb_norms(v, gen) if isinstance(v, dict) else v)
            for k, v in tree.items()}


def test_infserver_on_cuda_matches_cpu(gen):
    """Single and grouped flushes on the card give the CPU's values at fp32
    compute (the kernels against the plain versions, end to end). The two
    models' norm scales differ, so the grouped flush must use each model's
    own weight row."""
    cfg = dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype="float32")
    cpu = torch.Generator().manual_seed(0)
    theta, phi = (_perturb_norms(init_params(cpu, cfg), cpu) for _ in range(2))
    servers = {}
    for dev in ("cpu", "cuda"):
        to = lambda t: tree_map(lambda a: a.to(dev), t)
        s = InfServer(cfg, 6, to(theta), device=dev, max_batch=64)
        s.register_model("phi", to(phi))
        servers[dev] = s
    obs = np.random.default_rng(0).integers(0, 512, (12, 26)).astype(np.int32)
    vals = {}
    for dev, s in servers.items():
        single = s.get(s.submit(obs))[2]
        tt, tp = s.submit(obs), s.submit(obs[:5], model="phi")
        s.flush()
        vals[dev] = (single, s.get(tt)[2], s.get(tp)[2])
    for a, b in zip(vals["cpu"], vals["cuda"]):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
    st = servers["cuda"].stats()["dispatch"]
    assert st.get("attention|kernel", 0) > 0
    pol = make_obs_policy(cfg, 6)
    lg, _ = pol.logits_values(tree_map(lambda a: a.cuda(), theta),
                              torch.from_numpy(obs).long().cuda())
    assert lg.is_cuda and lg.shape == (12, 6)


# B, H, KV, Tq, Tk, d, dtype, causal, window, cap, kv_len
FLASH_BWD = [
    (64, 4, 2, 26, 26, 32, torch.bfloat16, True, 0, 0.0, None),     # env step, cut
    (1, 4, 2, 1024, 1024, 32, torch.float32, True, 128, 30.0, None),  # seq step, cut
    (3, 2, 2, 37, 37, 64, torch.float32, True, 0, 0.0, None),        # G=1
    (2, 4, 1, 37, 37, 128, torch.float32, True, 5, 20.0, None),      # G=4, window, cap
    (2, 8, 4, 37, 37, 256, torch.float32, True, 0, 0.0, None),       # G=2, d=256
    (2, 4, 2, 48, 48, 32, torch.float32, True, 8, 30.0, 40),         # rows with no live key
    (2, 4, 2, 5, 40, 32, torch.float32, False, 0, 0.0, None),        # Tq != Tk
    (512, 4, 2, 26, 26, 32, torch.bfloat16, True, 0, 0.0, None),    # env step
    (2, 4, 2, 65, 65, 32, torch.float32, True, 8, 30.0, 50),
    (1, 8, 2, 50, 37, 32, torch.float32, False, 0, 0.0, None),
    # positions 47.. have no live key; rows 128..191 are a dq tile with no KV tile
    (1, 4, 2, 100, 100, 32, torch.float32, True, 8, 30.0, 40),
    (1, 4, 2, 100, 100, 32, torch.bfloat16, True, 8, 30.0, 40),
] + [
    # the tensor-core regime beyond d = 32, each case at every head dim: T off
    # multiples of 16, G in {1, 2, 4}, a window with softcap, a kv_len tail,
    # Tq != Tk
    (B, H, KV, Tq, Tk, d, torch.bfloat16, causal, window, cap, kv_len)
    for d in (64, 128, 256)
    for (B, H, KV, Tq, Tk, causal, window, cap, kv_len) in (
        (2, 4, 4, 37, 37, True, 0, 0.0, None),
        (2, 4, 2, 50, 50, True, 16, 20.0, None),
        (2, 8, 2, 65, 65, True, 0, 0.0, 60),
        (2, 4, 1, 37, 65, False, 0, 0.0, None))
] + [
    # head dim 80 (hubert), both regimes: bidirectional at G = 1, a window
    # with softcap, a kv_len tail, Tq != Tk
    (B, H, KV, Tq, Tk, 80, dtype, causal, window, cap, kv_len)
    for dtype in (torch.bfloat16, torch.float32)
    for (B, H, KV, Tq, Tk, causal, window, cap, kv_len) in (
        (2, 16, 16, 67, 67, False, 0, 0.0, None),
        (2, 4, 2, 50, 50, True, 16, 20.0, None),
        (2, 8, 2, 65, 65, True, 0, 0.0, 60),
        (2, 4, 1, 37, 65, False, 0, 0.0, None))
] + [
    # the families' groups in the backward: G = 5 (hymba, 25/5 heads of 64,
    # windowed), G = 8 (kimi-k2, 64/8 of 128), G = 16 (qwen3-moe, 64/4; one
    # dk/dv block does 16 heads' work); T off the tile multiples
    (2, 25, 5, 67, 67, 64, torch.bfloat16, True, 16, 0.0, None),
    (1, 25, 5, 37, 37, 64, torch.float32, True, 8, 0.0, None),
    (2, 64, 8, 50, 50, 128, torch.bfloat16, True, 0, 0.0, None),
    (1, 64, 8, 33, 33, 128, torch.float32, True, 0, 0.0, None),
    (2, 64, 4, 37, 37, 128, torch.bfloat16, True, 0, 0.0, None),
    (1, 16, 1, 45, 45, 128, torch.float32, True, 0, 0.0, None),
]


@pytest.mark.parametrize("B,H,KV,Tq,Tk,d,dtype,causal,window,cap,kv_len", FLASH_BWD)
@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
def test_flash_bwd_kernels_match_plain(gen, B, H, KV, Tq, Tk, d, dtype, causal, window, cap,
                                       kv_len, layout):
    def make(heads, T):
        if layout == "bhtd":
            return torch.randn(B, heads, T, d, generator=gen, device="cuda").to(dtype)
        return torch.randn(B, T, heads, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)

    q, k, v, do = make(H, Tq), make(KV, Tk), make(KV, Tk), make(H, Tq)
    kw = dict(scale=d ** -0.5, causal=causal, window=window, cap=cap, kv_len=kv_len)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    counters = (flash_attention_bwd_dq, flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    designs = dict(flash_attention_bwd_dkv.design_launches)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert [c.launches for c in counters] == [n + 1 for n in before]
    designs[dkv_design(q, k, v)] += 1
    assert flash_attention_bwd_dkv.design_launches == designs
    assert dq.stride() == q.stride() and dk.stride() == k.stride() and dv.stride() == v.stride()
    plain = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, got, want, t in (("delta", delta, plain[0], 1e-4), ("dq", dq, plain[1], tol),
                               ("dk", dk, plain[2], tol), ("dv", dv, plain[3], tol)):
        want = want.float()
        err = ((got.float() - want).abs().max() / max(1.0, want.abs().max().item())).item()
        assert err <= t, (name, err)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)      # no atomics: deterministic
    dq2, delta2 = flash_attention_bwd_dq(q, k, v, o, do, lse, **kw)
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)


# B, H, T: latent attention's q and k 192 wide and v 128 (Kimi K2's MLA),
# causal, bf16, in the model's layout (v a slice of the (B, T, H, 256)
# k_nope | v projection); the cell's T of 8192 (at 8 of its 64 heads, so
# the plain path's T x T scores fit beside it; the kernels' blocks do not
# depend on H), all 64 heads at a T off the tile multiples, and a batch
MLA = [(1, 8, 8192), (1, 64, 300), (2, 4, 77)]


@pytest.mark.parametrize("B,H,T", MLA)
def test_flash_mla_kernels_match_plain(gen, B, H, T):
    """The (192, 128) forward, dq and dk/dv kernels against the plain path,
    at the tolerances of the D = 128 bf16 cases: 2e-2 of max(1, max |plain|)
    for o, dq, dk and dv (bf16 outputs of fp32 sums), 1e-4 for delta (an
    fp32 row sum of 128 products)."""
    def make(width):
        return torch.randn(B, T, H, width, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, kv, do = make(192), make(192), make(256), make(128)
    v = kv[..., 128:]
    q, k, v, do = (t.transpose(1, 2) for t in (q, k, v, do))
    kw = dict(scale=192 ** -0.5 * 1.81326, causal=True)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    assert o.shape == (B, H, T, 128) and o.transpose(1, 2).is_contiguous()
    ro, rl = attention_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, rl, atol=2e-2, rtol=0)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, **kw)
    designs = dict(flash_attention_bwd_dkv.design_launches)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    designs[dkv_design(q, k, v)] += 1     # T >= 128: the warpgroup-MMA kernel
    assert flash_attention_bwd_dkv.design_launches == designs
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    plain = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, got, want, t in (("delta", delta, plain[0], 1e-4), ("dq", dq, plain[1], 2e-2),
                               ("dk", dk, plain[2], 2e-2), ("dv", dv, plain[3], 2e-2)):
        want = want.float()
        err = ((got.float() - want).abs().max() / max(1.0, want.abs().max().item())).item()
        assert err <= t, (name, err)
        assert torch.isfinite(got.float()).all(), name


# B, H, KV, Tq, Tk, d, dv, causal, window, cap, kv_len: shapes the
# warpgroup-MMA dk/dv kernel takes (bf16, Tk >= 128)
DKV_WGMMA = [
    (1, 16, 4, 1030, 1030, 128, 128, True, 0, 0.0, None),   # Tk off the 128-key tile, G = 4
    (2, 8, 2, 300, 300, 128, 128, True, 100, 20.0, 250),    # window, softcap, kv_len tail
    (1, 8, 8, 200, 333, 128, 128, False, 0, 0.0, None),     # Tq < Tk
    (1, 4, 4, 400, 150, 128, 128, True, 0, 0.0, None),      # Tq > Tk: keys past the queries
    (1, 64, 4, 300, 300, 128, 128, True, 0, 0.0, None),     # G = 16 (qwen3-moe)
    (1, 64, 1, 300, 300, 128, 128, True, 0, 0.0, None),     # G = 64: one position a tile
    # mistral-large's G = 12 at the cell's unroll, on 2 of its 8 KV heads: the
    # plain path's fp32 (24, 8192, 8192) scores and grads fit beside it
    (1, 24, 2, 8192, 8192, 128, 128, True, 0, 0.0, None),
    (2, 8, 2, 300, 300, 192, 128, True, 64, 30.0, 260),     # latent widths, G = 4, every mask
    (1, 32, 1, 257, 257, 192, 128, True, 0, 0.0, None),     # G = 32: one position a tile
]


@pytest.mark.parametrize("B,H,KV,Tq,Tk,d,dv,causal,window,cap,kv_len", DKV_WGMMA)
@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
def test_flash_bwd_dkv_wgmma_matches_plain(gen, B, H, KV, Tq, Tk, d, dv, causal, window, cap,
                                           kv_len, layout):
    """The warpgroup-MMA dk/dv kernel against the plain path at the bf16
    tolerance (2e-2 of max(1, max |plain|)), bitwise equal over two calls;
    each call moves its design's launch count and no other."""
    def make(heads, T, w):
        if layout == "bhtd":
            return torch.randn(B, heads, T, w, generator=gen, device="cuda").to(torch.bfloat16)
        return (torch.randn(B, T, heads, w, generator=gen, device="cuda").to(torch.bfloat16)
                .transpose(1, 2))

    q, k, do = make(H, Tq, d), make(KV, Tk, d), make(H, Tq, dv)
    v = make(KV, Tk, d + dv)[..., d:] if layout == "bthd" and d != dv else make(KV, Tk, dv)
    assert dkv_design(q, k, v) == "wgmma"
    kw = dict(scale=d ** -0.5, causal=causal, window=window, cap=cap, kv_len=kv_len)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, **kw)
    before = flash_attention_bwd_dkv.launches
    designs = dict(flash_attention_bwd_dkv.design_launches)
    dk, dvg = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert flash_attention_bwd_dkv.launches == before + 1
    assert flash_attention_bwd_dkv.design_launches == dict(designs, wgmma=designs["wgmma"] + 1)
    # in k's and v's layouts (dv dense in v's axis order where v is a slice)
    assert dk.stride() == k.stride() and dvg.stride() == torch.empty_like(v).stride()
    plain = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, got, want in (("dk", dk, plain[2]), ("dv", dvg, plain[3])):
        want = want.float()
        err = ((got.float() - want).abs().max() / max(1.0, want.abs().max().item())).item()
        assert err <= 2e-2, (name, err)
        assert torch.isfinite(got.float()).all(), name
    del plain
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dvg, dv2)     # no atomics: deterministic


def test_flash_mla_widths_refuse_fp32(gen):
    q = torch.zeros(1, 2, 16, 192, device="cuda")
    k, v = torch.zeros(1, 2, 16, 192, device="cuda"), torch.zeros(1, 2, 16, 128, device="cuda")
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v, scale=1.0)


def test_flash_bwd_dq_rejects_a_misaligned_o(gen):
    q = torch.randn(1, 4, 8, 32, generator=gen, device="cuda")
    k = torch.randn(1, 2, 8, 32, generator=gen, device="cuda")
    lse = torch.zeros(1, 4, 8, device="cuda")
    o = torch.randn(4 * 8 * 32 + 1, generator=gen, device="cuda")[1:].view(1, 4, 8, 32)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd_dq(q, k, k, o, q, lse, scale=0.2)


def test_flash_attention_autograd_runs_the_kernels(gen):
    q = torch.randn(2, 4, 40, 32, generator=gen, device="cuda", requires_grad=True)
    k = torch.randn(2, 2, 40, 32, generator=gen, device="cuda", requires_grad=True)
    before = flash_attention_bwd_dq.launches
    o = flash_attention(q, k, k, scale=0.2, window=9, cap=25.0)
    gq, gk = torch.autograd.grad(o.square().sum(), (q, k))
    assert flash_attention_bwd_dq.launches == before + 1
    qc, kc = (t.detach().cpu().requires_grad_() for t in (q, k))
    rq, rk = torch.autograd.grad(flash_attention(qc, kc, kc, scale=0.2, window=9,
                                                 cap=25.0).square().sum(), (qc, kc))
    torch.testing.assert_close(gq.cpu(), rq, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(gk.cpu(), rk, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,T,dtype", [
    (32, 16, torch.float32), (1, 4096, torch.float32), (13, 100, torch.float32),
    (4, 40, torch.bfloat16),
    (5, 1, torch.float32),              # one element per row: one lane per row
    (1, 4097, torch.float32),           # two tiles, the right one of one element
    (3, 4096, torch.bfloat16),
    (300, 129, torch.float32),          # the shortest row of the block kernel: 2 warps
    (4, 257, torch.bfloat16),           # two warps per row, rows 16-byte misaligned
    (1000, 16, torch.float32),          # many packed blocks
    (2, 20000, torch.float32),          # five tiles per row
    (1, 30000, torch.bfloat16),         # four tiles
])
def test_reverse_scan_kernel_matches_plain(gen, B, T, dtype):
    deltas = torch.randn(B, T, generator=gen, device="cuda").to(dtype)
    decays = (0.99 * torch.rand(B, T, generator=gen, device="cuda")).to(dtype)
    init = torch.randn(B, generator=gen, device="cuda")
    before = reverse_discounted_scan_p.launches
    y = reverse_discounted_scan_p(deltas, decays, init)
    assert reverse_discounted_scan_p.launches == before + 1 and y.dtype == torch.float32
    ry = reverse_discounted_scan_ref(deltas, decays, init)
    assert ((y - ry).abs().max() / ry.abs().max()).item() <= 1e-5
    assert torch.equal(y, reverse_discounted_scan_p(deltas, decays, init))   # deterministic
    g = torch.randn(B, T, generator=gen, device="cuda")
    leaves = [t.detach().requires_grad_() for t in (deltas, decays, init)]
    gk = torch.autograd.grad((reverse_discounted_scan(*leaves) * g).sum(), leaves)
    gr = torch.autograd.grad((reverse_discounted_scan_ref(*leaves) * g).sum(), leaves)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(gk, gr):
        assert a.dtype == b.dtype
        assert ((a.float() - b.float()).abs().max() / b.float().abs().max()).item() <= tol


@pytest.mark.parametrize("B,T,dtype", [(32, 16, torch.float32), (1, 4096, torch.float32),
                                       (3, 4096, torch.bfloat16), (2, 4097, torch.float32)])
def test_reverse_scan_kernel_on_misaligned_views(gen, B, T, dtype):
    """Contiguous views one element into their storage: no row is 16-byte
    aligned, so every load and store takes the scalar path."""
    def view(t):
        return torch.cat([t.new_zeros(1), t.flatten()])[1:].view(B, T)

    deltas = view(torch.randn(B, T, generator=gen, device="cuda").to(dtype))
    decays = view((0.99 * torch.rand(B, T, generator=gen, device="cuda")).to(dtype))
    init = torch.randn(B, generator=gen, device="cuda")
    assert deltas.is_contiguous() and deltas.data_ptr() % 16 != 0
    y = reverse_discounted_scan_p(deltas, decays, init)
    ry = reverse_discounted_scan_ref(deltas, decays, init)
    assert ((y - ry).abs().max() / ry.abs().max()).item() <= 1e-5
    assert torch.equal(y, reverse_discounted_scan_p(deltas, decays, init))


def test_env_train_step_on_cuda_matches_cpu(gen):
    """One env step of policy-s at fp32 compute, card against CPU: loss and
    every grad leaf within 1e-4."""
    cfg = dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype="float32")
    inner = adamw(3e-4, clip_norm=1.0)

    def update(grads, state, params):
        p, s, m = inner.update(grads, state, params)
        return p, s, {**m, "grads": grads}
    opt = Optimizer(inner.init, update)
    step = build_env_train_step(cfg, 6, opt)
    rng = np.random.default_rng(0)
    B, T = 4, 8
    batch = {"obs": torch.from_numpy(rng.integers(0, 16, (B, T, 26))),
             "actions": torch.from_numpy(rng.integers(0, 6, (B, T))),
             "behavior_logp": torch.full((B, T), -1.5),
             "behavior_values": torch.from_numpy(rng.normal(size=(B, T)).astype(np.float32)),
             "rewards": torch.from_numpy(rng.normal(size=(B, T)).astype(np.float32)),
             "done": torch.from_numpy(rng.random((B, T)) < 0.1),
             "bootstrap_value": torch.zeros(B)}
    params = init_params(torch.Generator().manual_seed(0), cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        to = lambda t: tree_map(lambda a: a.to(dev), t)
        out[dev] = step(to(params), opt.init(to(params)), to(batch))[2]
    assert abs(out["cuda"]["loss"].item() - out["cpu"]["loss"].item()) <= 1e-4
    for a, b in zip(tree_leaves(out["cuda"]["grads"]), tree_leaves(out["cpu"]["grads"])):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)


def _segment(rng, B, T):
    return {"obs": rng.integers(0, 16, (B, T, 26)).astype(np.int32),
            "actions": rng.integers(0, 6, (B, T)).astype(np.int32),
            "behavior_logp": (-np.abs(rng.normal(size=(B, T))) - 1.0).astype(np.float32),
            "behavior_values": rng.normal(size=(B, T)).astype(np.float32),
            "rewards": rng.normal(size=(B, T)).astype(np.float32),
            "done": rng.random((B, T)) < 0.1,
            "bootstrap_value": rng.normal(size=(B,)).astype(np.float32)}


@pytest.mark.parametrize("blocking", [False, True])
def test_data_server_staging_is_bitwise_under_back_to_back_calls(gen, blocking):
    """50 `sample_to_device` calls with no synchronisation between them and
    puts in between (every other call off-policy, every call on-policy):
    each staged batch must equal, bitwise, the ring rows its slots selected
    at the time of the call. A pinned buffer rewritten while its copy is in
    flight would give a batch the next gather's rows."""
    rng = np.random.default_rng(0)
    ds = DataServer(capacity_frames=8 * 64 * 16, seed=1, blocking=blocking)
    ds.put(_segment(rng, 64, 16))
    got, want = [], []
    for i in range(50):
        if blocking or i % 2:
            ds.put(_segment(rng, 64, 16))
        batch = ds.sample_to_device(None if blocking else 48)
        slots = ds.last_sample_info()["slots"]
        want.append([np.take(b, slots, axis=0) for b in ds._buffers])
        got.append(batch)
    torch.cuda.synchronize()
    for batch, rows in zip(got, want):
        leaves = [x for _, x in tree_flatten_with_path(batch)[0]]
        assert all(x.is_cuda for x in leaves)
        for x, r in zip(leaves, rows):
            assert np.array_equal(x.cpu().numpy(), r)
    assert ds.prefetch_hits >= (50 if blocking else 20)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_leaf_hash_of_a_card_tensor_equals_the_cpu_one(gen, dtype):
    x = torch.randn(64, 33, generator=gen, device="cuda").to(dtype)
    assert leaf_hash(x) == leaf_hash(x.cpu())
    tree = {"b": {"w": x, "s": x[0, 0].clone()}, "a": x.float()[:, :7].contiguous(),
            "i": torch.arange(5, device="cuda", dtype=torch.int32)}
    on_card, on_cpu = build_manifest(tree, 2), build_manifest(tree_map(torch.Tensor.cpu, tree), 2)
    assert on_card.leaf_hashes == on_cpu.leaf_hashes and on_card.tree_hash == on_cpu.tree_hash


def test_learner_on_cuda_matches_cpu(gen):
    """Three (put, learn) rounds of policy-s at fp32 compute through the
    league: the card's params and metrics within 1e-4 of the CPU run's,
    the pool versions and the feed counters equal."""
    cfg = dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        league = LeagueMgr(seed=0)
        league.add_learning_agent("main", params, game_mgr=SelfPlayPFSPGameMgr(payoff=None))
        opt = adamw(3e-4, clip_norm=1.0)
        learner = Learner(league, build_env_train_step(cfg, 6, opt), opt, params, device=dev)
        rng = np.random.default_rng(1)
        metrics = []
        for _ in range(3):
            learner.data_server.put(_segment(rng, 8, 8))
            metrics.append({k: v.item() for k, v in learner.learn().items()})
        out[dev] = (learner, metrics)
    (cpu, m_cpu), (card, m_card) = out["cpu"], out["cuda"]
    for a, b in zip(m_card, m_cpu):
        assert a.keys() == b.keys() and all(abs(a[k] - b[k]) <= 1e-4 for k in a)
    for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
    key = card.current_key
    assert card.league.model_pool.version(key) == cpu.league.model_pool.version(key) == 3
    assert card.data_server.prefetch_hits == cpu.data_server.prefetch_hits == 3


@pytest.mark.parametrize("name", ["rps", "duel", "pommerman_lite"])
def test_env_steps_on_the_card_equal_the_cpu_bitwise(gen, name):
    """64 steps at 64 slots from one state (reset on the card, copied to
    the CPU), actions from a numpy seed: every state leaf, obs, done and
    info entry bitwise equal, rewards within 1e-6."""
    from repro_torch.envs import make_env

    card, cpu = make_env(name, device="cuda"), make_env(name, device="cpu")
    s_card, _ = card.reset(gen, 64)
    s_cpu = {k: v.cpu() for k, v in s_card.items()}
    rng = np.random.default_rng(3)
    for _ in range(64):
        a = rng.integers(0, card.spec.num_actions, (64, card.spec.num_agents)).astype(np.int32)
        s_card, o_card, r_card, d_card, i_card = card.step(s_card, torch.from_numpy(a).cuda(), gen)
        s_cpu, o_cpu, r_cpu, d_cpu, i_cpu = cpu.step(s_cpu, torch.from_numpy(a), None)
        for k in s_cpu:
            assert s_card[k].dtype == s_cpu[k].dtype and torch.equal(s_card[k].cpu(), s_cpu[k]), k
        assert torch.equal(o_card.cpu(), o_cpu) and torch.equal(d_card.cpu(), d_cpu)
        assert set(i_card) == set(i_cpu)
        assert all(torch.equal(i_card[k].cpu(), v) for k, v in i_cpu.items())
        assert (r_card.cpu() - r_cpu).abs().max().item() <= 1e-6


def test_actor_segment_launches_exactly_its_forwards(gen):
    """A local Actor segment on the card (pommerman_lite, 4 envs x 5 steps,
    policy-s) launches exactly 2T + 1 forwards' kernels: 2L + 1 RMSNorms and
    L attention forwards each, nothing of the backward; a served segment
    exactly T + 1 flushes' worth."""
    from repro_torch.actors import Actor
    from repro_torch.envs import make_env

    cfg = get_arch("tleague-policy-s")
    L, T = cfg.num_layers, 5
    kernels = (rmsnorm, flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv,
               reverse_discounted_scan_p)
    env = make_env("pommerman_lite", device="cuda")
    for served in (False, True):
        league = LeagueMgr(seed=0)
        league.add_learning_agent("main", init_params(gen, cfg),
                                  game_mgr=SelfPlayPFSPGameMgr(payoff=None))
        server = InfServer(cfg, 6, device="cuda") if served else None
        actor = Actor(env, cfg, league, num_envs=4, unroll_len=T, inf_server=server,
                      device="cuda")
        actor.run_segment()                      # builds and warms
        for k in kernels:
            k.launches = 0
        traj, _ = actor.run_segment()
        forwards = T + 1 if served else 2 * T + 1
        assert [k.launches for k in kernels] == [forwards * (2 * L + 1), forwards * L, 0, 0, 0]
        assert traj["obs"].shape == (8, T, 26) and traj["actions"].dtype == np.int32


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "rwkv6-3b",
                                  "hymba-1.5b", "pixtral-12b"])
def test_family_decode_step_has_no_host_sync(gen, arch):
    """A decode step of each family's smoke config (MoE routing, the RWKV6
    and Mamba states) under `set_sync_debug_mode("error")`, with exactly
    its RMSNorm launches and no flash forward."""
    from repro_torch.models import decode_step, prefill

    cfg = get_arch(arch).smoke()
    params = init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen, device="cuda")
    with torch.inference_mode():
        logits, _, state = prefill(params, cfg, {"tokens": toks})
        tok = logits[:, -1:].argmax(-1)
        norms = 0 if cfg.family == "ssm" else (
            (2 + 2 * cfg.qk_norm + 2 * (cfg.family == "hybrid")) * cfg.num_layers + 1)
        before = (rmsnorm.launches, flash_attention_fwd.launches)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lg, v, state = decode_step(params, cfg, tok, state, uniform=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert (rmsnorm.launches - before[0], flash_attention_fwd.launches - before[1]) == (
            norms, 0)
        assert torch.isfinite(lg).all() and torch.isfinite(v).all()
        assert state["length"].tolist() == [25, 25]


# -- the mesh: one card is a (1, 1) mesh ---------------------------------------------

def test_sharded_infserver_on_the_card_matches_unsharded(gen):
    """`InfServer(mesh=make_local_mesh())` (NCCL, one rank) against the
    unsharded server on the card: θ alone, then θ and φ grouped, within
    1e-4 (actions equal); the forwards launch the kernels, never the plain
    versions."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import close_local_mesh, make_local_mesh

    cfg = dataclasses.replace(get_arch("tleague-policy-s"), compute_dtype="float32")
    theta, phi = (init_params(torch.Generator(device="cuda").manual_seed(s), cfg)
                  for s in (0, 1))
    rng = np.random.default_rng(7)
    obs_a = rng.integers(0, 512, (5, 26)).astype(np.int32)
    obs_b = rng.integers(0, 512, (3, 26)).astype(np.int32)

    def run(mesh):
        s = InfServer(cfg, 6, max_batch=64, seed=3, mesh=mesh)
        s.register_model("theta", theta)
        out = [s.get(s.submit(obs_a, model="theta"))]
        s.register_model("phi", phi)
        t1, t2 = s.submit(obs_a, model="theta"), s.submit(obs_b, model="phi")
        s.flush()
        return out + [s.get(t1), s.get(t2)], s.stats()

    single, _ = run(None)
    dispatch.stats(reset=True)
    mesh = make_local_mesh()
    try:
        sharded, st = run(mesh)
    finally:
        close_local_mesh()
    assert st["sharded"] is True and st["mesh_shape"] == [1, 1]
    calls = dispatch.stats()
    assert calls.get("rmsnorm|kernel", 0) > 0 and calls.get("attention|kernel", 0) > 0
    assert not any("|reference" in k for k in calls)
    for (a, lp, v), (a0, lp0, v0) in zip(sharded, single):
        np.testing.assert_array_equal(a, a0)
        np.testing.assert_allclose(lp, lp0, atol=1e-4, rtol=0)
        np.testing.assert_allclose(v, v0, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"])
def test_moe_apply_ep_on_the_card_matches_moe_apply(gen, arch):
    """`moe_apply_ep` on the card's (1, 1) mesh against `moe_apply`, fp32:
    y, aux and every grad within `tests/test_moe_ep.py`'s bounds."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import close_local_mesh, make_local_mesh
    from repro_torch.models import moe

    cfg = get_arch(arch).smoke()
    p = tree_map(lambda t: t.requires_grad_(True), moe.init_moe(gen, cfg, torch.float32))
    x = torch.randn(4, 16, cfg.d_model, device="cuda", generator=gen)
    y0, a0 = moe.moe_apply(p, cfg, x)
    g0 = torch.autograd.grad(y0.sum(), tree_leaves(p))
    mesh = make_local_mesh()
    try:
        with SH.data_parallel(mesh, ("data",)):
            y1, a1 = moe.moe_apply_ep(p, cfg, x, mesh)
            loss = SH.batch_sum(y1.sum())
        g1 = torch.autograd.grad(loss / mesh.size(), tree_leaves(p))
    finally:
        close_local_mesh()
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(a1, a0, rtol=1e-4, atol=1e-5)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)


# -- the optimizer: AdamW's update and the global norm -------------------------

def _at_offset(t, off):
    """t as a contiguous view `off` elements into its storage (not 16-byte
    aligned for off = 1)."""
    return torch.cat([t.new_zeros(off), t.flatten()])[off:].view(t.shape) if off else t


# a 0-d scalar, whole 16-byte vectors, a ragged length, a stacked (1, ...)
# leaf and one of several blocks with a ragged end
ADAMW_SHAPES = [(), (64,), (1037,), (1, 24, 40), (3, 100003)]
ADAMW_KINDS = {"fp32-wd": (torch.float32, False, 0.01), "bf16-master": (torch.bfloat16, True, 0.0),
               "bf16": (torch.bfloat16, False, 0.0)}
HYPER = dict(b1=0.9, b2=0.999, eps=1e-8)


@pytest.mark.parametrize("kind", list(ADAMW_KINDS))
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("off", [0, 1])
def test_adamw_kernel_equals_the_plain_body_bitwise(gen, kind, clip, off):
    """The kernel's new moments, master and param against the plain body
    (`adamw_ref`) run on the card: torch.equal, fresh outputs and in place;
    off = 1 puts every tensor 1 element into its storage (element by
    element)."""
    dtype, master, wd = ADAMW_KINDS[kind]
    dev = "cuda"
    scal = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    scale = scal(0.37) if clip else None
    lr, bc1, bc2 = scal(3e-3), 1 - 0.9 ** scal(3.0), 1 - 0.999 ** scal(3.0)
    before = adamw_update.launches
    for shape in ADAMW_SHAPES:
        rnd = lambda: torch.randn(shape, generator=gen, device=dev)
        g = _at_offset((3 * rnd()).to(dtype), off)
        m = _at_offset(0.1 * rnd(), off)
        v = _at_offset(0.01 * rnd().square(), off)
        p = _at_offset(rnd().to(dtype), off)
        base = _at_offset(p.float() + 1e-3 * rnd(), off) if master else p
        kw = dict(scale=scale, lr=lr, bc1=bc1, bc2=bc2, weight_decay=wd, **HYPER)
        want = adamw_ref(g, m, v, base, scale, lr, bc1, bc2, weight_decay=wd, **HYPER)
        out = (torch.empty_like(m), torch.empty_like(v),
               torch.empty_like(base) if master else None, torch.empty_like(p))
        adamw_update(g, m, v, base, out, **kw)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1]), (kind, shape)
        if master:
            assert torch.equal(out[2], want[2]), (kind, shape)
        assert torch.equal(out[3], want[2].to(p.dtype)), (kind, shape)
        ins = [_at_offset(t.clone(), off) for t in (m, v, base)] + [_at_offset(p.clone(), off)]
        m2, v2, b2, p2 = ins
        if not master:
            b2 = p2
        adamw_update(g, m2, v2, b2, (m2, v2, b2 if master else None, p2), **kw)
        for a, b in zip((m2, v2, p2), (out[0], out[1], out[3])):
            assert torch.equal(a, b), (kind, shape)
        if master:
            assert torch.equal(b2, out[2])
    assert adamw_update.launches == before + 2 * len(ADAMW_SHAPES)


@pytest.mark.parametrize("kw", [dict(weight_decay=0.01, clip_norm=1.0),
                                dict(master_fp32=True, clip_norm=1.0),
                                dict(clip_norm=1.0)], ids=["fp32", "bf16-master", "bf16"])
def test_adamw_in_place_equals_the_functional_update_on_the_card(gen, kw):
    """Three steps: in place returns the very tensors it was given and gives
    the functional update's params, state and metrics bit for bit."""
    dtype = torch.float32 if "weight_decay" in kw else torch.bfloat16
    params = {"a": torch.randn(7, 5, generator=gen, device="cuda").to(dtype),
              "b": {"c": torch.randn(11, 3, generator=gen, device="cuda").to(dtype),
                    "s": torch.randn((), generator=gen, device="cuda").to(dtype)},
              "stack": torch.randn(1, 64, 40, generator=gen, device="cuda").to(dtype)}
    fopt, iopt = adamw(1e-2, **kw), adamw(1e-2, inplace=True, **kw)
    fp, fs = params, fopt.init(params)
    ip, is_ = tree_map(torch.clone, params), fopt.init(params)
    for _ in range(3):
        grads = tree_map(lambda p: (3 * torch.randn(p.shape, generator=gen, device="cuda"))
                         .to(dtype), params)
        fp, fs, fm = fopt.update(grads, fs, fp)
        held = lambda p, s: tree_leaves((p, {k: v for k, v in s.items() if k != "step"}))
        leaves = held(ip, is_)
        ip2, is_, im = iopt.update(grads, is_, ip)
        assert all(a is b for a, b in zip(held(ip2, is_), leaves))
        ip = ip2
    for a, b in zip(tree_leaves((fp, fs)), tree_leaves((ip, is_))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(torch.equal(fm[k], im[k]) for k in fm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_norm_kernel_matches_tree_global_norm(gen, dtype):
    """Within 1e-6 of `tree_global_norm` (fp32 sums in other orders); the
    same bits from two calls (no atomics); the clip scale the plain clip's
    arithmetic on the kernel's norm, bit for bit."""
    shapes = [(), (7,), (1037,), (1, 24, 40), (3, 1_000_003)]
    grads = [(2 * torch.randn(s, generator=gen, device="cuda")).to(dtype) for s in shapes]
    grads.append(_at_offset(grads[2].clone(), 1))            # element by element
    grads.append(torch.empty(0, 4, dtype=dtype, device="cuda"))  # no elements, no launch
    before = global_norm.launches
    norm, scale = global_norm(grads, 1.0)
    want = tree_global_norm(grads)
    assert abs(norm.item() - want.item()) <= 1e-6 * want.item()
    norm2, scale2 = global_norm(grads, 1.0)
    assert torch.equal(norm, norm2) and torch.equal(scale, scale2)
    assert torch.equal(scale, clip_scale_ref(norm, 1.0))
    assert global_norm(grads)[1] is None
    assert global_norm.launches == before + 3 * (len(shapes) + 2)


def test_seq_train_step_runs_the_optimizer_kernels(gen):
    """One `build_seq_train_step` step of policy-s at T = 64 with the
    benchmark's optimizer (bf16 params, fp32 master, clip, in place): the
    norm and update kernels launch and are counted on the kernel tier."""
    from repro_torch.kernels import dispatch

    cfg = dataclasses.replace(get_arch("tleague-policy-s"), param_dtype="bfloat16")
    opt = adamw(3e-4, clip_norm=1.0, master_fp32=True, inplace=True)
    step = build_seq_train_step(cfg, opt, loss="vtrace", remat=True)
    params = init_params(gen, cfg)
    n_leaves = len(tree_leaves(params))
    state = opt.init(params)
    rng = np.random.default_rng(7)
    B, T = 2, 64
    batch = {k: torch.from_numpy(v).cuda() for k, v in {
        "tokens": rng.integers(0, cfg.vocab_size, (B, T)),
        "actions": rng.integers(0, cfg.vocab_size, (B, T)),
        "behavior_logp": (-np.abs(rng.normal(size=(B, T))) - 6.0).astype(np.float32),
        "behavior_values": rng.normal(size=(B, T)).astype(np.float32),
        "rewards": rng.normal(size=(B, T)).astype(np.float32),
        "discounts": (0.99 * (rng.random((B, T)) >= 0.01)).astype(np.float32),
        "bootstrap_value": rng.normal(size=(B,)).astype(np.float32)}.items()}
    before = (adamw_update.launches, global_norm.launches)
    dispatch.stats(reset=True)
    first = tree_map(torch.clone, params)
    params, state, metrics = step(params, state, batch)
    st = dispatch.stats(reset=True)
    assert st.get("adamw|kernel") == 1 and st.get("global_norm|kernel") == 1, st
    assert not any("|reference" in k for k in st), st
    assert adamw_update.launches - before[0] == n_leaves
    assert global_norm.launches - before[1] == n_leaves + 1
    assert bool(torch.isfinite(metrics["grad_norm"])) and metrics["grad_norm"].item() > 0
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(first)))


def test_sharded_update_on_the_card_runs_the_kernels(gen):
    """DTensor leaves on a (1, 1) NCCL mesh of the card (the sharded steps'
    layout: one leaf split over 'data', one replicated): the kernels on
    the local shards, counted on the kernel tier, one update launch a leaf
    and one norm launch a leaf and its finish; the params, state and norm
    of the plain tensors' update bit for bit."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import close_local_mesh, make_local_mesh

    params = {"w": torch.randn(64, 40, generator=gen, device="cuda").to(torch.bfloat16),
              "b": torch.randn(40, generator=gen, device="cuda").to(torch.bfloat16)}
    grads = tree_map(lambda p: (3 * torch.randn(p.shape, generator=gen, device="cuda"))
                     .to(p.dtype), params)
    opt = adamw(1e-2, clip_norm=1.0, master_fp32=True)
    want = opt.update(grads, opt.init(params), params)
    mesh = make_local_mesh()
    try:
        place = {"w": [Shard(0), Replicate()], "b": [Replicate(), Replicate()]}
        dist = lambda tree: {k: distribute_tensor(t, mesh, place[k]) for k, t in tree.items()}
        state = opt.init(params)
        dstate = {"step": distribute_tensor(state["step"], mesh, [Replicate(), Replicate()]),
                  **{k: dist(state[k]) for k in ("mu", "nu", "master")}}
        before = (adamw_update.launches, global_norm.launches)
        dispatch.stats(reset=True)
        got = opt.update(dist(grads), dstate, dist(params))
        st = dispatch.stats(reset=True)
        assert st == {"global_norm|kernel": 1, "adamw|kernel": 1}, st
        assert (adamw_update.launches - before[0], global_norm.launches - before[1]) == (2, 3)
        whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
        for a, b in zip(tree_leaves(tree_map(whole, got)), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    finally:
        close_local_mesh()
