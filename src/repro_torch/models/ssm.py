"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba-style S6
(counterpart of `repro.models.ssm`).

RWKV6 [arXiv:2404.05892] — data-dependent decay linear attention:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t        (per head, S: hs x hs)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with token-shift "ddlerp" mixing and a LoRA'd decay w_t.

Mamba/S6 (hymba's parallel SSM heads):
    h_t = exp(dt*A) h_{t-1} + dt * B_t x_t ;  y_t = C_t h_t + D x_t
with a short causal conv in front and a silu gate.

Plain PyTorch, on every device: `repro` reaches no Pallas kernel here (its
recurrences are `lax.scan`s), so there is no TPU kernel to port. Each
`lax.scan` is a Python loop over time with an fp32 state (fp64 at fp64
compute, where RWKV6 runs as a rounding witness); a step forms
its own decay (`dA` for Mamba), so no (B, T, di, N) tensor is ever
materialised. The causal conv is explicit taps, as in `repro`: cuDNN's
`conv1d` would run fp32 as TF32.

Under a mesh scope both split over 'model' as `repro`'s sharding rules lay
them out: RWKV6's time mix by head and its channel mix by hidden dim,
Mamba by its inner dim, each block's partial output summed over 'model'.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L

RWKV_TARGETS = ("r", "k", "v", "w", "g")


# ===========================================================================
# RWKV6 time mix
# ===========================================================================

def init_rwkv_time_mix(gen, cfg, dtype):
    d = cfg.d_model
    hs = cfg.ssm.head_size
    r = cfg.ssm.lora_rank
    n = len(RWKV_TARGETS)
    dev = gen.device
    return {
        "mu_x": torch.zeros((d,), dtype=dtype, device=dev),
        "lora_a": L._normal(gen, (d, n * r), 0.01, dtype),
        "lora_b": L._normal(gen, (n, r, d), 0.01, dtype),
        "mu": torch.zeros((n, d), dtype=dtype, device=dev),
        "w_base": torch.linspace(-6.0, -0.5, d, device=dev).to(dtype),  # per-channel decay bias
        "u": L._normal(gen, (d // hs, hs), 0.3, dtype),                # bonus ("first token")
        "wr": L.dense_init(gen, d, d, dtype),
        "wk": L.dense_init(gen, d, d, dtype),
        "wv": L.dense_init(gen, d, d, dtype),
        "wg": L.dense_init(gen, d, d, dtype),
        "wo": L.dense_init(gen, d, d, dtype),
        "ln_out": L.layernorm_init(hs, dtype, dev),                   # per-head groupnorm
    }


def _rwkv_mix(p, x, x_prev):
    """ddlerp: per-target data-dependent interpolation of x and x_prev.
    x, x_prev: (B, T, d) -> dict target -> (B, T, d)."""
    xx = x_prev - x
    base = x + xx * p["mu_x"].to(x.dtype)
    r = p["lora_a"].shape[1] // len(RWKV_TARGETS)
    z = torch.tanh(base @ p["lora_a"].to(x.dtype))              # (B, T, 5r)
    z = z.reshape(*z.shape[:-1], len(RWKV_TARGETS), r)
    dyn = torch.einsum("btnr,nrd->btnd", z, p["lora_b"].to(x.dtype))
    return {t: x + xx * (p["mu"][i].to(x.dtype) + dyn[..., i, :])
            for i, t in enumerate(RWKV_TARGETS)}


def _rwkv_head_step(r_t, k_t, v_t, w_t, u, S):
    """One step of the per-head recurrence, fp32.
    r, k, v: (B, H, hs); w: (B, H, hs) decay in (0, 1); u: (H, hs);
    S: (B, H, hs, hs). Returns (y (B, H, hs), S)."""
    kv = k_t[..., :, None] * v_t[..., None, :]                   # (B, H, hs, hs)
    y = (r_t[..., None, :] @ torch.addcmul(S, u[..., :, None], kv))[..., 0, :]
    return y, torch.addcmul(kv, w_t[..., :, None], S)


def rwkv_time_mix(p, cfg, x, x_prev_init, S_init):
    """Full-sequence scan. x: (B, T, d). Returns (y, (x_last, S_last)).

    H is read from the weights: under a mesh scope that splits the heads
    over 'model' this rank's wr, wk, wv, wg, w_base and u hold its H/M
    heads, wo its rows, and S its heads; the ddlerp mix runs whole, the
    decay input is cut to the rank's channels, and wo's partial output is
    summed over 'model'."""
    B, T, d = x.shape
    hs = cfg.ssm.head_size
    H = p["wr"]["w"].shape[-1] // hs
    x_prev = torch.cat([x_prev_init[:, None], x[:, :-1]], dim=1)
    m = _rwkv_mix(p, x, x_prev)
    r = L.wide(L.dense(p["wr"], m["r"]).reshape(B, T, H, hs))
    k = L.wide(L.dense(p["wk"], m["k"]).reshape(B, T, H, hs))
    v = L.wide(L.dense(p["wv"], m["v"]).reshape(B, T, H, hs))
    g = F.silu(L.dense(p["wg"], m["g"]))
    mw = m["w"] if H * hs == d else m["w"].narrow(-1, SH.model_index() * H * hs, H * hs)
    w = torch.exp(-torch.exp(p["w_base"].to(r.dtype) + L.wide(mw))).reshape(B, T, H, hs)
    u = p["u"].to(r.dtype)

    S = S_init.to(r.dtype)
    ys = []
    for t in range(T):
        y_t, S = _rwkv_head_step(r[:, t], k[:, t], v[:, t], w[:, t], u, S)
        ys.append(y_t)
    y = torch.stack(ys, dim=1)                                   # (B, T, H, hs)
    y = L.layernorm(p["ln_out"], y.to(x.dtype))
    y = L.dense(p["wo"], y.reshape(B, T, H * hs) * g)
    return (y if H * hs == d else SH.model_sum(y)), (x[:, -1], S)


def rwkv_time_mix_step(p, cfg, x, state):
    """Single-token decode. x: (B, 1, d); state = (x_prev (B, d), S (B, H, hs, hs))."""
    x_prev, S = state
    return rwkv_time_mix(p, cfg, x, x_prev, S)


def init_rwkv_state(cfg, batch, dtype, device=None):
    """(x_prev (B, d), S (B, H, hs, hs)) at zero; under a mesh scope S holds
    this rank's heads (`sharding.rwkv_heads`)."""
    hs = cfg.ssm.head_size
    return (torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
            torch.zeros((batch, SH.rwkv_heads(cfg), hs, hs),
                        dtype=torch.promote_types(dtype, torch.float32), device=device))


# -- RWKV channel mix (its FFN, also token-shifted) ---------------------------

def init_rwkv_channel_mix(gen, cfg, dtype):
    return {
        "mu_k": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
        "wk": L.dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
        "wv": L.dense_init(gen, cfg.d_ff, cfg.d_model, dtype),
    }


def rwkv_channel_mix(p, cfg, x, x_prev_init):
    """x: (B, T, d). Returns (y, x_last). Under a mesh scope that splits
    the hidden dim over 'model', wv's partial output is summed over it."""
    x_prev = torch.cat([x_prev_init[:, None], x[:, :-1]], dim=1)
    xk = x + (x_prev - x) * p["mu_k"].to(x.dtype)
    k = torch.square(F.relu(L.dense(p["wk"], xk)))
    y = L.dense(p["wv"], k)
    return (y if k.shape[-1] == cfg.d_ff else SH.model_sum(y)), x[:, -1]


# ===========================================================================
# Mamba / S6 (hymba's SSM heads)
# ===========================================================================

def init_mamba(gen, cfg, dtype):
    d = cfg.d_model
    s = cfg.ssm
    di = s.expand * d
    N = s.state_size
    dt_rank = s.dt_rank or max(1, -(-d // 16))
    dev = gen.device
    return {
        "in_proj": L.dense_init(gen, d, 2 * di, dtype),
        "conv_w": L._normal(gen, (s.conv_kernel, di), 0.5, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": L.dense_init(gen, di, dt_rank + 2 * N, dtype),
        "dt_proj": L.dense_init(gen, dt_rank, di, dtype, bias=True),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev)
                           .expand(di, N)).to(dtype),
        "D": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": L.dense_init(gen, di, d, dtype),
    }


def _mamba_conv_full(p, x):
    """Causal depthwise conv over (B, T, di) via explicit taps."""
    K = p["conv_w"].shape[0]
    T = x.shape[1]
    w = p["conv_w"].to(x.dtype)
    y = x * w[K - 1]
    for i in range(1, K):
        shifted = F.pad(x, (0, 0, i, 0))[:, :T]                 # x delayed by i steps
        y = y + shifted * w[K - 1 - i]
    return y + p["conv_b"].to(x.dtype)


def mamba_apply(p, cfg, x, state=None):
    """x: (B, T, d). state=None for a full sequence from a zero state;
    (conv_buf (B, K-1, di), h (B, di, N)) for a decode step (T == 1).
    Returns (y, (conv_buf, h)).

    Under a mesh scope that splits the inner dim over 'model' the params
    and states hold this rank's di/M channels: x_proj's and out_proj's
    partial outputs are summed over 'model', so dt_in, B and C, and y, are
    whole on every rank."""
    B, T, d = x.shape
    N = cfg.ssm.state_size
    dt_rank = p["dt_proj"]["w"].shape[0]
    z, xin = L.dense(p["in_proj"], x).chunk(2, dim=-1)           # (B, T, di) each
    di = xin.shape[-1]
    K = p["conv_w"].shape[0]

    if state is None:
        xc = _mamba_conv_full(p, xin)
        conv_buf_out = (xin[:, T - (K - 1):] if T >= K - 1
                        else F.pad(xin, (0, 0, K - 1 - T, 0)))
        h = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    else:
        conv_buf, h = state
        window = torch.cat([conv_buf, xin], dim=1)               # (B, K, di)
        xc = torch.einsum("bkd,kd->bd", window, p["conv_w"].to(x.dtype))[:, None]
        xc = xc + p["conv_b"].to(x.dtype)
        conv_buf_out = window[:, 1:]
    xc = F.silu(xc)

    split = di != cfg.ssm.expand * d
    proj = L.dense(p["x_proj"], xc)
    dt_in, Bc, Cc = (SH.model_sum(proj) if split else proj).split([dt_rank, N, N], dim=-1)
    dt = F.softplus(L.dense(p["dt_proj"], dt_in)).float()        # (B, T, di)
    A = -torch.exp(p["A_log"].float())                           # (di, N)
    dtx = dt * xc.float()
    Bf, Cf = Bc.float(), Cc.float()

    ys = []
    for t in range(T):
        dA = torch.exp(dt[:, t, :, None] * A)                    # (B, di, N)
        h = torch.addcmul(dA * h, dtx[:, t, :, None], Bf[:, t, None, :])
        ys.append(h @ Cf[:, t, :, None])                         # (B, di, 1)
    y = torch.cat(ys, dim=-1).transpose(1, 2).to(x.dtype)        # (B, T, di)
    y = y + xc * p["D"].to(x.dtype)
    y = L.dense(p["out_proj"], y * F.silu(z))
    return (SH.model_sum(y) if split else y), (conv_buf_out, h)


def init_mamba_state(cfg, batch, dtype, device=None):
    """(conv_buf (B, K-1, di), h (B, di, N)) at zero; under a mesh scope
    they hold this rank's channels (`sharding.mamba_channels`)."""
    di = SH.mamba_channels(cfg)
    return (torch.zeros((batch, cfg.ssm.conv_kernel - 1, di), dtype=dtype, device=device),
            torch.zeros((batch, di, cfg.ssm.state_size), dtype=torch.float32, device=device))
