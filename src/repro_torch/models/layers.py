"""Shared primitive layers: norms, RoPE, MLPs, embeddings.

Counterpart of `repro.models.layers`. Params are nested dicts of tensors in
the reference layout: dense weights are (d_in, d_out) and applied as
`x @ w`. Convention: `init_<layer>(gen, ...) -> params` draws from an
explicit `torch.Generator` on the device the params live on, and
`<layer>(params, x, ...) -> y`. Compute runs in the activations' dtype with
fp32 norm and softmax internals.

Model axis: every layer also takes params stacked on a leading model axis
M (the grouped theta + phi forward of the InfServer) with activations whose
leading axis is M. A layer tells the two apart by its weight's rank:
a dense weight is (d_in, d_out) or (M, d_in, d_out), a norm scale (d,) or
(M, d), an embedding table (V, d) or (M, V, d). Dense layers then become
batched matmuls and the norm kernel takes one weight row per model.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch


def _normal(gen: torch.Generator, shape, scale, dtype) -> torch.Tensor:
    """scale * N(0, 1) truncated to +-2 sigma (as jax.random.truncated_normal)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)     # in place: one fp32 temporary at expert scale


def dense_init(gen, d_in, d_out, dtype, bias=False, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def _per_model(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """View an (M, n) per-model row as (M, 1, ..., 1, n) against x."""
    return t.reshape(t.shape[0], *([1] * (x.dim() - 2)), t.shape[-1])


def dense(p, x):
    w = p["w"].to(x.dtype)
    if w.dim() == 3:                                   # (M, d_in, d_out)
        y = torch.bmm(x.reshape(x.shape[0], -1, x.shape[-1]), w)
        y = y.reshape(*x.shape[:-1], w.shape[-1])
    else:
        y = x @ w
    if "b" in p:
        b = p["b"].to(x.dtype)
        y = y + (_per_model(b, y) if b.dim() == 2 else b)
    return y


# -- norms -------------------------------------------------------------------

def rmsnorm_init(d, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-6):
    return dispatch.rmsnorm(x, p["scale"], eps=eps)


def layernorm_init(d, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def wide(x):
    """x in fp32, the precision every norm and recurrence keeps inside, or
    as it is when it is wider (an fp64 compute run, a rounding witness)."""
    return x if x.dtype == torch.float64 else x.float()


def layernorm(p, x, eps=1e-5):
    xf = wide(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    scale, bias = p["scale"].to(xf.dtype), p["bias"].to(xf.dtype)
    if scale.dim() == 2:
        scale, bias = _per_model(scale, x), _per_model(bias, x)
    return (y * scale + bias).to(x.dtype)


def norm_init(kind, d, dtype, device=None):
    return (rmsnorm_init(d, dtype, device) if kind == "rmsnorm"
            else layernorm_init(d, dtype, device))


def norm_apply(kind, p, x):
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# -- rotary embeddings ---------------------------------------------------------

def rope_freqs(head_dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta):
    """x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                        # (hd/2,)
    angles = positions[..., None].float() * freqs                  # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]                          # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention scale factor, 0.1 * mscale * ln(factor) + 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_freqs(dim: int, theta: float, s, device=None):
    """YaRN's inverse frequencies of `dim` rotary dims (DeepSeek-V3's
    `DeepseekV3YarnRotaryEmbedding`): the pairs below the correction range
    that `beta_fast` and `beta_slow` rotations over the original length
    give keep their frequency, those above it are divided by `factor`, and
    a linear ramp joins them. `s` is a `configs.YarnScaling`."""
    pos = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / theta ** pos
    inter = 1.0 / (s.factor * theta ** pos)

    def dim_of(rotations):
        return (dim * math.log(s.original_max_position / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(dim_of(s.beta_fast)), 0)
    high = min(math.ceil(dim_of(s.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0.0, 1.0)
    return inter * ramp + extra * (1.0 - ramp)


def apply_rope_pairs(x, positions, inv_freq, mscale: float = 1.0):
    """Rotary embeddings on adjacent pairs (2i, 2i + 1) of x's last axis,
    the pairing of DeepSeek-V3's checkpoints, written out as the rotated
    even dims then the rotated odd ones (the order its `apply_rotary_pos_emb`
    leaves them in). x: (..., T, H, dim); positions broadcastable to
    (..., T); cos and sin times `mscale`."""
    angles = positions[..., None].float() * inv_freq                 # (..., T, dim/2)
    cos = (torch.cos(angles) * mscale)[..., None, :]
    sin = (torch.sin(angles) * mscale)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# -- MLPs ----------------------------------------------------------------------

def act_fn(name):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu,
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp_init(gen, d_model, d_ff, dtype, gated=True, bias=False):
    p = {"up": dense_init(gen, d_model, d_ff, dtype, bias),
         "down": dense_init(gen, d_ff, d_model, dtype, bias)}
    if gated:
        p["gate"] = dense_init(gen, d_model, d_ff, dtype, bias)
    return p


def mlp(p, x, activation="silu"):
    a = act_fn(activation)
    h = dense(p["up"], x)
    if "gate" in p:
        h = a(dense(p["gate"], x)) * h
    else:
        h = a(h)
    return dense(p["down"], h)


# -- embedding -----------------------------------------------------------------

def embed_init(gen, vocab, d_model, dtype):
    return {"table": _normal(gen, (vocab, d_model), 1.0, dtype)}


def embed(p, tokens, compute_dtype, scale=False):
    table = p["table"].to(compute_dtype)
    if table.dim() == 3:                               # (M, V, d), tokens (M, ...)
        m = torch.arange(table.shape[0], device=tokens.device)
        x = table[m.reshape(-1, *([1] * (tokens.dim() - 1))), tokens]
    else:
        x = table[tokens]
    if scale:
        x = x * torch.tensor(math.sqrt(x.shape[-1]), dtype=compute_dtype)
    return x


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
