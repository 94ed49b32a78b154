"""GQA attention over a full sequence (counterpart of `repro.models.attention`).

Only the kernel route of `repro`'s `chunked_attend` is ported: every call
goes through `dispatch.attention`, which runs the flash-attention CUDA
kernel on CUDA tensors and its plain version on CPU tensors. `repro`'s
chunked CPU fast tier, decode and the ring-buffer KV cache come later.

Model axis: with params stacked on a leading model axis M, activations are
(M, B, T, d); the projections are batched matmuls and attention folds M
into the batch, since the models share no keys.
"""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.models import layers as L


def init_attention(gen, cfg, dtype):
    p = {
        "wq": L.dense_init(gen, cfg.d_model, cfg.q_dim, dtype, cfg.attn_bias),
        "wk": L.dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, cfg.attn_bias),
        "wv": L.dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, cfg.attn_bias),
        "wo": L.dense_init(gen, cfg.q_dim, cfg.d_model, dtype, bias=False),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(cfg.head_dim, dtype, gen.device)
        p["k_norm"] = L.rmsnorm_init(cfg.head_dim, dtype, gen.device)
    return p


def _project_qkv(p, cfg, x, positions):
    """x: (..., T, d) -> q (..., T, H, hd), k and v (..., T, KV, hd)."""
    lead = x.shape[:-1]
    q = L.dense(p["wq"], x).reshape(*lead, cfg.num_heads, cfg.head_dim)
    k = L.dense(p["wk"], x).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    v = L.dense(p["wv"], x).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q)
        k = L.rmsnorm(p["k_norm"], k)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attend(q, k, v, *, causal, window, cap, scale):
    """q: (B, T, H, hd); k, v: (B, T, KV, hd) -> (B, T, H, hd).

    The kernel route of `repro`'s `chunked_attend`: positions are the
    row indices (arange per row), which is the index-based masking the
    kernel applies. The (B, H, T, hd) views passed to the kernel are
    transposes, not copies; the output comes back in q's layout."""
    o = dispatch.attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), scale=scale, causal=causal,
                           window=window, cap=cap)
    return o.transpose(1, 2)


def full_attention(p, cfg, x, positions, *, layer_type="global"):
    """Full-sequence attention. x: (B, T, d) or (M, B, T, d).

    layer_type: 'global' (full causal) or 'local' (the config's sliding
    window). Encoder-only archs are bidirectional."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    lead = x.shape[:-2]                      # (B,) or (M, B)
    T = x.shape[-2]
    fold = lambda t: t.reshape(-1, T, *t.shape[-2:])
    window = cfg.sliding_window if (layer_type == "local" and cfg.sliding_window) else 0
    o = chunked_attend(fold(q), fold(k), fold(v), causal=not cfg.encoder_only,
                       window=window, cap=cfg.attn_logit_softcap,
                       scale=cfg.head_dim ** -0.5)
    return L.dense(p["wo"], o.reshape(*lead, T, cfg.q_dim))
