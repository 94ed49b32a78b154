"""GQA attention: full-sequence and cached decode (counterpart of
`repro.models.attention`).

Full sequence: only the kernel route of `repro`'s `chunked_attend` is
ported: every call goes through `dispatch.attention`, which runs the
flash-attention CUDA kernel on CUDA tensors and its plain version on CPU
tensors. `repro`'s chunked CPU fast tier is not ported.

Decode: a ring-buffer KV cache (`init_kv_cache`, `decode_attention`), so
`long_500k` decode holds O(window) state. One query token attends to the
cache through `_attend`, plain PyTorch on every device. That is no
fallback: `repro` computes decode attention outside any Pallas kernel too
(its `decode_attention` calls `_attend` directly, never
`dispatch.attention`), so there is no TPU kernel to port here.

Tensor parallelism: under a mesh scope a rank may hold a slice of the
heads (`distributed/sharding._Params.slice_of`): wq's columns for H/M
query heads, wk's and wv's for the key and value heads those read, and
wo's rows for them. The head counts are read from the weights, and the
output projection's partial sums are added over 'model'. A decode cache
follows `repro`'s `state_shardings` (`sharding.cache_mode`):
  - KV heads split: the rank's cache holds the KV/M heads it computes;
  - replicated: every rank computes and caches every KV head (wk and wv
    whole) and its H/M query heads read the ones they share
    (`_kv_for_q`);
  - the length split (context parallel): each rank holds a contiguous
    block of W/M slots of every head, and the attention block runs
    whole. A prefill writes each rank's own block (`fill_cache`); a
    decode step writes the new key on the rank that owns its slot, and
    each rank attends over its block, the partial results merged across
    'model' by the log-sum-exp rule (`_attend_split`). The positions stay
    whole on every rank.

Latent attention (`cfg.mla` set, DeepSeek-V3's
`DeepseekV3Attention` in its non-absorbed form): q = W_qb rmsnorm(W_qa x),
[c_kv, k_pe] = W_kva x, [k_nope, v] = W_kvb rmsnorm(c_kv); q's last
`qk_rope_head_dim` columns and k_pe (one for all heads) take rotary
embeddings (YaRN's where the config scales them) and k = [k_nope, k_pe];
the flash kernel takes q and k `qk_head_dim` wide and v `v_head_dim`
wide. Traced, the projections, latent norms and rope, and the output
projection, are each a phase `mla.project`. The full-sequence pass only:
there is no decode cache for it.

Model axis: with params stacked on a leading model axis M, activations are
(M, B, T, d); the projections are batched matmuls and attention folds M
into the batch, since the models share no keys. Decode has no model axis
(`repro`'s has none).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.utils import trace

NEG_INF = -2.0 ** 30  # large-negative that survives bf16/softcap fine


def init_attention(gen, cfg, dtype):
    if cfg.mla is not None:
        return init_mla(gen, cfg, dtype)
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


def init_mla(gen, cfg, dtype):
    m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
    dev = gen.device
    return {
        "wq_a": L.dense_init(gen, d, m.q_lora_rank, dtype),
        "q_a_norm": L.rmsnorm_init(m.q_lora_rank, dtype, dev),
        "wq_b": L.dense_init(gen, m.q_lora_rank, H * m.qk_head_dim, dtype),
        "wkv_a": L.dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dtype),
        "kv_a_norm": L.rmsnorm_init(m.kv_lora_rank, dtype, dev),
        "wkv_b": L.dense_init(gen, m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim),
                              dtype),
        "wo": L.dense_init(gen, H * m.v_head_dim, d, dtype),
    }


def mla_rope(cfg, device):
    """(inverse frequencies, cos/sin scale) of MLA's rotary dims."""
    dim, s = cfg.mla.qk_rope_head_dim, cfg.rope_scaling
    if s is None:
        return L.rope_freqs(dim, cfg.rope_theta, device), 1.0
    return (L.yarn_freqs(dim, cfg.rope_theta, s, device),
            L.yarn_mscale(s.factor, s.mscale) / L.yarn_mscale(s.factor, s.mscale_all_dim))


def mla_scale(cfg) -> float:
    """The softmax scale: qk_head_dim^-0.5, times YaRN's mscale squared
    where `mscale_all_dim` is set."""
    s = cfg.rope_scaling
    m = L.yarn_mscale(s.factor, s.mscale_all_dim) if s is not None and s.mscale_all_dim else 1.0
    return cfg.mla.qk_head_dim ** -0.5 * m * m


def mla_attention(p, cfg, x, positions):
    """Latent attention over the full sequence (module docstring). x: (B, T, d)."""
    m, H = cfg.mla, cfg.num_heads
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    lead = x.shape[:-1]
    with trace.phase("mla.project", x):
        q = L.dense(p["wq_b"], L.rmsnorm(p["q_a_norm"], L.dense(p["wq_a"], x)))
        q = q.reshape(*lead, H, m.qk_head_dim)
        c_kv, k_pe = L.dense(p["wkv_a"], x).split([m.kv_lora_rank, rope], dim=-1)
        kv = L.dense(p["wkv_b"], L.rmsnorm(p["kv_a_norm"], c_kv.contiguous()))
        k_nope, v = kv.reshape(*lead, H, nope + m.v_head_dim).split([nope, m.v_head_dim],
                                                                     dim=-1)
        inv_freq, mscale = mla_rope(cfg, x.device)
        q = torch.cat([q[..., :nope], L.apply_rope_pairs(q[..., nope:], positions, inv_freq,
                                                         mscale)], dim=-1)
        k_pe = L.apply_rope_pairs(k_pe[..., None, :], positions, inv_freq, mscale)
        k = torch.cat([k_nope, k_pe.expand(*lead, H, rope)], dim=-1)
    o = chunked_attend(q, k, v, causal=not cfg.encoder_only, window=0, cap=0.0,
                       scale=mla_scale(cfg))
    with trace.phase("mla.project", x):
        return L.dense(p["wo"], o.reshape(*lead, H * m.v_head_dim))


def _project_qkv(p, cfg, x, positions):
    """x: (..., T, d) -> q (..., T, H, hd), k and v (..., T, KV, hd); H and
    KV as many heads as the weights hold (a slice under tensor
    parallelism)."""
    lead = x.shape[:-1]
    q = L.dense(p["wq"], x).reshape(*lead, -1, cfg.head_dim)
    k = L.dense(p["wk"], x).reshape(*lead, -1, cfg.head_dim)
    v = L.dense(p["wv"], x).reshape(*lead, -1, cfg.head_dim)
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


def full_attention(p, cfg, x, positions, *, layer_type="global", return_kv=False):
    """Full-sequence attention. x: (B, T, d) or (M, B, T, d).

    layer_type: 'global' (full causal) or 'local' (the config's sliding
    window). Encoder-only archs are bidirectional. With `return_kv` the
    result is (y, k, v), k and v (..., T, KV, hd) after RoPE: what
    `prefill` writes into the decode cache."""
    if cfg.mla is not None:
        if return_kv or layer_type != "global" or x.dim() != 3:
            raise NotImplementedError(f"{cfg.name}: latent attention runs the full sequence "
                                      f"of a (B, T, d) batch, without a cache")
        return mla_attention(p, cfg, x, positions)
    q, k, v = _project_qkv(p, cfg, x, positions)
    lead = x.shape[:-2]                      # (B,) or (M, B)
    T = x.shape[-2]
    fold = lambda t: t.reshape(-1, T, *t.shape[-2:])
    window = cfg.sliding_window if (layer_type == "local" and cfg.sliding_window) else 0
    kq, vq = _kv_for_q(cfg, q, k, v)
    o = chunked_attend(fold(q), fold(kq), fold(vq), causal=not cfg.encoder_only,
                       window=window, cap=cfg.attn_logit_softcap,
                       scale=cfg.head_dim ** -0.5)
    y = _out(p, cfg, o.reshape(*lead, T, -1), q.shape[-2])
    return (y, k, v) if return_kv else y


def _kv_for_q(cfg, q, k, v):
    """The key and value heads that q's heads read: k and v as they are,
    or, when the rank holds a slice of the query heads over every key and
    value head (a decode cache replicated over 'model'), the ones its
    slice reads (head h reads h // G)."""
    Hl, KVl = q.shape[-2], k.shape[-2]
    if Hl == cfg.num_heads or KVl < cfg.num_kv_heads:
        return k, v
    G = cfg.num_heads // cfg.num_kv_heads
    lo = SH.model_index() * Hl // G
    n = -(-Hl // G)
    return k.narrow(-2, lo, n), v.narrow(-2, lo, n)


def _out(p, cfg, o, heads: int):
    """The output projection; over a slice of the heads, its partial sum
    is added over 'model'."""
    y = L.dense(p["wo"], o)
    return y if heads == cfg.num_heads else SH.model_sum(y)


def _scores(q, k, q_pos, k_pos, *, causal, window, cap, scale, k_valid):
    """Masked GQA scores (B, KV, G, Tq, Tk) in fp32: q . k in q's dtype,
    scaled, softcapped, NEG_INF where masked."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Tq, KV, H // KV, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k).float() * scale
    s = L.softcap(s, cap)
    qp = q_pos[:, None, None, :, None]
    kp = k_pos[:, None, None, None, :]
    mask = torch.ones((B, 1, 1, Tq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (qp - kp < window)
    if k_valid is not None:
        mask = mask & k_valid[:, None, None, None, :]
    return s.masked_fill(~mask, NEG_INF)


def _attend(q, k, v, q_pos, k_pos, *, causal, window, cap, scale, k_valid=None):
    """Plain masked GQA attention, `repro`'s `_attend`. q: (B, Tq, H, hd);
    k, v: (B, Tk, KV, hd); q_pos (B, Tq), k_pos (B, Tk) -> (B, Tq, H, hd).
    Scores in q's dtype, then an fp32 softmax; the probabilities are cast
    to v's dtype before p.V."""
    s = _scores(q, k, q_pos, k_pos, causal=causal, window=window, cap=cap, scale=scale,
                k_valid=k_valid)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskh->btkgh", w.to(v.dtype), v)
    return o.reshape(q.shape)


def _attend_split(q, k, v, q_pos, k_pos, *, causal, window, cap, scale, k_valid):
    """`_attend` over a cache whose slots are split over 'model', k, v and
    k_pos being this rank's block: each rank scores its own slots, and
    the partial results merge by the log-sum-exp rule, the max of the
    scores over every rank's, then the sums over 'model' of each rank's
    exp-weighted p.V and of its exp sums (fp32)."""
    s = _scores(q, k, q_pos, k_pos, causal=causal, window=window, cap=cap, scale=scale,
                k_valid=k_valid)
    p = torch.exp(s - SH.model_max(s.amax(-1, keepdim=True)))
    l = SH.model_sum(p.sum(-1))                                  # (B, KV, G, Tq)
    o = SH.model_sum(torch.einsum("bkgts,bskh->btkgh", p.to(v.dtype), v).float())
    return (o / l.permute(0, 3, 1, 2)[..., None]).to(v.dtype).reshape(q.shape)


# -- decode with (ring-buffer) KV cache ---------------------------------------

def init_kv_cache(cfg, batch, cache_len, dtype, prefilled: int = 0, device=None):
    """Cache of `cache_len` slots. `prefilled` marks how many are valid
    (dry-run decode shapes prefill the whole cache). Under a mesh scope
    the keys and values hold this rank's heads or block of slots
    (`sharding.cache_heads`, `cache_slots`); the positions are whole."""
    slots = SH.cache_slots(cache_len)[1]
    k = torch.zeros((batch, slots, SH.cache_heads(cfg), cfg.head_dim), dtype=dtype,
                    device=device)
    if prefilled:
        pos = torch.arange(cache_len, dtype=torch.int32, device=device).expand(
            batch, cache_len).contiguous()
        length = torch.full((batch,), prefilled, dtype=torch.int32, device=device)
    else:
        pos = torch.full((batch, cache_len), -1, dtype=torch.int32, device=device)
        length = torch.zeros((batch,), dtype=torch.int32, device=device)
    return {"k": k, "v": torch.zeros_like(k), "pos": pos, "length": length}


def fill_cache(cache, k, v, positions, start: int, slots):
    """Write a prompt's keys, values and positions from `start` on into
    `cache`: position t at slot t mod cache_len, `slots` those slots (on
    k's device). A rank that holds a block of the slots
    (`sharding.cache_slots`) writes the keys and values that fall in it;
    the positions are written whole."""
    W, T = cache["pos"].shape[1], k.shape[1]
    cache["pos"][:, slots] = positions[:, start:]
    lo, n = SH.cache_slots(W)
    if n == W:
        cache["k"][:, slots] = k[:, start:]
        cache["v"][:, slots] = v[:, start:]
        return
    host = torch.arange(start, T) % W            # this rank's block, indexed on the host
    mine = (host >= lo) & (host < lo + n)
    dst, src = (host[mine] - lo).to(k.device), torch.arange(start, T)[mine].to(k.device)
    cache["k"][:, dst] = k[:, src]
    cache["v"][:, dst] = v[:, src]


def decode_attention(p, cfg, x, cache, *, layer_type="global", window_override=0,
                     uniform=False):
    """One-token decode. x: (B, 1, d). Returns (y, cache).

    The new k/v is written at slot (length mod cache_len), a ring buffer:
    with window_override=W and cache_len=W this is O(W) memory at any
    sequence length (the sub-quadratic long_500k variant).

    Unlike `repro`, which returns a new cache, the write is in place:
    `cache["k"]`, `["v"]` and `["pos"]` (views into the decode state's
    stacked tensors) get one slot per row, O(B * KV * hd) bytes, and the
    returned cache holds the same tensors with `length` advanced.
    `uniform=True` (every row at the same position, as the serving demo
    decodes) writes every row at row 0's slot with `index_copy_`;
    otherwise each row is scattered to its own slot. The slot stays on the
    device: no host sync. Over a cache whose slots are split over 'model',
    a rank writes the key and value only where it owns the slot (a
    select, still without a sync) and attends over its block
    (`_attend_split`)."""
    B, T, _ = x.shape
    if T != 1:
        raise ValueError(f"decode_attention takes one token per row, got T={T}")
    t = cache["length"]                              # (B,) current position
    q, k, v = _project_qkv(p, cfg, x, t[:, None])
    kc, vc, pc = cache["k"], cache["v"], cache["pos"]
    W = pc.shape[1]
    lo, n = SH.cache_slots(W)
    slot = ls = (t % W).long()
    if n != W:                 # the slot in this rank's block; the old key where not its own
        ls = (slot - lo).clamp(0, n - 1)
        own = ((slot >= lo) & (slot < lo + n))[:, None, None, None]
        if uniform:
            own, ls = own[:1], ls[:1]
            k = torch.where(own, k, kc.index_select(1, ls))
            v = torch.where(own, v, vc.index_select(1, ls))
        else:
            b_idx = torch.arange(B, device=x.device)
            k = torch.where(own, k, kc[b_idx, ls][:, None])
            v = torch.where(own, v, vc[b_idx, ls][:, None])
    if uniform:
        kc.index_copy_(1, ls[:1], k)
        vc.index_copy_(1, ls[:1], v)
        pc.index_copy_(1, slot[:1], t[:, None])
    else:
        b_idx = torch.arange(B, device=x.device)
        kc[b_idx, ls] = k[:, 0]
        vc[b_idx, ls] = v[:, 0]
        pc[b_idx, slot] = t

    window = window_override or (cfg.sliding_window if layer_type == "local" else 0)
    kw = dict(causal=True, window=window, cap=cfg.attn_logit_softcap,
              scale=cfg.head_dim ** -0.5)
    if n != W:
        kp = pc[:, lo:lo + n]
        o = _attend_split(q, kc, vc, t[:, None], kp, k_valid=kp >= 0, **kw)
    else:
        kq, vq = _kv_for_q(cfg, q, kc, vc)
        o = _attend(q, kq, vq, t[:, None], pc, k_valid=pc >= 0, **kw)
    y = _out(p, cfg, o.reshape(B, 1, -1), q.shape[-2])
    return y, {"k": kc, "v": vc, "pos": pc, "length": t + 1}
