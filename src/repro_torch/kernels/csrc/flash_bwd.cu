// Flash-attention backward for Hopper (sm_90a): the FlashAttention-2
// recompute scheme in two kernels.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_bwd_preprocess -> _bwd_preprocess_kernel:
//     delta = rowsum(dO * O), fp32 (B, H, Tq), here the prologue of dq;
//   flash_attention_bwd_dq -> _bwd_dq_kernel, and
//   flash_attention_bwd_dkv -> _bwd_dkv_kernel, with the tile math of
//   _tile_grads: s = q k^T * scale, softcapped as t = tanh(s / cap),
//   s = t * cap; p = exp(s - lse); dp = dO v^T; ds = p (dp - delta),
//   times (1 - t^2) under the softcap; dq = ds k * scale,
//   dk = ds^T q * scale, dv = p^T dO.
//
// What bounds it on the card: at the learner's sequence shape (T = 4096,
// window 512, head_dim 32, fp32) the recompute: ~6 d flops per live
// (q, k) pair in the dq pass and ~8 d in the dk/dv pass, on the CUDA cores
// in IEEE fp32 (67 TFLOP/s). At the env shape (T = 26, 512 sequences,
// bf16) device memory: dq reads q, k, v, o, dO and writes dq and delta
// (~17 MB), dk/dv reads q, k, v, dO and writes dk, dv (~14 MB).
//
// Design. Both kernels stack the G query heads of a KV head position-major
// (stacked row r is position r / G of query head kvh * G + r % G, as
// flash_fwd.cu), so a block loads its KV head's K/V once for the whole
// group (GQA reuse), and each has two regimes chosen by dtype: bf16 inputs
// on the tensor cores (mma.sync m16n8k16, ldmatrix fragments, p and ds fed
// as bf16 hi + lo so they keep fp32 precision as _tile_grads does), fp32
// inputs register-tiled on the CUDA cores in IEEE fp32 (no TF32).
// - dq: one block per (tile of stacked q rows, KV head, batch) sweeping the
//   live KV tiles (up to the diagonal when causal, from the window's
//   horizon, up to kv_len: the _tile_live skips), K/V double-buffered with
//   cp.async. Its prologue computes delta for its rows from dO and o,
//   staged with q (o, as the forward stored it in q's dtype, as
//   _bwd_preprocess_kernel reads it, goes to the second K/V buffer, free
//   until the second KV tile), and writes it for dk/dv: every stacked
//   row has exactly one owner, which writes its delta whether or not the
//   row has a live key, so no separate pass (and launch) is needed.
// - dk/dv: one block per (KV tile, KV head, batch) looping over the live q
//   tiles of the whole group (below). dk and dv are written per KV head:
//   repro's per-query-head buffers and their group sum (a TPU grid-order
//   constraint, kernel.py:328-332) are gone.
// - No atomics: every output element has one owner and a fixed summation
//   order, so two calls are bitwise equal.
// - Masked entries get p = 0 and ds = 0 explicitly rather than through
//   exp(NEG_INF - lse): a row with no live key has lse = 0 from the port's
//   forward, and only the mask zeroes it.
// - q, k, v, o, dO and the gradients are addressed through (batch, head,
//   time) strides, so the model's (B, T, H, d) layout needs no transpose
//   copy. Tiles load with 16-byte cp.async: rows and base pointers must be
//   16-byte aligned (the wrapper checks).
// - Latent attention (DeepSeek-V3's MLA, Kimi K2's) has q and k 192 wide
//   and v 128: bwd_dq_bf16_dv<192, 128> and bwd_dkv_bf16_dv<192, 128> are
//   the bf16 kernels' bodies with every tile at its own width and pitch
//   (S and dK over 192 columns, dP, dV and delta over 128), nothing padded
//   to 256. The tiling is the D = 128 kernels': dq's 64 rows x 32 keys in
//   halves of 16 (96 dq accumulators a lane), dk/dv's 32 keys x 32-row q
//   tiles (160 dk and dv accumulators); at H = KV = 64, T = 8192 that is
//   128 x 64 and 256 x 64 blocks, enough to fill the card without larger
//   tiles, whose accumulators would not fit beside the S fragments. The
//   D == DV instantiations keep their loops as they were (`if constexpr`),
//   so their code is unchanged. No fp32 regime at these widths.
// - dk/dv on Hopper's warpgroup MMA (bwd_dkv_wgmma, below): bf16 at (D, DV)
//   = (128, 128) and (192, 128) once Tk holds a 128-key tile, the learner
//   cells' long unrolls (ops.py `dkv_design` routes by shape and dtype; the
//   kernels above keep every other input: the env step's T = 26, where a
//   128-key block would be 80 % padding and 32-key blocks fill the card in
//   one wave, the other widths, fp32). What bounds it: the tensor cores.
//   Executed, it is 2 (D + DV) flops a live pair for S^T and dP^T and 4 (D
//   + DV) for dV and dK (P and dS enter as bf16 hi + lo), 1,920 at (192,
//   128), against the 1,280 the roofline counts; each Q and dO byte meets
//   128 keys, ~380 flops a byte read, above the card's ~295. What the
//   mma.sync kernel lost and this one answers: 2-warp blocks of 32 keys (6
//   warps an SM) restaging every Q and dO tile with cp.async (each byte met
//   32 keys), and mma.sync, which cannot reach the tensor cores' rate. Here
//   a block owns 128 keys, with K and V loaded once by TMA; a producer warp
//   streams Q and dO tiles through a 4-slot ring by TMA (another warp
//   writes the tiles' lse, delta and positions); two consumer warpgroups
//   of 64 keys run wgmma (S^T, dP^T from shared memory; dV, dK with P^T and
//   dS^T as register operands, nothing back through shared memory) with
//   240 registers a thread (setmaxnreg). The elementwise work between the
//   products is what remains in the way: a tile in which every pair is
//   live skips the masks, and without a softcap P^T is computed while dP^T
//   is still on the tensor cores; the two warpgroups overlap each other's.
#include "common.cuh"

#include <type_traits>

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;       // dq only
  const void* dout;
  const float* lse;    // (B, H, Tq) contiguous
  float* delta;        // (B, H, Tq) contiguous: written by dq, read by dk/dv
  void* dq;
  void* dk;
  void* dv;
  int B, H, KV, Tq, Tk;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot, sdob, sdoh, sdot;
  long long sgqb, sgqh, sgqt, sgkb, sgkh, sgkt, sgvb, sgvh, sgvt;  // dq, dk, dv
  float scale;
  int causal, window;
  float cap;
  int kv_len;
  float inv_cap;  // 1 / cap (0 without a softcap)
};

constexpr float kLog2e = 1.4426950408889634f;

// The recomputed probability and score gradient of one (query, key) pair.
// The softcap multiplies by 1 / cap, as flash_fwd.cu does, so s is the
// forward's s bit for bit (and there is no division per pair); p is
// exp2((s - lse) log2 e) with the product fused, ~1e-6 relative to expf.
__device__ __forceinline__ void pair_grads(float s, float dp, float lse, float delta,
                                           bool live, const BwdParams& p, float& pj,
                                           float& ds) {
  s *= p.scale;
  float dtanh = 1.f;
  if (p.cap > 0.f) {
    const float t = tanhf(s * p.inv_cap);
    s = t * p.cap;
    dtanh = 1.f - t * t;
  }
  pj = live ? exp2f(fmaf(s, kLog2e, -lse * kLog2e)) : 0.f;  // masked: exactly 0
  ds = live ? pj * (dp - delta) * dtanh : 0.f;
}

__device__ __forceinline__ bool pair_live(int qpos, int j, int kv_end, const BwdParams& p) {
  bool live = j < kv_end;
  if (p.causal) live = live && j <= qpos;
  if (p.window > 0) live = live && qpos - j < p.window;
  return live;
}

// KV tile kt (BN keys) of K and V into shared memory (zeros past Tk); V
// DV wide at pitch LDV.
template <typename T, int D, int BN, int LD, int THREADS, int DV = D, int LDV = LD>
__device__ __forceinline__ void stage_kv_tile(const BwdParams& p, int b, int kvh, int kt,
                                              T* Kd, T* Vd) {
  const T* kb = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* vb = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;
  const int k0 = kt * BN, Tk = p.Tk;
  const long long skt = p.skt, svt = p.svt;
  repro::stage_rows<T, D, BN, LD, THREADS>(Kd, [=](int i) -> const T* {
    return k0 + i < Tk ? kb + (k0 + i) * skt : nullptr;
  });
  repro::stage_rows<T, DV, BN, LDV, THREADS>(Vd, [=](int i) -> const T* {
    return k0 + i < Tk ? vb + (k0 + i) * svt : nullptr;
  });
}

// -- dq, with delta in its prologue ------------------------------------------

// Live keys [lo, hi) of query positions [t_min, t_max], as flash_fwd.cu.
__device__ __forceinline__ void key_range(const BwdParams& p, int t_min, int t_max, int& lo,
                                          int& hi) {
  hi = min(p.Tk, p.kv_len);
  if (p.causal) hi = min(hi, t_max + 1);
  lo = p.window > 0 ? max(0, t_min - p.window + 1) : 0;
}

// (b, query head, position) row of lse and delta of stacked row r.
__device__ __forceinline__ long long stat_row(const BwdParams& p, int b, int kvh, int r) {
  const int G = p.H / p.KV;
  return (static_cast<long long>(b) * p.H + kvh * G + r % G) * p.Tq + r / G;
}

// a . b over one 16-byte chunk, in fp32, added to acc in element order.
__device__ __forceinline__ float dot_chunk(const float* a, const float* b, float acc) {
  return repro::dot4(*reinterpret_cast<const float4*>(a), *reinterpret_cast<const float4*>(b),
                     acc);
}

__device__ __forceinline__ float dot_chunk(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                           float acc) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const unsigned xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 fx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[u]));
    const float2 fy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[u]));
    acc = fmaf(fx.y, fy.y, fmaf(fx.x, fy.x, acc));
  }
  return acc;
}

// Lanes that share a row in row_deltas: the largest power of two that
// divides the row's chunks, at most a warp (10 chunks of bf16 at D = 80: 2
// lanes of 5 chunks each).
__host__ __device__ constexpr int row_lanes(int chunks) {
  int w = 1;
  while (w < 32 && chunks % (2 * w) == 0) w *= 2;
  return w;
}

// The prologue: delta = rowsum(dO * O) of stacked rows [r0, r0 + BM) from
// the staged O and dO tiles (pitch LD), in 16-byte chunks. W lanes share a
// row and reduce with shuffles in a fixed order. Writes Ds[BM] (0 past the
// end) and p.delta for every row of the block before R, live keys or not.
template <typename T, int D, int BM, int LD, int THREADS>
__device__ __forceinline__ void row_deltas(const BwdParams& p, int b, int kvh, int r0,
                                           const T* Os, const T* dOs, float* Ds) {
  constexpr int E = 16 / sizeof(T);     // elements per chunk
  constexpr int CH = D / E;             // chunks per row
  constexpr int W = row_lanes(CH);      // lanes per row
  constexpr int RPP = THREADS / W;      // rows per pass of the block
  constexpr int PASSES = (BM + RPP - 1) / RPP;
  // every lane of a warp makes the same passes: whole passes, or one pass
  // in which the warps past row BM have no row at all
  static_assert(BM % RPP == 0 || (PASSES == 1 && BM * W % 32 == 0), "row_deltas' passes");
  const int R = p.H / p.KV * p.Tq;
  const int sub = threadIdx.x % W;
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    const int i = pass * RPP + threadIdx.x / W, r = r0 + i;
    if (i >= BM) break;  // warp-uniform
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < CH / W; ++m) {  // rows past the end are staged as zeros
      const int c = i * LD + (sub + m * W) * E;
      acc = dot_chunk(Os + c, dOs + c, acc);
    }
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(repro::kFullMask, acc, off);
    if (sub == 0) {
      Ds[i] = acc;
      if (r < R) p.delta[stat_row(p, b, kvh, r)] = acc;
    }
  }
}

// Stage stacked rows [r0, r0 + BM) of q, dO and o (zeros past the end);
// dO and o DV wide at pitch LDV.
template <typename T, int D, int BM, int LD, int THREADS, int DV = D, int LDV = LD>
__device__ __forceinline__ void stage_q_rows(const BwdParams& p, int b, int kvh, int r0,
                                             T* Qs, T* dOs, T* Os) {
  const int G = p.H / p.KV, R = G * p.Tq;
  auto rows = [=](const void* base, long long sb, long long sh, long long st) {
    const T* at = static_cast<const T*>(base) + b * sb + kvh * G * sh;
    return [=](int i) -> const T* {
      const int r = r0 + i;
      return r < R ? at + (r % G) * sh + (r / G) * st : nullptr;
    };
  };
  repro::stage_rows<T, D, BM, LD, THREADS>(Qs, rows(p.q, p.sqb, p.sqh, p.sqt));
  repro::stage_rows<T, DV, BM, LDV, THREADS>(dOs, rows(p.dout, p.sdob, p.sdoh, p.sdot));
  repro::stage_rows<T, DV, BM, LDV, THREADS>(Os, rows(p.o, p.sob, p.soh, p.sot));
}

// bf16 inputs: tensor cores. 4 warps of 16 stacked rows (64 rows: the env
// step's 2 x 26 rows of a group are one block, 1024 blocks), KV tiles of 32
// keys (T = 26 is one tile). A tile is computed in two halves of 16 keys,
// one after the other: S = Q K^T and dP = dO V^T from ldmatrix fragments,
// then dS on the accumulator fragments, then dQ += dS K with dS as the A
// fragment straight from registers (bf16 hi + lo, two MMAs) and K as B
// fragments by ldmatrix.trans, as the forward's P V takes V. Halves keep
// the kernel at 64 registers, so 8 blocks fit an SM and the env step's 1024
// blocks run in one wave (whole 32-key tiles took 79 registers and two
// waves). A warp skips a tile in which none of its rows has a live key.
constexpr int kDqBf16Threads = 128;

// q and k are D wide, dO, o and v DV (D == DV but for latent attention's
// (192, 128)); each tile is staged at its own pitch.
template <int D, int DV = D> struct DqBf16 {
  static constexpr int BM = 64, BN = 32, LD = D + 8;  // 16*odd-byte pitch: ldmatrix conflict-free
  static constexpr int LDV = DV + 8;
  static constexpr int KV = BN * (LD + LDV);          // one K/V buffer
  static constexpr int smem = (BM * (LD + LDV) + 2 * KV) * 2 + BM * 4;
};

template <int D, int DV>
__device__ __forceinline__ void dq_bf16(const BwdParams& p) {
  using T = __nv_bfloat16;
  constexpr int THREADS = kDqBf16Threads;
  constexpr int BM = DqBf16<D, DV>::BM, BN = DqBf16<D, DV>::BN, LD = DqBf16<D, DV>::LD;
  constexpr int LDV = DqBf16<D, DV>::LDV, KVB = DqBf16<D, DV>::KV;
  constexpr int DT = D / 8;   // dq n-tiles per warp
  static_assert(D % 16 == 0 && DV % 16 == 0, "k-steps of 16 columns; n-tiles taken in pairs");
  extern __shared__ float4 smem4[];
  static_assert(BM * LDV <= KVB, "o is staged in the second K/V buffer");
  T* Qs = reinterpret_cast<T*>(smem4);                     // [BM][LD]
  T* dOs = Qs + BM * LD;                                   // [BM][LDV]
  T* KVs = dOs + BM * LDV;                                 // [2][K [BN][LD], V [BN][LDV]]; o in [1]
  float* Ds = reinterpret_cast<float*>(KVs + 2 * KVB);     // [BM]

  const int b = blockIdx.z, kvh = blockIdx.y, r0 = blockIdx.x * BM;
  const int G = p.H / p.KV, R = G * p.Tq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, cq = lane & 3;

  stage_q_rows<T, D, BM, LD, THREADS, DV, LDV>(p, b, kvh, r0, Qs, dOs, KVs + KVB);
  repro::cp_async_commit();
  int lo, hi;
  key_range(p, r0 / G, (min(r0 + BM, R) - 1) / G, lo, hi);
  const int kt_lo = lo / BN, kt_hi = hi > lo ? (hi + BN - 1) / BN : kt_lo;
  auto stage_kv = [&](int kt, int buf) {
    T* K = KVs + buf * KVB;
    stage_kv_tile<T, D, BN, LD, THREADS, DV, LDV>(p, b, kvh, kt, K, K + BN * LD);
  };
  if (kt_lo < kt_hi) stage_kv(kt_lo, 0);
  repro::cp_async_commit();

  // this warp's rows and their own live keys, to skip a tile they do not see
  const int wr0 = r0 + warp * 16;
  int wlo = 0, whi = 0;
  if (wr0 < R) key_range(p, wr0 / G, (min(wr0 + 16, R) - 1) / G, wlo, whi);
  const int ra = wr0 + gq, rb = ra + 8;  // this lane's two rows
  const int ta = ra < R ? ra / G : -1, tb = rb < R ? rb / G : -1;
  const int kv_end = min(p.Tk, p.kv_len);
  const float lse_a = ta >= 0 ? p.lse[stat_row(p, b, kvh, ra)] : 0.f;
  const float lse_b = tb >= 0 ? p.lse[stat_row(p, b, kvh, rb)] : 0.f;

  repro::cp_async_wait<1>();  // Q, dO and O landed (the first KV tile may not have)
  __syncthreads();
  row_deltas<T, DV, BM, LDV, THREADS>(p, b, kvh, r0, KVs + KVB, dOs, Ds);
  __syncthreads();  // delta is in Ds; O's buffer is free for KV tile kt_lo + 1
  const float delta_a = Ds[warp * 16 + gq], delta_b = Ds[warp * 16 + gq + 8];

  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    repro::cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < kt_hi) stage_kv(kt + 1, buf ^ 1);
    repro::cp_async_commit();
    const int k0 = kt * BN;
    if (k0 >= whi || k0 + BN <= wlo) continue;  // warp-uniform: no live key for these rows
    const T* Kt = KVs + buf * KVB;
    const T* Vt = Kt + BN * LD;

    // two halves of 16 keys, one after the other: half the S and dP
    // accumulators live at a time
#pragma unroll 1
    for (int hk = 0; hk < BN / 16; ++hk) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // fragment offsets of k-step kk at pitch ld: A rows of this warp, B keys of this half
      const auto a_at = [&](int kk, int ld) {
        return (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + kk * 16 + (lane >> 4) * 8;
      };
      const auto b_at = [&](int kk, int ld) {
        return (hk * 16 + (lane & 7) + (lane >> 4) * 8) * ld + kk * 16 + ((lane >> 3) & 1) * 8;
      };
      if constexpr (D == DV) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a_off = a_at(kk, LD), b_off = b_at(kk, LD);
          unsigned aq[4], ad[4], bk[4], bv[4];
          repro::ldmatrix_x4(aq, Qs + a_off);
          repro::ldmatrix_x4(bk, Kt + b_off);
          repro::mma_bf16(s[0], aq, bk[0], bk[1]);
          repro::mma_bf16(s[1], aq, bk[2], bk[3]);
          repro::ldmatrix_x4(ad, dOs + a_off);
          repro::ldmatrix_x4(bv, Vt + b_off);
          repro::mma_bf16(dp[0], ad, bv[0], bv[1]);
          repro::mma_bf16(dp[1], ad, bv[2], bv[3]);
        }
      } else {  // S over q's and k's D columns, dP over dO's and v's DV
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          unsigned aq[4], bk[4];
          repro::ldmatrix_x4(aq, Qs + a_at(kk, LD));
          repro::ldmatrix_x4(bk, Kt + b_at(kk, LD));
          repro::mma_bf16(s[0], aq, bk[0], bk[1]);
          repro::mma_bf16(s[1], aq, bk[2], bk[3]);
        }
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
          unsigned ad[4], bv[4];
          repro::ldmatrix_x4(ad, dOs + a_at(kk, LDV));
          repro::ldmatrix_x4(bv, Vt + b_at(kk, LDV));
          repro::mma_bf16(dp[0], ad, bv[0], bv[1]);
          repro::mma_bf16(dp[1], ad, bv[2], bv[3]);
        }
      }
      // element e of n-tile n: row (e < 2 ? ra : rb), key k0 + 16 hk + 8 n + 2 cq + (e & 1)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? ta : tb;
          const int j = k0 + hk * 16 + n * 8 + 2 * cq + (e & 1);
          const bool live = t >= 0 && pair_live(t, j, kv_end, p);
          float pj, ds;
          pair_grads(s[n][e], dp[n][e], e < 2 ? lse_a : lse_b, e < 2 ? delta_a : delta_b, live,
                     p, pj, ds);
          s[n][e] = ds;
        }
      // dQ += dS K over these 16 keys: the dS accumulators are the A fragment
      unsigned ah[4], al[4];
      repro::split_bf16(s[0][0], s[0][1], ah[0], al[0]);
      repro::split_bf16(s[0][2], s[0][3], ah[1], al[1]);
      repro::split_bf16(s[1][0], s[1][1], ah[2], al[2]);
      repro::split_bf16(s[1][2], s[1][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        unsigned bk[4];
        repro::ldmatrix_x4_trans(bk, Kt + (hk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                                         + n * 8 + (lane >> 4) * 8);
        repro::mma_bf16(dq[n], ah, bk[0], bk[1]);
        repro::mma_bf16(dq[n + 1], ah, bk[2], bk[3]);
        repro::mma_bf16(dq[n], al, bk[0], bk[1]);
        repro::mma_bf16(dq[n + 1], al, bk[2], bk[3]);
      }
    }
  }

  repro::cp_async_wait_all();  // no copy outlives the block (an empty sweep)
  T* dqb = static_cast<T*>(p.dq) + b * p.sgqb + kvh * G * p.sgqh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rb : ra, t = r ? tb : ta;
    if (t < 0) continue;
    T* qrow = dqb + (row % G) * p.sgqh + t * p.sgqt + 2 * cq;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<unsigned*>(qrow + n * 8) =
          repro::pack_bf16(dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kDqBf16Threads) bwd_dq_bf16(const BwdParams p) {
  dq_bf16<D, D>(p);
}

// Latent attention's (192, 128): 12 k-steps for S, 8 for dP, 24 n-tiles of
// dq (96 accumulators a lane); shared memory 77 KB, 2 blocks an SM.
template <int D, int DV>
__global__ void __launch_bounds__(kDqBf16Threads) bwd_dq_bf16_dv(const BwdParams p) {
  dq_bf16<D, DV>(p);
}

// fp32 inputs: register-tiled CUDA cores, IEEE fp32. 256 threads on a tile
// of 64 stacked rows (32 positions x G = 2 at the seq step: 256 blocks at
// T = 4096 with 2 KV heads, ~2 per SM of 132, 16 warps each) and KV tiles
// of 32 keys. As in dk/dv, shared-memory bandwidth (one 128-byte wavefront
// per clock against 128 FMAs) is what bounds a register-tiled fp32 product
// here, so each phase gives a lane a micro-tile whose warp reads hit at
// most 8 distinct 16-byte chunks per load (one wavefront):
// - Phase 1: warp w covers keys 16 (w % 2) .. + 15 and a quarter of the
//   rows; lane (kg, rg) = (lane % 8, lane / 8) computes S and dP for keys
//   kg + 8 i (i < 2) and rows rg + 4 j from float4 reads of Q, dO, K and V
//   (64 FMAs per 12 wavefronts), then dS, which goes to shared memory
//   (pitch BN + 8: the stores of 4 rows x 8 keys hit 32 banks).
// - Phase 2: the block's two halves take alternate groups of 4 keys;
//   thread (rg, cg) of a half owns dq of rows rg + 16 i (i < 4) at columns
//   4 cg + 32 c (64 FMAs per 8 wavefronts: 4 float4 reads of dS and 4 of
//   K); a head dim that is not a multiple of 32 (hubert's 80) ends with a
//   pass of 16 columns that lanes cg < 4 take. At the end the second half's sums are added to the first's in a
//   fixed order, so the result stays deterministic. Splitting the keys
//   doubles the micro-tile (4 x 4 against 2 x 4) for one exchange per block.
// A tile whose pairs are all live skips the per-pair masks. Larger head
// dims take 32-row tiles (shared memory, registers). 64-key tiles (4 x 4
// in phase 1) needed 152 registers, one block per SM, and were slower.
constexpr int kDqF32Threads = 256;

template <int D> struct DqF32 {
  static constexpr int BM = D <= 64 ? 64 : 32, BN = 32, LD = D + 4, PLD = BN + 8;
  static constexpr int smem = ((2 * BM + 4 * BN) * LD + BM * PLD + BM) * 4;
};

template <int D>
__global__ void __launch_bounds__(kDqF32Threads) bwd_dq_f32(const BwdParams p) {
  constexpr int THREADS = kDqF32Threads;
  constexpr int BM = DqF32<D>::BM, BN = DqF32<D>::BN, LD = DqF32<D>::LD;
  constexpr int PLD = DqF32<D>::PLD;
  constexpr int RW = BM / 4;   // rows per warp pair in phase 1
  constexpr int RJ = RW / 4;   // rows per lane in phase 1
  constexpr int KI = BN / 16;  // keys per lane in phase 1
  constexpr int RI = BM / 16;  // rows per thread in phase 2
  constexpr int CJ = (D + 31) / 32;  // float4 columns per thread and row in phase 2
  static_assert(D % 16 == 0, "the last column pass takes 16 or 32 columns");
  static_assert(BM * D <= 2 * BM * LD, "phase 2's partial sums fit in the q tile");
  static_assert(BM <= 2 * BN, "o is staged in the second K/V buffer");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BM][LD]
  float* dOs = Qs + BM * LD;                    // [BM][LD]
  float* KVs = dOs + BM * LD;                   // [2][K, V][BN][LD]; o in [1]
  float* dSs = KVs + 4 * BN * LD;               // [BM][PLD]
  float* Ds = dSs + BM * PLD;                   // [BM]

  const int b = blockIdx.z, kvh = blockIdx.y, r0 = blockIdx.x * BM;
  const int G = p.H / p.KV, R = G * p.Tq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key1 = BN / 2 * (warp & 1) + (lane & 7);  // phase 1: keys key1 + 8 i
  const int r1 = RW * (warp >> 1) + (lane >> 3);  // phase 1: rows r1 + 4 j
  const int half = threadIdx.x >> 7;              // phase 2: key groups 2 m + half
  const int rg = (threadIdx.x & 127) >> 3, cg = threadIdx.x & 7;  // phase 2
  // phase 2's column pass c of this lane (c < D / 32 folds to true)
  const bool tail_cols = 4 * cg + 32 * (CJ - 1) < D;
  const auto has_cols = [tail_cols](int c) { return c < D / 32 || tail_cols; };

  stage_q_rows<float, D, BM, LD, THREADS>(p, b, kvh, r0, Qs, dOs, KVs + 2 * BN * LD);
  repro::cp_async_commit();
  const int t_min = r0 / G, t_max = (min(r0 + BM, R) - 1) / G;
  int lo, hi;
  key_range(p, t_min, t_max, lo, hi);
  const int kt_lo = lo / BN, kt_hi = hi > lo ? (hi + BN - 1) / BN : kt_lo;
  auto stage_kv = [&](int kt, int buf) {
    float* K = KVs + buf * 2 * BN * LD;
    stage_kv_tile<float, D, BN, LD, THREADS>(p, b, kvh, kt, K, K + BN * LD);
  };
  if (kt_lo < kt_hi) stage_kv(kt_lo, 0);
  repro::cp_async_commit();

  const int kv_end = min(p.Tk, p.kv_len);
  int t1[RJ];  // positions of this lane's phase-1 rows, -1 past the end
  float lse1[RJ], delta1[RJ];
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    const int r = r0 + r1 + 4 * j;
    t1[j] = r < R ? r / G : -1;
    lse1[j] = r < R ? p.lse[stat_row(p, b, kvh, r)] : 0.f;
  }

  repro::cp_async_wait<1>();  // Q, dO and O landed (the first KV tile may not have)
  __syncthreads();
  row_deltas<float, D, BM, LD, THREADS>(p, b, kvh, r0, KVs + 2 * BN * LD, dOs, Ds);
  __syncthreads();  // delta is in Ds; O's buffer is free for KV tile kt_lo + 1
#pragma unroll
  for (int j = 0; j < RJ; ++j) delta1[j] = Ds[r1 + 4 * j];

  float acc[RI][CJ][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    repro::cp_async_wait_all();
    __syncthreads();  // tile kt landed; tile kt - 1 and dSs are consumed
    if (kt + 1 < kt_hi) stage_kv(kt + 1, buf ^ 1);
    repro::cp_async_commit();
    const int k0 = kt * BN;
    const float* Kt = KVs + buf * 2 * BN * LD;
    const float* Vt = Kt + BN * LD;
    // every pair of the tile live (block-uniform): skip the per-pair masks
    const bool full = r0 + BM <= R && k0 + BN <= kv_end
                      && (!p.causal || k0 + BN - 1 <= t_min)
                      && (p.window <= 0 || t_max - k0 < p.window);

    float s[KI][RJ], dp[KI][RJ];
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kf[KI], vf[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        kf[i] = *reinterpret_cast<const float4*>(Kt + (key1 + 8 * i) * LD + d);
        vf[i] = *reinterpret_cast<const float4*>(Vt + (key1 + 8 * i) * LD + d);
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const float4 qf = *reinterpret_cast<const float4*>(Qs + (r1 + 4 * j) * LD + d);
        const float4 df = *reinterpret_cast<const float4*>(dOs + (r1 + 4 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          s[i][j] = repro::dot4(qf, kf[i], s[i][j]);
          dp[i][j] = repro::dot4(df, vf[i], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RJ; ++j)
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        const int key = key1 + 8 * i;
        const bool live = full || (t1[j] >= 0 && pair_live(t1[j], k0 + key, kv_end, p));
        float pj, ds;
        pair_grads(s[i][j], dp[i][j], lse1[j], delta1[j], live, p, pj, ds);
        dSs[(r1 + 4 * j) * PLD + key] = ds;
      }
    __syncthreads();  // dS of the whole tile is in shared memory

#pragma unroll 2
    for (int k = 4 * half; k < BN; k += 8) {
      float4 da[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        da[i] = *reinterpret_cast<const float4*>(dSs + (rg + 16 * i) * PLD + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          if (!has_cols(c)) continue;
          const float4 kv = *reinterpret_cast<const float4*>(Kt + (k + u) * LD + 4 * cg + 32 * c);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float du = repro::lane4(da[i], u);
            acc[i][c][0] = fmaf(du, kv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(du, kv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(du, kv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(du, kv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

  // the second half hands its sums to the first through the q tile's memory
  repro::cp_async_wait_all();
  __syncthreads();
  float* part = Qs;  // [BM][D]
  if (half) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c)
        if (has_cols(c))
          *reinterpret_cast<float4*>(part + (rg + 16 * i) * D + 4 * cg + 32 * c) =
              make_float4(acc[i][c][0], acc[i][c][1], acc[i][c][2], acc[i][c][3]);
  }
  __syncthreads();
  if (half) return;
  float* dqb = static_cast<float*>(p.dq) + b * p.sgqb + kvh * G * p.sgqh;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + rg + 16 * i;
    if (r >= R) continue;
    float* qrow = dqb + (r % G) * p.sgqh + (r / G) * p.sgqt;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      if (!has_cols(c)) continue;
      const int col = 4 * cg + 32 * c;
      const float4 h = *reinterpret_cast<const float4*>(part + (rg + 16 * i) * D + col);
      *reinterpret_cast<float4*>(qrow + col) =
          make_float4((acc[i][c][0] + h.x) * p.scale, (acc[i][c][1] + h.y) * p.scale,
                      (acc[i][c][2] + h.z) * p.scale, (acc[i][c][3] + h.w) * p.scale);
    }
  }
}

// -- dk / dv ----------------------------------------------------------------
//
// One block per (KV tile, KV head, batch). The block loops over the live q
// tiles of its KV tile with the G query heads of the KV head stacked
// position-major (stacked row r is position r / G of query head
// kvh * G + r % G, as flash_fwd.cu), so one pass covers the whole group
// and dk, dv stay in registers: one owner per tile, no atomics, a bitwise
// deterministic result. Q, dO, lse and delta tiles are
// double-buffered with cp.async (the next loads while this one is
// computed); a stacked row past the end gets t = -1 and every pair of it
// is masked.

// Stage stacked q rows [rt0, rt0 + BM) of q and dO, with their lse, delta
// and positions (-1 past the end), into one buffer; dO DV wide at pitch LDV.
template <typename T, int D, int BM, int LD, int THREADS, int DV = D, int LDV = LD>
__device__ __forceinline__ void stage_q_tile(const BwdParams& p, int b, int kvh, int rt0,
                                             T* Qd, T* dOd, float* Ld, float* Dd, int* Td) {
  const int G = p.H / p.KV, R = G * p.Tq;
  const T* qb = static_cast<const T*>(p.q) + b * p.sqb + kvh * G * p.sqh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.sdob + kvh * G * p.sdoh;
  const long long sqh = p.sqh, sqt = p.sqt, sdoh = p.sdoh, sdot = p.sdot;
  repro::stage_rows<T, D, BM, LD, THREADS>(Qd, [=](int i) -> const T* {
    const int r = rt0 + i;
    return r < R ? qb + (r % G) * sqh + (r / G) * sqt : nullptr;
  });
  repro::stage_rows<T, DV, BM, LDV, THREADS>(dOd, [=](int i) -> const T* {
    const int r = rt0 + i;
    return r < R ? dob + (r % G) * sdoh + (r / G) * sdot : nullptr;
  });
  for (int i = threadIdx.x; i < BM; i += THREADS) {
    const int r = rt0 + i;
    if (r < R) {
      const long long row = (static_cast<long long>(b) * p.H + kvh * G + r % G) * p.Tq + r / G;
      repro::cp_async4(Ld + i, p.lse + row);
      repro::cp_async4(Dd + i, p.delta + row);
      Td[i] = r / G;
    } else {
      Ld[i] = Dd[i] = 0.f;
      Td[i] = -1;
    }
  }
}

// Live query positions [q_lo, q_hi) of keys [j0, j0 + n).
__device__ __forceinline__ void query_range(const BwdParams& p, int j0, int n, int& q_lo,
                                            int& q_hi) {
  const int kv_end = min(p.Tk, p.kv_len);
  const int j_last = min(j0 + n, kv_end) - 1;  // < j0: no live key here
  q_lo = p.causal ? j0 : 0;
  q_hi = p.Tq;
  if (p.window > 0) q_hi = min(q_hi, j_last + p.window);
  if (j_last < j0) q_hi = q_lo;
}

// bf16 inputs: tensor cores. Each of 2 warps owns 16 keys as MMA rows (a
// KV tile of 32 keys: the env step's T = 26 is one tile, and 64-thread
// blocks of <= 128 registers put its 1024 blocks in one wave). Per 32
// staged columns: S^T = K Q^T and dP^T = V dO^T from ldmatrix fragments,
// then P^T and dS^T on the accumulator fragments, then dV += P^T dO and
// dK += dS^T Q with P^T and dS^T as A fragments straight from registers.
// _tile_grads keeps p and ds in fp32, so each goes in as bf16 hi + lo (two
// MMAs). A warp skips a q tile in which none of its keys has a live query.
constexpr int kDkvBf16Warps = 2;

// q, k and dk are D wide, dO, v and dv DV (D == DV but for latent
// attention's (192, 128)); each tile is staged at its own pitch.
template <int D, int DV = D> struct DkvBf16 {
  static constexpr int BN = 16 * kDkvBf16Warps, BM = D <= 64 ? 64 : 32, LD = D + 8;
  static constexpr int LDV = DV + 8;
  static constexpr int smem = (BN + 2 * BM) * (LD + LDV) * 2 + 2 * 3 * BM * 4;
};

template <int D, int DV>
__device__ __forceinline__ void dkv_bf16(const BwdParams& p) {
  using T = __nv_bfloat16;
  constexpr int THREADS = kDkvBf16Warps * 32;
  constexpr int BN = DkvBf16<D, DV>::BN, BM = DkvBf16<D, DV>::BM, LD = DkvBf16<D, DV>::LD;
  constexpr int LDV = DkvBf16<D, DV>::LDV;
  constexpr int CW = 32;      // columns (stacked q rows) per pass over a staged tile
  constexpr int NT = CW / 8;  // S^T n-tiles per pass
  constexpr int DT = D / 8;   // dk n-tiles per warp
  constexpr int DTV = DV / 8;  // dv n-tiles per warp
  static_assert(D % 16 == 0 && DV % 16 == 0, "k-steps of 16 columns; n-tiles taken in pairs");
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);  // [BN][LD]
  T* Vs = Ks + BN * LD;                 // [BN][LDV]
  T* Qs = Vs + BN * LDV;                // [2][BM][LD]
  T* dOs = Qs + 2 * BM * LD;            // [2][BM][LDV]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BM * LDV);  // [2][BM]
  float* Ds = Ls + 2 * BM;                                  // [2][BM]
  int* Ts = reinterpret_cast<int*>(Ds + 2 * BM);            // [2][BM]

  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * BN;
  const int G = p.H / p.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, cq = lane & 3;
  stage_kv_tile<T, D, BN, LD, THREADS, DV, LDV>(p, b, kvh, blockIdx.x, Ks, Vs);

  int q_lo, q_hi, wq_lo, wq_hi;
  query_range(p, k0, BN, q_lo, q_hi);
  query_range(p, k0 + warp * 16, 16, wq_lo, wq_hi);  // this warp's keys
  const int rt_lo = q_lo * G / BM;
  const int rt_hi = q_hi > q_lo ? (q_hi * G + BM - 1) / BM : rt_lo;
  const int kv_end = min(p.Tk, p.kv_len);
  const int ka = k0 + warp * 16 + gq, kb8 = ka + 8;  // this lane's two keys

  float dk[DT][4], dv[DTV][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < DTV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;

  auto stage = [&](int rt, int buf) {
    stage_q_tile<T, D, BM, LD, THREADS, DV, LDV>(p, b, kvh, rt * BM, Qs + buf * BM * LD,
                                                 dOs + buf * BM * LDV, Ls + buf * BM,
                                                 Ds + buf * BM, Ts + buf * BM);
  };
  if (rt_lo < rt_hi) stage(rt_lo, 0);
  repro::cp_async_commit();
  for (int rt = rt_lo; rt < rt_hi; ++rt) {
    const int buf = (rt - rt_lo) & 1;
    repro::cp_async_wait_all();
    __syncthreads();  // q tile rt (and K, V) landed; every warp is done with rt - 1
    if (rt + 1 < rt_hi) stage(rt + 1, buf ^ 1);
    repro::cp_async_commit();
#pragma unroll 1
    for (int c0 = 0; c0 < BM; c0 += CW) {
      const int rc0 = rt * BM + c0;  // first stacked row of this pass
      if (wq_hi <= wq_lo || (rc0 + CW - 1) / G < wq_lo || rc0 / G >= wq_hi) continue;
      const T* Qt = Qs + buf * BM * LD + c0 * LD;
      const T* dOt = dOs + buf * BM * LDV + c0 * LDV;
      const float* Lt = Ls + buf * BM + c0;
      const float* Dt = Ds + buf * BM + c0;
      const int* Tt = Ts + buf * BM + c0;

      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      // fragment offsets of k-step kk at pitch ld: A rows (this warp's
      // keys), B columns n-tile n (stacked q rows)
      const auto a_at = [&](int kk, int ld) {
        return (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + kk * 16 + (lane >> 4) * 8;
      };
      const auto b_at = [&](int n, int kk, int ld) {
        return (n * 8 + (lane & 7) + (lane >> 4) * 8) * ld + kk * 16 + ((lane >> 3) & 1) * 8;
      };
      if constexpr (D == DV) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a_off = a_at(kk, LD);
          unsigned ak[4], av[4];
          repro::ldmatrix_x4(ak, Ks + a_off);
          repro::ldmatrix_x4(av, Vs + a_off);
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            const int b_off = b_at(n, kk, LD);
            unsigned bq[4], bd[4];
            repro::ldmatrix_x4(bq, Qt + b_off);
            repro::mma_bf16(st[n], ak, bq[0], bq[1]);
            repro::mma_bf16(st[n + 1], ak, bq[2], bq[3]);
            repro::ldmatrix_x4(bd, dOt + b_off);
            repro::mma_bf16(dpt[n], av, bd[0], bd[1]);
            repro::mma_bf16(dpt[n + 1], av, bd[2], bd[3]);
          }
        }
      } else {  // S^T over k's and q's D columns, dP^T over v's and dO's DV
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          unsigned ak[4];
          repro::ldmatrix_x4(ak, Ks + a_at(kk, LD));
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            unsigned bq[4];
            repro::ldmatrix_x4(bq, Qt + b_at(n, kk, LD));
            repro::mma_bf16(st[n], ak, bq[0], bq[1]);
            repro::mma_bf16(st[n + 1], ak, bq[2], bq[3]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
          unsigned av[4];
          repro::ldmatrix_x4(av, Vs + a_at(kk, LDV));
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            unsigned bd[4];
            repro::ldmatrix_x4(bd, dOt + b_at(n, kk, LDV));
            repro::mma_bf16(dpt[n], av, bd[0], bd[1]);
            repro::mma_bf16(dpt[n + 1], av, bd[2], bd[3]);
          }
        }
      }

      // element e of n-tile n: key (e < 2 ? ka : kb8), column 8 n + 2 cq + (e & 1)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = n * 8 + 2 * cq;
        const float2 lse = *reinterpret_cast<const float2*>(Lt + c);
        const float2 delta = *reinterpret_cast<const float2*>(Dt + c);
        const int2 t = *reinterpret_cast<const int2*>(Tt + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tq = e & 1 ? t.y : t.x;
          const bool live = tq >= 0 && pair_live(tq, e < 2 ? ka : kb8, kv_end, p);
          float pj, ds;
          pair_grads(st[n][e], dpt[n][e], e & 1 ? lse.y : lse.x, e & 1 ? delta.y : delta.x,
                     live, p, pj, ds);
          st[n][e] = pj;
          dpt[n][e] = ds;
        }
      }

      // dV += P^T dO and dK += dS^T Q: the accumulators of n-tiles 2 kq and
      // 2 kq + 1 are the A fragment of columns 16 kq .. 16 kq + 15
#pragma unroll
      for (int kq = 0; kq < CW / 16; ++kq) {
        unsigned ph[4], pl[4], sh[4], sl[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          repro::split_bf16(st[2 * kq + h][0], st[2 * kq + h][1], ph[2 * h], pl[2 * h]);
          repro::split_bf16(st[2 * kq + h][2], st[2 * kq + h][3], ph[2 * h + 1], pl[2 * h + 1]);
          repro::split_bf16(dpt[2 * kq + h][0], dpt[2 * kq + h][1], sh[2 * h], sl[2 * h]);
          repro::split_bf16(dpt[2 * kq + h][2], dpt[2 * kq + h][3], sh[2 * h + 1],
                            sl[2 * h + 1]);
        }
        // B fragment offset of n-tile n at pitch ld: rows 16 kq.. of dO or q
        const auto t_at = [&](int n, int ld) {
          return (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n * 8 + (lane >> 4) * 8;
        };
        if constexpr (D == DV) {
#pragma unroll
          for (int n = 0; n < DT; n += 2) {
            const int b_off = t_at(n, LD);
            unsigned bd[4], bq[4];
            repro::ldmatrix_x4_trans(bd, dOt + b_off);
            repro::mma_bf16(dv[n], ph, bd[0], bd[1]);
            repro::mma_bf16(dv[n + 1], ph, bd[2], bd[3]);
            repro::mma_bf16(dv[n], pl, bd[0], bd[1]);
            repro::mma_bf16(dv[n + 1], pl, bd[2], bd[3]);
            repro::ldmatrix_x4_trans(bq, Qt + b_off);
            repro::mma_bf16(dk[n], sh, bq[0], bq[1]);
            repro::mma_bf16(dk[n + 1], sh, bq[2], bq[3]);
            repro::mma_bf16(dk[n], sl, bq[0], bq[1]);
            repro::mma_bf16(dk[n + 1], sl, bq[2], bq[3]);
          }
        } else {
#pragma unroll
          for (int n = 0; n < DTV; n += 2) {
            unsigned bd[4];
            repro::ldmatrix_x4_trans(bd, dOt + t_at(n, LDV));
            repro::mma_bf16(dv[n], ph, bd[0], bd[1]);
            repro::mma_bf16(dv[n + 1], ph, bd[2], bd[3]);
            repro::mma_bf16(dv[n], pl, bd[0], bd[1]);
            repro::mma_bf16(dv[n + 1], pl, bd[2], bd[3]);
          }
#pragma unroll
          for (int n = 0; n < DT; n += 2) {
            unsigned bq[4];
            repro::ldmatrix_x4_trans(bq, Qt + t_at(n, LD));
            repro::mma_bf16(dk[n], sh, bq[0], bq[1]);
            repro::mma_bf16(dk[n + 1], sh, bq[2], bq[3]);
            repro::mma_bf16(dk[n], sl, bq[0], bq[1]);
            repro::mma_bf16(dk[n + 1], sl, bq[2], bq[3]);
          }
        }
      }
    }
  }

  repro::cp_async_wait_all();  // no copy outlives the block (an empty sweep)
  T* dkb = static_cast<T*>(p.dk) + b * p.sgkb + kvh * p.sgkh;
  T* dvb = static_cast<T*>(p.dv) + b * p.sgvb + kvh * p.sgvh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = r ? kb8 : ka;
    if (j >= p.Tk) continue;
    if constexpr (D == DV) {
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const int c = n * 8 + 2 * cq;
        *reinterpret_cast<unsigned*>(dkb + j * p.sgkt + c) =
            repro::pack_bf16(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
        *reinterpret_cast<unsigned*>(dvb + j * p.sgvt + c) =
            repro::pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<unsigned*>(dkb + j * p.sgkt + n * 8 + 2 * cq) =
            repro::pack_bf16(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
#pragma unroll
      for (int n = 0; n < DTV; ++n)
        *reinterpret_cast<unsigned*>(dvb + j * p.sgvt + n * 8 + 2 * cq) =
            repro::pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kDkvBf16Warps * 32) bwd_dkv_bf16(const BwdParams p) {
  dkv_bf16<D, D>(p);
}

// Latent attention's (192, 128): 32 keys of a block against 32-row q tiles;
// dk (24 n-tiles) and dv (16) live in 160 accumulators a lane; shared
// memory 65 KB.
template <int D, int DV>
__global__ void __launch_bounds__(kDkvBf16Warps * 32) bwd_dkv_bf16_dv(const BwdParams p) {
  dkv_bf16<D, DV>(p);
}

// fp32 inputs: register-tiled CUDA cores, IEEE fp32. 256 threads on a KV
// tile of 32 keys: 256 blocks at T = 4096 with 2 KV heads (~2 per SM of
// 132, 16 warps each). What bounds a register-tiled fp32 product here is
// shared-memory issue (one 128-byte wavefront per clock against 128 FMAs),
// so both phases give each lane a micro-tile whose warp reads hit at most
// 8 distinct 16-byte chunks per load:
// - Phase 1: warp w covers keys 16 (w % 2) .. + 15 and a quarter of the
//   queries; lane (kg, qg) = (lane % 8, lane / 8) computes S^T and dP^T for
//   keys kg + 8 i (i < 2) and queries qg + 4 j from float4 reads of K, V, Q
//   and dO (64 FMAs per 12 wavefronts), then P^T and dS^T, which go to
//   shared memory.
// - Phase 2: the block's two halves take alternate groups of 4 queries;
//   thread (kr, cc) of a half owns dk and dv of keys kr + 16 i (i < 2) at
//   columns 4 cc + 32 c (64 FMAs per 12 wavefronts), the last pass of 16
//   columns at a head dim like 80 taken by lanes cc < 4. At the end the second
//   half's sums are added to the first's in a fixed order, so the result
//   stays deterministic.
constexpr int kDkvF32Threads = 256;

template <int D> struct DkvF32 {
  // PLD = BM + 4: phase 1's stores of 8 keys x 4 queries hit 32 banks
  static constexpr int BN = 32, BM = D <= 64 ? 64 : 32, LD = D + 4, PLD = BM + 4;
  static constexpr int smem = ((2 * BN + 4 * BM) * LD + 2 * BN * PLD) * 4 + 2 * 3 * BM * 4;
};

template <int D>
__global__ void __launch_bounds__(kDkvF32Threads) bwd_dkv_f32(const BwdParams p) {
  constexpr int THREADS = kDkvF32Threads;
  constexpr int BN = DkvF32<D>::BN, BM = DkvF32<D>::BM, LD = DkvF32<D>::LD;
  constexpr int PLD = DkvF32<D>::PLD;
  constexpr int QW = BM / 4;   // queries per warp in phase 1
  constexpr int QJ = QW / 4;   // queries per lane in phase 1
  constexpr int CJ = (D + 31) / 32;  // float4 columns per thread and key in phase 2
  static_assert(D % 16 == 0, "the last column pass takes 16 or 32 columns");
  static_assert(2 * BN * D <= 4 * BM * LD, "phase 2's partial sums fit in the q tiles");
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BN][LD]
  float* Vs = Ks + BN * LD;                     // [BN][LD]
  float* Qs = Vs + BN * LD;                     // [2][BM][LD]
  float* dOs = Qs + 2 * BM * LD;                // [2][BM][LD]
  float* Ps = dOs + 2 * BM * LD;                // [BN][PLD]  P^T
  float* dSs = Ps + BN * PLD;                   // [BN][PLD]  dS^T
  float* Ls = dSs + BN * PLD;                   // [2][BM]
  float* Ds = Ls + 2 * BM;                      // [2][BM]
  int* Ts = reinterpret_cast<int*>(Ds + 2 * BM);  // [2][BM]

  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * BN;
  const int G = p.H / p.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key1 = 16 * (warp & 1) + (lane & 7);   // phase 1: keys key1 + 8 i
  const int q1 = QW * (warp >> 1) + (lane >> 3);   // phase 1: queries q1 + 4 j
  const int half = threadIdx.x >> 7;               // phase 2: query groups 2 m + half
  const int kr = (threadIdx.x & 127) >> 3, cc = threadIdx.x & 7;  // phase 2
  // phase 2's column pass c of this lane (c < D / 32 folds to true)
  const bool tail_cols = 4 * cc + 32 * (CJ - 1) < D;
  const auto has_cols = [tail_cols](int c) { return c < D / 32 || tail_cols; };
  stage_kv_tile<float, D, BN, LD, THREADS>(p, b, kvh, blockIdx.x, Ks, Vs);

  int q_lo, q_hi;
  query_range(p, k0, BN, q_lo, q_hi);
  const int rt_lo = q_lo * G / BM;
  const int rt_hi = q_hi > q_lo ? (q_hi * G + BM - 1) / BM : rt_lo;
  const int kv_end = min(p.Tk, p.kv_len);

  float dk[2][CJ][4], dv[2][CJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][c][e] = dv[i][c][e] = 0.f;

  auto stage = [&](int rt, int buf) {
    stage_q_tile<float, D, BM, LD, THREADS>(p, b, kvh, rt * BM, Qs + buf * BM * LD,
                                            dOs + buf * BM * LD, Ls + buf * BM,
                                            Ds + buf * BM, Ts + buf * BM);
  };
  if (rt_lo < rt_hi) stage(rt_lo, 0);
  repro::cp_async_commit();
  for (int rt = rt_lo; rt < rt_hi; ++rt) {
    const int buf = (rt - rt_lo) & 1;
    repro::cp_async_wait_all();
    __syncthreads();  // q tile rt (and K, V) landed; tile rt - 1, Ps and dSs are consumed
    if (rt + 1 < rt_hi) stage(rt + 1, buf ^ 1);
    repro::cp_async_commit();
    const float* Qt = Qs + buf * BM * LD;
    const float* dOt = dOs + buf * BM * LD;

    float s[2][QJ], dp[2][QJ];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < QJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kf[2], vf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        kf[i] = *reinterpret_cast<const float4*>(Ks + (key1 + 8 * i) * LD + d);
        vf[i] = *reinterpret_cast<const float4*>(Vs + (key1 + 8 * i) * LD + d);
      }
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const float4 qf = *reinterpret_cast<const float4*>(Qt + (q1 + 4 * j) * LD + d);
        const float4 df = *reinterpret_cast<const float4*>(dOt + (q1 + 4 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s[i][j] = repro::dot4(kf[i], qf, s[i][j]);
          dp[i][j] = repro::dot4(vf[i], df, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
      const int c = q1 + 4 * j;
      const int t = Ts[buf * BM + c];
      const float lse = Ls[buf * BM + c], delta = Ds[buf * BM + c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool live = t >= 0 && pair_live(t, k0 + key1 + 8 * i, kv_end, p);
        float pj, ds;
        pair_grads(s[i][j], dp[i][j], lse, delta, live, p, pj, ds);
        Ps[(key1 + 8 * i) * PLD + c] = pj;
        dSs[(key1 + 8 * i) * PLD + c] = ds;
      }
    }
    __syncthreads();  // P^T and dS^T of the whole tile are in shared memory

#pragma unroll 2
    for (int q = 4 * half; q < BM; q += 8) {
      float4 pa[2], da[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pa[i] = *reinterpret_cast<const float4*>(Ps + (kr + 16 * i) * PLD + q);
        da[i] = *reinterpret_cast<const float4*>(dSs + (kr + 16 * i) * PLD + q);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          if (!has_cols(c)) continue;
          const float4 dov = *reinterpret_cast<const float4*>(dOt + (q + u) * LD + 4 * cc + 32 * c);
          const float4 qv = *reinterpret_cast<const float4*>(Qt + (q + u) * LD + 4 * cc + 32 * c);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float pu = repro::lane4(pa[i], u), du = repro::lane4(da[i], u);
            dv[i][c][0] = fmaf(pu, dov.x, dv[i][c][0]);
            dv[i][c][1] = fmaf(pu, dov.y, dv[i][c][1]);
            dv[i][c][2] = fmaf(pu, dov.z, dv[i][c][2]);
            dv[i][c][3] = fmaf(pu, dov.w, dv[i][c][3]);
            dk[i][c][0] = fmaf(du, qv.x, dk[i][c][0]);
            dk[i][c][1] = fmaf(du, qv.y, dk[i][c][1]);
            dk[i][c][2] = fmaf(du, qv.z, dk[i][c][2]);
            dk[i][c][3] = fmaf(du, qv.w, dk[i][c][3]);
          }
        }
      }
    }
  }

  // the second half hands its sums to the first through the q tiles' memory
  repro::cp_async_wait_all();
  __syncthreads();
  float* part = Qs;  // [2][BN][D]: dk, dv
  if (half) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        if (!has_cols(c)) continue;
        const int at = (kr + 16 * i) * D + 4 * cc + 32 * c;
        *reinterpret_cast<float4*>(part + at) =
            make_float4(dk[i][c][0], dk[i][c][1], dk[i][c][2], dk[i][c][3]);
        *reinterpret_cast<float4*>(part + BN * D + at) =
            make_float4(dv[i][c][0], dv[i][c][1], dv[i][c][2], dv[i][c][3]);
      }
  }
  __syncthreads();
  if (half) return;
  float* dkb = static_cast<float*>(p.dk) + b * p.sgkb + kvh * p.sgkh;
  float* dvb = static_cast<float*>(p.dv) + b * p.sgvb + kvh * p.sgvh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = k0 + kr + 16 * i;
    if (j >= p.Tk) continue;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      if (!has_cols(c)) continue;
      const int col = 4 * cc + 32 * c, at = (kr + 16 * i) * D + col;
      const float4 pk = *reinterpret_cast<const float4*>(part + at);
      const float4 pv = *reinterpret_cast<const float4*>(part + BN * D + at);
      *reinterpret_cast<float4*>(dkb + j * p.sgkt + col) =
          make_float4((dk[i][c][0] + pk.x) * p.scale, (dk[i][c][1] + pk.y) * p.scale,
                      (dk[i][c][2] + pk.z) * p.scale, (dk[i][c][3] + pk.w) * p.scale);
      *reinterpret_cast<float4*>(dvb + j * p.sgvt + col) =
          make_float4(dv[i][c][0] + pv.x, dv[i][c][1] + pv.y, dv[i][c][2] + pv.z,
                      dv[i][c][3] + pv.w);
    }
  }
}

// -- dk / dv on Hopper's warpgroup MMA ------------------------------------------
//
// bf16 at (D, DV) = (128, 128) and (192, 128) when Tk holds a whole key tile
// (the wrapper's rule, ops.py `dkv_design`). One block per (128-key tile, KV
// head, batch): a producer warp and two consumer warpgroups of 64 keys each
// (wgmma's M), 384 threads, one block an SM, registers moved to the
// consumers with setmaxnreg. K and V of the block's keys land once by TMA.
// Q and dO tiles stream through a ring of STAGES slots: a tile is n = BQ / G
// whole positions x the group's G query heads, one TMA box (64 columns, G
// heads, n positions) per 64-column chunk over the (B, H, T, d) view, so
// it lands as position-major stacked rows (stacked row r = position r / G
// of query head kvh G + r % G) under the 128-byte swizzle that wgmma reads;
// a second producer warp writes the rows' lse, delta and positions. Rows a
// box leaves unwritten (n G < BQ) stay zero, with position -1.
// Per tile, each consumer: S^T = K Q^T and dP^T = V dO^T (wgmma, K and V
// K-major, Q and dO K-major, fp32 accumulators), P^T and dS^T on the
// accumulator fragments (pair_grads' arithmetic and masks), then dV +=
// P^T dO and dK += dS^T Q with P^T and dS^T as the register A operand,
// bf16 hi + lo (two products each), and dO and Q read MN-major from the
// same slots. Blocks take key tiles on grid y, so every head's first key
// tile (the longest causal sweep) is dispatched first. Each dk/dv element
// has one owner and a fixed order over the tiles: no atomics, bitwise
// deterministic.
constexpr int kWgKeys = 128;         // keys a block: two consumer warpgroups of 64
constexpr int kWgThreads = 3 * 128;  // the producer's warpgroup and two consumers

// BN and BQ are also flash_attention/ops.py's WGMMA_KEYS and WGMMA_ROWS,
// which route to this kernel: change them together.
template <int D, int DV> struct DkvWg {
  static constexpr int BN = kWgKeys;
  // stacked q rows a tile: at D = 192 the consumers' dk and dv take 160
  // registers a thread, and 32-row S^T and dP^T (16 each) fit beside them
  static constexpr int BQ = D == 192 ? 32 : 64;
  static constexpr int STAGES = 4;
  static constexpr int KC = D / 64, VC = DV / 64;     // 128-byte chunks of a row
  static constexpr int K_BYTES = KC * BN * 128, V_BYTES = VC * BN * 128;
  static constexpr int Q_BYTES = KC * BQ * 128, O_BYTES = VC * BQ * 128;
  static constexpr int STATS = 3 * BQ * 4;            // lse, delta, position a row
  static constexpr int smem =
      1024 + K_BYTES + V_BYTES + STAGES * (Q_BYTES + O_BYTES + STATS) + 8 * (1 + 2 * STAGES);
  static_assert(smem <= 232448, "shared memory a block");
};

template <int D, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const BwdParams p) {
  using C = DkvWg<D, DV>;
  using T = __nv_bfloat16;
  constexpr int BN = C::BN, BQ = C::BQ, S = C::STAGES, KC = C::KC, VC = C::VC;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4) + ((1024 - (repro::smem_addr(smem4) & 1023)) & 1023);
  char* Ks = base;                                         // [KC][BN][128 B]
  char* Vs = Ks + C::K_BYTES;                              // [VC][BN][128 B]
  char* Qs = Vs + C::V_BYTES;                              // [S][KC][BQ][128 B]
  char* Os = Qs + S * C::Q_BYTES;                          // [S][VC][BQ][128 B]
  float* Ls = reinterpret_cast<float*>(Os + S * C::O_BYTES);  // [S][BQ] lse
  float* Dl = Ls + S * BQ;                                 // [S][BQ] delta
  int* Ps = reinterpret_cast<int*>(Dl + S * BQ);           // [S][BQ] position, -1: none
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(Ps + S * BQ);
  uint64_t* full = kv_bar + 1;                             // [S] a tile landed
  uint64_t* empty = full + S;                              // [S] both consumers done with it

  const int kvh = blockIdx.x % p.KV, b = blockIdx.x / p.KV, k0 = blockIdx.y * BN;
  const int G = p.H / p.KV, n = BQ / G;  // positions a tile
  int q_lo, q_hi;
  query_range(p, k0, BN, q_lo, q_hi);
  const int it_lo = q_lo / n, tiles = q_hi > q_lo ? (q_hi + n - 1) / n - it_lo : 0;

  if (threadIdx.x == 0) {
    repro::mbar_init(kv_bar, 1);
    for (int s = 0; s < S; ++s) {
      repro::mbar_init(&full[s], 33);  // the TMA lane and the stats warp's lanes
      repro::mbar_init(&empty[s], 8);  // the consumers' warps
    }
    repro::mbar_init_fence();
  }
  if (n * G < BQ) {  // rows no box writes stay zero: they add nothing to dK and dV
    for (int i = threadIdx.x; i < S * (C::Q_BYTES + C::O_BYTES) / 16; i += kWgThreads)
      reinterpret_cast<float4*>(Qs)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    repro::fence_proxy_async();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: warp 0 issues the TMA loads, warp 1 the rows' stats
    repro::setmaxnreg_dec<24>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0) {
      repro::mbar_arrive_expect_tx(kv_bar, C::K_BYTES + C::V_BYTES);
      for (int c = 0; c < KC; ++c)
        repro::tma_load_4d(Ks + c * BN * 128, &tk, kv_bar, 64 * c, kvh, k0, b);
      for (int c = 0; c < VC; ++c)
        repro::tma_load_4d(Vs + c * BN * 128, &tv, kv_bar, 64 * c, kvh, k0, b);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % S, t0 = (it_lo + i) * n;
        if (i >= S) repro::mbar_wait(&empty[s], (i / S - 1) & 1);
        repro::mbar_arrive_expect_tx(&full[s], n * G * 128 * (KC + VC));
        for (int c = 0; c < KC; ++c)
          repro::tma_load_4d(Qs + s * C::Q_BYTES + c * BQ * 128, &tq, &full[s], 64 * c, kvh * G,
                             t0, b);
        for (int c = 0; c < VC; ++c)
          repro::tma_load_4d(Os + s * C::O_BYTES + c * BQ * 128, &tdo, &full[s], 64 * c, kvh * G,
                             t0, b);
      }
    } else if (warp == 1) {
      // this lane's stacked rows r = lane + 32 u: position t0 + r / G of head r % G
      constexpr int RL = (BQ + 31) / 32;
      int dt[RL];
      long long at[RL];
#pragma unroll
      for (int u = 0; u < RL; ++u) {
        const int r = lane + 32 * u;
        dt[u] = r < n * G ? r / G : p.Tq;  // rows no box writes: never a position
        at[u] = (static_cast<long long>(b) * p.H + kvh * G + r % G) * p.Tq + dt[u];
      }
      for (int i = 0; i < tiles; ++i) {
        const int s = i % S, t0 = (it_lo + i) * n;
        if (i >= S) repro::mbar_wait(&empty[s], (i / S - 1) & 1);
#pragma unroll
        for (int u = 0; u < RL; ++u) {
          const int r = lane + 32 * u;
          if (r >= BQ) break;
          const bool real = t0 + dt[u] < p.Tq;
          Ls[s * BQ + r] = real ? p.lse[at[u] + t0] : 0.f;
          Dl[s * BQ + r] = real ? p.delta[at[u] + t0] : 0.f;
          Ps[s * BQ + r] = real ? t0 + dt[u] : -1;
        }
        repro::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers
  repro::setmaxnreg_inc<240>();
  const int cw = threadIdx.x / 128 - 1;  // this warpgroup's keys: k0 + 64 cw ..
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int ka = k0 + 64 * cw + 16 * warp + g, kb = ka + 8;  // this lane's two keys
  int wq_lo, wq_hi;
  query_range(p, k0 + 64 * cw, 64, wq_lo, wq_hi);
  const int kv_end = min(p.Tk, p.kv_len);

  float dk[D / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
  // K and V rows of this warpgroup (K-major A); k-step j: chunk j / 4, 32 (j % 4) bytes in
  const uint64_t k_desc = repro::wgmma_desc(Ks + cw * 64 * 128, 16, 1024);
  const uint64_t v_desc = repro::wgmma_desc(Vs + cw * 64 * 128, 16, 1024);
  const auto kstep = [](int j, int rows) {  // descriptor offset, 16-byte units
    return static_cast<uint64_t>((j / 4) * rows * 8 + (j % 4) * 2);
  };
  repro::mbar_wait(kv_bar, 0);

  for (int i = 0; i < tiles; ++i) {
    const int s = i % S, t0 = (it_lo + i) * n;
    repro::mbar_wait(&full[s], (i / S) & 1);
    if (wq_lo < wq_hi && t0 < wq_hi && t0 + n > wq_lo) {  // warpgroup-uniform
      const char* Qt = Qs + s * C::Q_BYTES;
      const char* Ot = Os + s * C::O_BYTES;
      const float* Lt = Ls + s * BQ;
      const float* Dt = Dl + s * BQ;
      const int* Pt = Ps + s * BQ;
      // S^T and dP^T as two groups: in a tile with neither masks nor a
      // softcap, P^T is computed while dP^T is still on the tensor cores (a
      // masked tile's mask registers do not fit beside it)
      float st[BQ / 2], dpt[BQ / 2];
      const uint64_t q_desc = repro::wgmma_desc(Qt, 16, 1024);
      const uint64_t o_desc = repro::wgmma_desc(Ot, 16, 1024);
      repro::wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        repro::wgmma_ss<BQ>(st, k_desc + kstep(j, BN), q_desc + kstep(j, BQ), j > 0);
      repro::wgmma_commit();
#pragma unroll
      for (int j = 0; j < DV / 16; ++j)
        repro::wgmma_ss<BQ>(dpt, v_desc + kstep(j, BN), o_desc + kstep(j, BQ), j > 0);
      repro::wgmma_commit();

      // Element e of accumulator chunk h: key (e < 2 ? ka : kb), stacked row
      // 8 h + 2 c + (e & 1). FULL: every pair of this warpgroup's keys and
      // the tile's positions is live, so no mask is evaluated (rows a box
      // leaves zero, and positions past Tq, have q = dO = 0 and lse = delta
      // = 0: p = 1 and ds = 0 there, and both multiply zero rows). k-step j
      // of dV += P^T dO and dK += dS^T Q takes stacked rows 16 j .. 16 j +
      // 15, chunks 2 j and 2 j + 1, split into bf16 hi + lo A registers and
      // handed to their four products while the next k-step's are computed.
      const auto grads = [&](auto full, auto capped) {
        constexpr bool FULL = decltype(full)::value, CAPPED = decltype(capped)::value;
        const auto live = [&](int h, int e) {
          if constexpr (FULL) {
            return true;
          } else {
            const int tq = Pt[8 * h + 2 * c + (e & 1)];
            return tq >= 0 && pair_live(tq, e < 2 ? ka : kb, kv_end, p);
          }
        };
        if constexpr (CAPPED || !FULL) {
          repro::wgmma_wait<0>();
          repro::wgmma_hold(st);
          repro::wgmma_hold(dpt);
        } else {
          repro::wgmma_wait<1>();
          repro::wgmma_hold(st);
        }
        if constexpr (!CAPPED) {
          // p = exp2((s scale - lse) log2 e), pair_grads' without the softcap;
          // a masked p is exactly 0, and so then is ds = p (dp - delta)
#pragma unroll
          for (int h = 0; h < BQ / 8; ++h) {
            const float2 lse = *reinterpret_cast<const float2*>(Lt + 8 * h + 2 * c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float pj = repro::exp2_ftz(
                  fmaf(st[4 * h + e] * p.scale, kLog2e, -(e & 1 ? lse.y : lse.x) * kLog2e));
              st[4 * h + e] = live(h, e) ? pj : 0.f;
            }
          }
          if constexpr (FULL) {
            repro::wgmma_wait<0>();
            repro::wgmma_hold(dpt);
          }
        }
        unsigned ph[BQ / 16][4], pl[BQ / 16][4], sh[BQ / 16][4], sl[BQ / 16][4];
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int h = 2 * j + u;
            const float2 delta = *reinterpret_cast<const float2*>(Dt + 8 * h + 2 * c);
            const float2 lse = *reinterpret_cast<const float2*>(Lt + 8 * h + 2 * c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float de = e & 1 ? delta.y : delta.x;
              if constexpr (CAPPED) {
                float pj, ds;
                pair_grads(st[4 * h + e], dpt[4 * h + e], e & 1 ? lse.y : lse.x, de, live(h, e),
                           p, pj, ds);
                st[4 * h + e] = pj;
                dpt[4 * h + e] = ds;
              } else {
                dpt[4 * h + e] = st[4 * h + e] * (dpt[4 * h + e] - de);
              }
            }
#pragma unroll
            for (int e = 0; e < 4; e += 2) {  // A register 2 u + e / 2: chunk h, row g or g + 8
              repro::split_bf16(st[4 * h + e], st[4 * h + e + 1], ph[j][2 * u + e / 2],
                                pl[j][2 * u + e / 2]);
              repro::split_bf16(dpt[4 * h + e], dpt[4 * h + e + 1], sh[j][2 * u + e / 2],
                                sl[j][2 * u + e / 2]);
            }
          }
          // rows 16 j .. 16 j + 15 of the slots, MN-major: chunks BQ * 128 bytes apart
          const uint64_t bo = repro::wgmma_desc(Ot + j * 16 * 128, BQ * 128, 1024);
          const uint64_t bq = repro::wgmma_desc(Qt + j * 16 * 128, BQ * 128, 1024);
          repro::wgmma_fence();
          repro::wgmma_rs<DV>(dv, ph[j], bo);
          repro::wgmma_rs<DV>(dv, pl[j], bo);
          repro::wgmma_rs<D>(dk, sh[j], bq);
          repro::wgmma_rs<D>(dk, sl[j], bq);
          repro::wgmma_commit();
        }
        repro::wgmma_wait<0>();
        repro::wgmma_hold(dv);
        repro::wgmma_hold(dk);
      };
      const int kmin = k0 + 64 * cw, kmax = kmin + 63;
      const bool full = (!p.causal || t0 >= kmax) && kmax < kv_end
                        && (p.window <= 0 || t0 + n - 1 - kmin < p.window);
      using Yes = std::true_type;
      using No = std::false_type;
      if (p.cap > 0.f) {
        full ? grads(Yes{}, Yes{}) : grads(No{}, Yes{});
      } else {
        full ? grads(Yes{}, No{}) : grads(No{}, No{});
      }
    }
    __syncwarp();
    if (lane == 0) repro::mbar_arrive(&empty[s]);
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.sgkb + kvh * p.sgkh;
  T* dvb = static_cast<T*>(p.dv) + b * p.sgvb + kvh * p.sgvh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = r ? kb : ka;
    if (j >= p.Tk) continue;
#pragma unroll
    for (int h = 0; h < D / 8; ++h)
      *reinterpret_cast<unsigned*>(dkb + j * p.sgkt + 8 * h + 2 * c) =
          repro::pack_bf16(dk[4 * h + 2 * r] * p.scale, dk[4 * h + 2 * r + 1] * p.scale);
#pragma unroll
    for (int h = 0; h < DV / 8; ++h)
      *reinterpret_cast<unsigned*>(dvb + j * p.sgvt + 8 * h + 2 * c) =
          repro::pack_bf16(dv[4 * h + 2 * r], dv[4 * h + 2 * r + 1]);
  }
}

// -- launch -----------------------------------------------------------------

template <typename F>
cudaError_t launch(F* kernel, dim3 grid, int threads, int smem, const BwdParams& p,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(bool bf16, const BwdParams& p, cudaStream_t s) {
  const int rows = p.H / p.KV * p.Tq;
  if (bf16) {
    const dim3 grid((rows + DqBf16<D>::BM - 1) / DqBf16<D>::BM, p.KV, p.B);
    return launch(bwd_dq_bf16<D>, grid, kDqBf16Threads, DqBf16<D>::smem, p, s);
  }
  const dim3 grid((rows + DqF32<D>::BM - 1) / DqF32<D>::BM, p.KV, p.B);
  return launch(bwd_dq_f32<D>, grid, kDqF32Threads, DqF32<D>::smem, p, s);
}

template <int D>
cudaError_t launch_dkv(bool bf16, const BwdParams& p, cudaStream_t s) {
  if (bf16) {
    const dim3 grid((p.Tk + DkvBf16<D>::BN - 1) / DkvBf16<D>::BN, p.KV, p.B);
    return launch(bwd_dkv_bf16<D>, grid, kDkvBf16Warps * 32, DkvBf16<D>::smem, p, s);
  }
  const dim3 grid((p.Tk + DkvF32<D>::BN - 1) / DkvF32<D>::BN, p.KV, p.B);
  return launch(bwd_dkv_f32<D>, grid, kDkvF32Threads, DkvF32<D>::smem, p, s);
}

// Latent attention's widths: bf16 only.
template <int D, int DV>
cudaError_t launch_dv(bool dkv, bool bf16, const BwdParams& p, cudaStream_t s) {
  if (!bf16) return cudaErrorInvalidValue;
  if (dkv) {
    const dim3 grid((p.Tk + DkvBf16<D, DV>::BN - 1) / DkvBf16<D, DV>::BN, p.KV, p.B);
    return launch(bwd_dkv_bf16_dv<D, DV>, grid, kDkvBf16Warps * 32, DkvBf16<D, DV>::smem, p,
                  s);
  }
  const int rows = p.H / p.KV * p.Tq;
  const dim3 grid((rows + DqBf16<D, DV>::BM - 1) / DqBf16<D, DV>::BM, p.KV, p.B);
  return launch(bwd_dq_bf16_dv<D, DV>, grid, kDqBf16Threads, DqBf16<D, DV>::smem, p, s);
}

// cuTensorMapEncodeTiled from the driver through the runtime, so nothing
// links libcuda; null if the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// A bf16 (B, heads, T, width) tensor addressed through (batch, head, time)
// strides in elements, as a 4D map (width, heads, T, B) whose box is (64
// columns, box_heads, box_t, 1) under the 128-byte swizzle. The stride of a
// size-1 dim is never used: any multiple of 16 bytes stands in for it.
bool tensor_map(CUtensorMap* m, const void* ptr, int B, int heads, int T, int width,
                long long sb, long long sh, long long st, int box_heads, int box_t) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const auto bytes = [](long long s, int n) -> cuuint64_t {
    return n == 1 ? 16 : static_cast<cuuint64_t>(s) * 2;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(sh, heads), bytes(st, T), bytes(sb, B)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_t), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV>
cudaError_t launch_dkv_wgmma(const BwdParams& p, cudaStream_t s) {
  using C = DkvWg<D, DV>;
  const int G = p.H / p.KV;
  if (G > C::BQ || p.Tk < C::BN) return cudaErrorInvalidValue;
  const int n = C::BQ / G;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, p.q, p.B, p.H, p.Tq, D, p.sqb, p.sqh, p.sqt, G, n)
      || !tensor_map(&tk, p.k, p.B, p.KV, p.Tk, D, p.skb, p.skh, p.skt, 1, C::BN)
      || !tensor_map(&tv, p.v, p.B, p.KV, p.Tk, DV, p.svb, p.svh, p.svt, 1, C::BN)
      || !tensor_map(&tdo, p.dout, p.B, p.H, p.Tq, DV, p.sdob, p.sdoh, p.sdot, G, n)) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = bwd_dkv_wgmma<D, DV>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::smem);
  if (e != cudaSuccess) return e;
  // key tiles on y: every head's first (longest causal) tile is dispatched first
  const dim3 grid(p.KV * p.B, (p.Tk + C::BN - 1) / C::BN);
  kernel<<<grid, kWgThreads, C::smem, s>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

int run(bool dkv, int D, int DV, int is_bf16, int design, const BwdParams& p,
        void* stream) {
  if (p.B == 0 || p.H == 0 || p.Tq == 0 || p.Tk == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  auto s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  cudaError_t e;
  if (dkv && design == 1) {  // warpgroup MMA: bf16 at (128, 128) and (192, 128)
    e = !bf16 ? cudaErrorInvalidValue
        : D == 128 && DV == 128 ? launch_dkv_wgmma<128, 128>(p, s)
        : D == 192 && DV == 128 ? launch_dkv_wgmma<192, 128>(p, s)
                                : cudaErrorInvalidValue;
    return static_cast<int>(e);
  }
  if (D != DV) {
    e = D == 192 && DV == 128 ? launch_dv<192, 128>(dkv, bf16, p, s) : cudaErrorInvalidValue;
    return static_cast<int>(e);
  }
  switch (D) {
    case 32: e = dkv ? launch_dkv<32>(bf16, p, s) : launch_dq<32>(bf16, p, s); break;
    case 64: e = dkv ? launch_dkv<64>(bf16, p, s) : launch_dq<64>(bf16, p, s); break;
    case 80: e = dkv ? launch_dkv<80>(bf16, p, s) : launch_dq<80>(bf16, p, s); break;
    case 128: e = dkv ? launch_dkv<128>(bf16, p, s) : launch_dq<128>(bf16, p, s); break;
    case 256: e = dkv ? launch_dkv<256>(bf16, p, s) : launch_dq<256>(bf16, p, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // namespace

// q, dq: (B, H, Tq, D); o, dO: (B, H, Tq, DV); k: (B, KV, Tk, D); v: (B,
// KV, Tk, DV); lse, delta: (B, H, Tq) fp32, contiguous. Addressed through
// (batch, head, time) strides in elements as flash_fwd, every row 16-byte
// aligned; D == DV in {32, 64, 80, 128, 256}, or (D, DV) = (192, 128) with
// bf16. Writes dq (in q's dtype) and delta = rowsum(dO * O) for every row.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* delta, void* dq,
                            int B, int H, int KV, int Tq, int Tk, int D, int DV,
                            int sqb, int sqh, int sqt, int skb, int skh, int skt,
                            int svb, int svh, int svt, int sob, int soh, int sot,
                            int sdob, int sdoh, int sdot, int sgqb, int sgqh, int sgqt,
                            float scale, int causal, int window, float cap, int kv_len,
                            int is_bf16, void* stream) {
  const BwdParams p{q, k, v, o, dout, static_cast<const float*>(lse),
                    static_cast<float*>(delta), dq, nullptr, nullptr,
                    B, H, KV, Tq, Tk,
                    sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot,
                    sdob, sdoh, sdot,
                    sgqb, sgqh, sgqt, 0, 0, 0, 0, 0, 0,
                    scale, causal, window, cap, kv_len, cap > 0.f ? 1.f / cap : 0.f};
  return run(false, D, DV, is_bf16, 0, p, stream);
}

// dk, dv: like k and v, in k's dtype, one gradient per KV head (the sum
// over its G query heads); delta as flash_bwd_dq wrote it; other arguments
// as flash_bwd_dq. design 0: the mma.sync (bf16) or CUDA-core (fp32)
// kernels; 1: the warpgroup-MMA kernel (bf16 at (128, 128) or (192, 128),
// Tk >= 128, G <= 64, every tensor's base and strides 16-byte aligned).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             int B, int H, int KV, int Tq, int Tk, int D, int DV,
                             int sqb, int sqh, int sqt, int skb, int skh, int skt,
                             int svb, int svh, int svt, int sdob, int sdoh, int sdot,
                             int sgkb, int sgkh, int sgkt, int sgvb, int sgvh, int sgvt,
                             float scale, int causal, int window, float cap, int kv_len,
                             int is_bf16, int design, void* stream) {
  const BwdParams p{q, k, v, nullptr, dout, static_cast<const float*>(lse),
                    static_cast<float*>(const_cast<void*>(delta)), nullptr, dk, dv,
                    B, H, KV, Tq, Tk,
                    sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, 0, 0, 0,
                    sdob, sdoh, sdot,
                    0, 0, 0, sgkb, sgkh, sgkt, sgvb, sgvh, sgvt,
                    scale, causal, window, cap, kv_len, cap > 0.f ? 1.f / cap : 0.f};
  return run(true, D, DV, is_bf16, design, p, stream);
}
