// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_fwd -> _flash_kernel.
//   o = softmax(mask(softcap(q k^T * scale))) v per (batch, query head),
//   GQA by KV head h / G, plus lse = m + log(l) in fp32 (0 where l == 0).
//
// What bounds it on the card: at the serving and env shapes (T = 26,
// head_dim 32, bf16) a (b, KV head) group is ~8 KB of q/k/v/o and
// ~0.2 MFLOP, so device memory bounds it (~1.6 us for 256 sequences at
// 3.35 TB/s) and in practice the latency of one block does; at the learner
// shape (T = 4096, window 512, fp32) the QK^T and PV products on the CUDA
// cores bound it (~1.1 GFLOP at 67 TFLOP/s, IEEE fp32).
//
// Design. Both regimes share the block layout and the masks:
// - One block per (tile of 64 stacked rows, KV head, batch). The G query
//   heads of a KV head are stacked position-major: stacked row r is
//   position r / G of query head kvh * G + r % G. A block therefore holds
//   every head of the group at consecutive positions and loads the
//   group's K/V once (GQA reuse); at T = 26, G = 2 the 52 rows of a group
//   are one block.
// - The KV sweep visits live tiles only: up to the tile's last position
//   when causal, from its first position's window horizon, up to kv_len.
//   K/V tiles are double-buffered in shared memory with 16-byte cp.async:
//   the next tile loads while this one is computed.
// - Masked keys get p = 0 exactly instead of exp(NEG_INF - m), so a row
//   with no live key ends with l == 0, o = 0 and lse = 0 (the l > 0 guard of
//   _flash_kernel) and never divides by zero.
// - q, k, v and o are read and written through (batch, head, time)
//   strides: the model's (B, T, H, d) activations need no transpose copy.
//   Rows and base pointers must be 16-byte aligned; the wrapper checks.
//
// bf16 inputs: tensor cores (mma.sync m16n8k16, bf16 in, fp32 out). Each
//   of 4 warps owns 16 stacked rows. S = Q K^T comes from ldmatrix
//   fragments of the bf16 tiles; the online softmax runs on the
//   accumulator fragments (a row lives in a quad of lanes: max and sum take
//   2 shuffles); P V reuses the S accumulators as A fragments, so p never
//   goes through shared memory. Non-mixed keeps p at fp32 precision as
//   repro's upcast does (kernel.py:56-60): p = hi + lo in bf16, two MMAs.
//   mixed rounds p to bf16 once, as kernel.py:84. l sums unrounded p.
//   KV tiles are 32 keys (T = 26 is one tile); a warp skips a tile in
//   which none of its rows has a live key.
// fp32 inputs: register-tiled CUDA cores, IEEE fp32 (no TF32). 256 threads
//   as 16 x 16; thread (ty, tx) computes S for rows ty + 16 i (i < 4) and
//   keys tx + 16 j from float4 reads of Q and K in shared memory (64 FMAs
//   per 8 shared loads). Row max and sum reduce over the 16 lanes that
//   share a row (4 shuffles). P goes through shared memory into a second
//   register-tiled product with V: thread (ty, tx) owns o columns
//   2 tx + 32 c of its 4 rows. A head dim that is not a multiple of 32
//   (hubert's 80) ends with a pass of 16 columns that half the lanes
//   (tx < 8) take. A tile whose pairs are all live skips the per-pair
//   masks. At T = 4096 the 256 blocks are ~2 per SM, 16 warps.
//
// Latent attention (DeepSeek-V3's MLA, Kimi K2's) has q and k 192 wide and
// v 128: flash_fwd_bf16_dv<192, 128> is the bf16 kernel's body with q and
// k tiles at their width and v's and o's at theirs, so neither is padded
// to 256 (1.6x the work the roofline counts). Its tiling is the D = 128
// kernel's: 64 rows a block, 4 warps of 16, 32-key tiles. A wider
// row tile would halve K/V traffic per row, but at H = KV = 64 (G = 1) and
// T = 8192 the grid is already 128 x 64 blocks, K/V reads are L2 hits,
// and S's 12 k-steps and P V's 8 n-tile pairs keep 64 o accumulators and
// the S fragments within one block's registers; shared memory is 67 KB
// (3 blocks an SM). It has no fp32 regime.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;                // bf16 regime: 4 warps of 16 rows
constexpr int kF32Threads = 256;             // fp32 regime: 16 x 16 threads
constexpr int kBM = 64;                      // stacked rows per block
constexpr float kNegInf = -1073741824.f;     // -2**30, the reference's NEG_INF

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, KV, Tq, Tk;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot;
  float scale;
  int causal, window;
  float cap;
  int kv_len, mixed;
  float inv_cap;
};

__device__ __forceinline__ bool pair_live(int t, int j, int kv_end, const FlashParams& p) {
  bool live = j < kv_end;
  if (p.causal) live = live && j <= t;
  if (p.window > 0) live = live && t - j < p.window;
  return live;
}

// Live keys [lo, hi) of query positions [t_min, t_max].
__device__ __forceinline__ void key_range(const FlashParams& p, int t_min, int t_max, int& lo,
                                          int& hi) {
  hi = min(p.Tk, p.kv_len);
  if (p.causal) hi = min(hi, t_max + 1);
  lo = p.window > 0 ? max(0, t_min - p.window + 1) : 0;
}

// s * scale, soft-capped as tanh(s / cap) * cap (inv_cap = 1 / cap: a
// multiply, not a division per pair)
__device__ __forceinline__ float softcap(float s, const FlashParams& p) {
  s *= p.scale;
  return p.cap > 0.f ? tanhf(s * p.inv_cap) * p.cap : s;
}

// Shared memory of each regime, in bytes. The bf16 tiles of q and k are
// DQ wide, v's DV (DQ == DV but for latent attention's (192, 128)).
template <int DQ, int DV = DQ> struct Bf16Tile {
  static constexpr int BN = 32;                 // keys per KV tile
  static constexpr int LD = DQ + 8;             // row pitch: 16*odd bytes, ldmatrix conflict-free
  static constexpr int LDV = DV + 8;
  static constexpr int smem = (kBM + 2 * BN) * LD * 2 + 2 * BN * LDV * 2;
};
template <int D> struct F32Tile {
  static constexpr int BN = D <= 128 ? 64 : 32;
  static constexpr int LD = D + 4;              // float4 reads of 8 rows hit 8 distinct chunks
  static constexpr int PLD = BN + 16;           // P row pitch: stores of 2 rows x 16 keys hit 32 banks
  static constexpr int smem = ((kBM + 4 * BN) * LD + kBM * PLD) * 4;
};

// -- bf16: tensor cores ----------------------------------------------------------

// The kernel's body, q and k D wide and v and o DV: flash_fwd_bf16<D> is
// it at D == DV, flash_fwd_bf16_dv<D, DV> at latent attention's widths.
template <int D, int DV>
__device__ __forceinline__ void fwd_bf16(const FlashParams& p) {
  using T = __nv_bfloat16;
  constexpr int BN = Bf16Tile<D, DV>::BN, LD = Bf16Tile<D, DV>::LD;
  constexpr int LDV = Bf16Tile<D, DV>::LDV;
  constexpr int NT = BN / 8;  // S n-tiles per warp
  constexpr int DT = DV / 8;  // o n-tiles per warp
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);  // [kBM][LD]
  T* Ks = Qs + kBM * LD;                // [2][BN][LD]
  T* Vs = Ks + 2 * BN * LD;             // [2][BN][LDV]

  const int b = blockIdx.z, kvh = blockIdx.y, r0 = blockIdx.x * kBM;
  const int G = p.H / p.KV, R = G * p.Tq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const T* qb = static_cast<const T*>(p.q) + b * p.sqb + kvh * G * p.sqh;
  const T* kb = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* vb = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;

  repro::stage_rows<T, D, kBM, LD, kThreads>(Qs, [&](int i) -> const T* {
    const int r = r0 + i;
    return r < R ? qb + (r % G) * p.sqh + (r / G) * p.sqt : nullptr;
  });

  int lo, hi;
  key_range(p, r0 / G, (min(r0 + kBM, R) - 1) / G, lo, hi);
  const int kt_lo = lo / BN, kt_hi = hi > lo ? (hi + BN - 1) / BN : kt_lo;
  // this warp's rows and their own live keys, to skip a tile they do not see
  const int wr0 = r0 + warp * 16;
  int wlo = 0, whi = 0;
  if (wr0 < R) key_range(p, wr0 / G, (min(wr0 + 16, R) - 1) / G, wlo, whi);
  const int ra = wr0 + gq, rb = ra + 8;  // this lane's two rows
  const int ta = ra < R ? ra / G : -1, tb = rb < R ? rb / G : -1;
  const int kv_end = min(p.Tk, p.kv_len);

  auto stage_kv = [&](int kt, int buf) {
    const int k0 = kt * BN;
    const int Tk = p.Tk;
    auto at = [k0, Tk](const T* base, long long st) {
      return [=](int i) -> const T* { return k0 + i < Tk ? base + (k0 + i) * st : nullptr; };
    };
    repro::stage_rows<T, D, BN, LD, kThreads>(Ks + buf * BN * LD, at(kb, p.skt));
    repro::stage_rows<T, DV, BN, LDV, kThreads>(Vs + buf * BN * LDV, at(vb, p.svt));
  };

  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (kt_lo < kt_hi) stage_kv(kt_lo, 0);
  repro::cp_async_commit();
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    repro::cp_async_wait_all();
    __syncthreads();  // tile kt (and Q) landed; every warp is done with tile kt - 1
    if (kt + 1 < kt_hi) stage_kv(kt + 1, buf ^ 1);
    repro::cp_async_commit();
    const int k0 = kt * BN;
    if (k0 >= whi || k0 + BN <= wlo) continue;  // warp-uniform: no live key for these rows
    const T* Kt = Ks + buf * BN * LD;
    const T* Vt = Vs + buf * BN * LDV;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4];
      repro::ldmatrix_x4(a, Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                                + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        unsigned bk[4];
        repro::ldmatrix_x4(bk, Kt + (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16
                                   + ((lane >> 3) & 1) * 8);
        repro::mma_bf16(s[n], a, bk[0], bk[1]);
        repro::mma_bf16(s[n + 1], a, bk[2], bk[3]);
      }
    }

    // scores, masks and the online softmax on the fragments: element e of
    // n-tile n is row (e < 2 ? ra : rb), key k0 + 8 n + 2 cq + (e & 1)
    unsigned live = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = e < 2 ? ta : tb, j = k0 + n * 8 + 2 * cq + (e & 1);
        const float x = softcap(s[n][e], p);
        s[n][e] = x;
        if (t >= 0 && pair_live(t, j, kv_end, p)) {
          live |= 1u << (n * 4 + e);
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::kFullMask, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::kFullMask, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);  // 0 on the first live tile, 1 while none
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = (live >> (n * 4 + e)) & 1u ? expf(s[n][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += pe;  // unrounded p
        s[n][e] = pe;
      }

    // o += p V: the S accumulators of n-tiles 2 kk, 2 kk + 1 are the A
    // fragment of keys 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      unsigned ah[4], al[4];
      repro::split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      repro::split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      repro::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      repro::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        unsigned bv[4];
        repro::ldmatrix_x4_trans(bv, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV
                                         + n * 8 + (lane >> 4) * 8);
        repro::mma_bf16(o[n], ah, bv[0], bv[1]);
        repro::mma_bf16(o[n + 1], ah, bv[2], bv[3]);
        if (!p.mixed) {
          repro::mma_bf16(o[n], al, bv[0], bv[1]);
          repro::mma_bf16(o[n + 1], al, bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(repro::kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(repro::kFullMask, l[r], 2);
  }
  repro::cp_async_wait_all();  // no copy outlives the block (an empty sweep)
  T* ob = static_cast<T*>(p.o) + b * p.sob + kvh * G * p.soh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rb : ra, t = r ? tb : ta;
    if (t < 0) continue;
    const int g = row % G;
    const float safe = l[r] == 0.f ? 1.f : l[r];
    T* orow = ob + g * p.soh + t * p.sot + 2 * cq;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<unsigned*>(orow + n * 8) =
          repro::pack_bf16(o[n][2 * r] / safe, o[n][2 * r + 1] / safe);
    if (cq == 0)
      p.lse[(static_cast<long long>(b) * p.H + kvh * G + g) * p.Tq + t] =
          l[r] > 0.f ? m[r] + logf(l[r]) : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const FlashParams p) {
  fwd_bf16<D, D>(p);
}

// Latent attention's widths, q and k 192 and v 128 (DeepSeek-V3's MLA,
// Kimi K2's): the same tiles, q and k staged at their own pitch. A tile of
// 64 rows x 32 keys costs 12 k-steps for S and 8 n-tile pairs for P V, the
// shapes the D = 128 kernel already balances; shared memory is 67 KB
// (q 64 x 200, k 2 x 32 x 200, v 2 x 32 x 136 bf16), 3 blocks an SM.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_dv(const FlashParams p) {
  fwd_bf16<D, DV>(p);
}

// -- fp32: register-tiled CUDA cores --------------------------------------------

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32(const FlashParams p) {
  constexpr int BN = F32Tile<D>::BN, LD = F32Tile<D>::LD, PLD = F32Tile<D>::PLD;
  constexpr int KJ = BN / 16;  // keys per thread
  constexpr int CJ = (D + 31) / 32;  // float2 o columns per thread and row
  static_assert(D % 16 == 0, "the last column pass takes 16 or 32 columns");
  // column pass c of this lane: every lane in the full passes, tx < 8 in a
  // last pass of 16 (c < D / 32 folds to true when unrolled)
  const auto has_cols = [](int c, int tx) { return c < D / 32 || 2 * tx + 32 * c < D; };
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBM][LD]
  float* Ks = Qs + kBM * LD;                    // [2][BN][LD]
  float* Vs = Ks + 2 * BN * LD;                 // [2][BN][LD]
  float* Ps = Vs + 2 * BN * LD;                 // [kBM][PLD]

  const int b = blockIdx.z, kvh = blockIdx.y, r0 = blockIdx.x * kBM;
  const int G = p.H / p.KV, R = G * p.Tq;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qb = static_cast<const float*>(p.q) + b * p.sqb + kvh * G * p.sqh;
  const float* kb = static_cast<const float*>(p.k) + b * p.skb + kvh * p.skh;
  const float* vb = static_cast<const float*>(p.v) + b * p.svb + kvh * p.svh;

  repro::stage_rows<float, D, kBM, LD, kF32Threads>(Qs, [&](int i) -> const float* {
    const int r = r0 + i;
    return r < R ? qb + (r % G) * p.sqh + (r / G) * p.sqt : nullptr;
  });

  const int t_min = r0 / G, t_max = (min(r0 + kBM, R) - 1) / G;
  int lo, hi;
  key_range(p, t_min, t_max, lo, hi);
  const int kt_lo = lo / BN, kt_hi = hi > lo ? (hi + BN - 1) / BN : kt_lo;
  const int kv_end = min(p.Tk, p.kv_len);
  int t[4];  // positions of this thread's rows ty + 16 i, -1 past the end
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    t[i] = r < R ? r / G : -1;
  }

  auto stage_kv = [&](int kt, int buf) {
    const int k0 = kt * BN;
    const int Tk = p.Tk;
    auto at = [k0, Tk](const float* base, long long st) {
      return [=](int i) -> const float* { return k0 + i < Tk ? base + (k0 + i) * st : nullptr; };
    };
    repro::stage_rows<float, D, BN, LD, kF32Threads>(Ks + buf * BN * LD, at(kb, p.skt));
    repro::stage_rows<float, D, BN, LD, kF32Threads>(Vs + buf * BN * LD, at(vb, p.svt));
  };

  float o[4][CJ][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) o[i][c][0] = o[i][c][1] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.f;

  if (kt_lo < kt_hi) stage_kv(kt_lo, 0);
  repro::cp_async_commit();
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    repro::cp_async_wait_all();
    __syncthreads();  // tile kt landed; tile kt - 1 and Ps are consumed
    if (kt + 1 < kt_hi) stage_kv(kt + 1, buf ^ 1);
    repro::cp_async_commit();
    const int k0 = kt * BN;
    const float* Kt = Ks + buf * BN * LD;
    const float* Vt = Vs + buf * BN * LD;
    // every pair of the tile live (block-uniform): skip the per-pair masks
    const bool full = r0 + kBM <= R && k0 + BN <= kv_end
                      && (!p.causal || k0 + BN - 1 <= t_min)
                      && (p.window <= 0 || t_max - k0 < p.window);

    float s[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(Kt + (tx + 16 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = repro::dot4(qv[i], kv, s[i][j]);
      }
    }

    unsigned live = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float x = softcap(s[i][j], p);
        s[i][j] = x;
        if (full || (t[i] >= 0 && pair_live(t[i], k0 + tx + 16 * j, kv_end, p))) {
          live |= 1u << (i * KJ + j);
          mx = fmaxf(mx, x);
        }
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)  // the 16 lanes of row ty + 16 i
        mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < CJ; ++c) o[i][c][0] *= alpha, o[i][c][1] *= alpha;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float pe = (live >> (i * KJ + j)) & 1u ? expf(s[i][j] - m_new) : 0.f;
        l[i] += pe;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = pe;
      }
    }
    __syncthreads();  // P of the whole tile is in shared memory

#pragma unroll 4
    for (int kk = 0; kk < BN; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PLD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          if (!has_cols(c, tx)) continue;
          const float2 vv = *reinterpret_cast<const float2*>(Vt + (kk + u) * LD + 2 * tx + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pu = repro::lane4(pv[i], u);
            o[i][c][0] = fmaf(pu, vv.x, o[i][c][0]);
            o[i][c][1] = fmaf(pu, vv.y, o[i][c][1]);
          }
        }
      }
    }
  }

  repro::cp_async_wait_all();  // no copy outlives the block (an empty sweep)
  float* ob = static_cast<float*>(p.o) + b * p.sob + kvh * G * p.soh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l[i] += __shfl_xor_sync(repro::kFullMask, l[i], off);
    if (t[i] < 0) continue;
    const int g = (r0 + ty + 16 * i) % G;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    float* orow = ob + g * p.soh + t[i] * p.sot + 2 * tx;
#pragma unroll
    for (int c = 0; c < CJ; ++c)
      if (has_cols(c, tx))
        *reinterpret_cast<float2*>(orow + 32 * c) =
            make_float2(o[i][c][0] / safe, o[i][c][1] / safe);
    if (tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + kvh * G + g) * p.Tq + t[i]] =
          l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
  }
}

// -- launch ------------------------------------------------------------------------

template <typename K>
cudaError_t launch(K* kernel, int threads, int smem, const FlashParams& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = p.H / p.KV * p.Tq;
  const dim3 grid((rows + kBM - 1) / kBM, p.KV, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(bool bf16, const FlashParams& p, cudaStream_t s) {
  return bf16 ? launch(flash_fwd_bf16<D>, kThreads, Bf16Tile<D>::smem, p, s)
              : launch(flash_fwd_f32<D>, kF32Threads, F32Tile<D>::smem, p, s);
}

template <int D, int DV>
cudaError_t launch_dv(bool bf16, const FlashParams& p, cudaStream_t s) {
  if (!bf16) return cudaErrorInvalidValue;  // bf16 only at these widths
  return launch(flash_fwd_bf16_dv<D, DV>, kThreads, Bf16Tile<D, DV>::smem, p, s);
}

}  // namespace

// q: (B, H, Tq, D); k: (B, KV, Tk, D); v: (B, KV, Tk, DV); o: (B, H, Tq,
// DV); lse: (B, H, Tq) fp32, contiguous. q/k/v/o are addressed through
// their (batch, head, time) strides in elements; the last dim is
// contiguous, and every row starts 16-byte aligned. D == DV in {32, 64,
// 80, 128, 256}, or (D, DV) = (192, 128) with bf16.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int H, int KV, int Tq, int Tk, int D, int DV,
                         int sqb, int sqh, int sqt, int skb, int skh, int skt,
                         int svb, int svh, int svt, int sob, int soh, int sot,
                         float scale, int causal, int window, float cap, int kv_len,
                         int is_bf16, int mixed, void* stream) {
  if (B == 0 || H == 0 || Tq == 0) return static_cast<int>(cudaGetLastError());
  const FlashParams p{q, k, v, o, static_cast<float*>(lse), B, H, KV, Tq, Tk,
                      sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot,
                      scale, causal, window, cap, kv_len, mixed,
                      cap > 0.f ? 1.f / cap : 0.f};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D != DV) {
    e = D == 192 && DV == 128 ? launch_dv<192, 128>(is_bf16, p, s) : cudaErrorInvalidValue;
    return static_cast<int>(e);
  }
  switch (D) {
    case 32: e = launch_d<32>(is_bf16, p, s); break;
    case 64: e = launch_d<64>(is_bf16, p, s); break;
    case 80: e = launch_d<80>(is_bf16, p, s); break;
    case 128: e = launch_d<128>(is_bf16, p, s); break;
    case 256: e = launch_d<256>(is_bf16, p, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
