// Flash-attention backward for Hopper (sm_90a): the FlashAttention-2
// recompute scheme in three kernels.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_bwd_preprocess -> _bwd_preprocess_kernel:
//     delta = rowsum(dO * O), fp32 (B, H, Tq);
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
// bf16) device memory: each pass reads q, k, v, dO and writes its
// gradients once, ~17 MB in all.
//
// Design:
// - preprocess: one warp per row; o is read as the forward stored it (in
//   q's dtype), as _bwd_preprocess_kernel reads it.
// - dq (simple and right first): one 128-thread block per (q tile of 32
//   rows, head, batch), all arithmetic IEEE fp32 on the CUDA cores with
//   inputs staged as fp32. Each warp owns 8 query rows; for a row, lane j
//   recomputes the score of key j of the staged KV tile and the warp
//   broadcasts ds_j with shuffles into the row's D/32 dq columns per lane,
//   accumulated in registers. The loop visits live KV tiles only: up to
//   the diagonal when causal, from the window's horizon when windowed, up
//   to kv_len (the _tile_live skips).
// - dk/dv: one block per (KV tile, KV head, batch) looping over the live q
//   tiles of the whole G-head group (below). Two regimes by dtype: bf16
//   inputs on the tensor cores (mma.sync m16n8k16, p and ds fed as bf16
//   hi + lo so they keep fp32 precision as _tile_grads does), fp32 inputs
//   register-tiled on the CUDA cores in IEEE fp32. dk and dv are written
//   per KV head: repro's per-query-head buffers and their group sum (a TPU
//   grid-order constraint, kernel.py:328-332) are gone, and with no
//   atomics the result is deterministic.
// - Masked entries get p = 0 and ds = 0 explicitly rather than through
//   exp(NEG_INF - lse): a row with no live key has lse = 0 from the port's
//   forward, and only the mask zeroes it.
// - q, k, v, dO and the gradients are addressed through (batch, head, time)
//   strides, so the model's (B, T, H, d) layout needs no transpose copy.
//   The dk/dv kernels load with 16-byte cp.async: rows and base pointers
//   must be 16-byte aligned (the wrapper checks).
#include "common.cuh"

namespace {

constexpr int kBK = 32;                       // dq: keys per KV tile
constexpr int kWarps = 4;                     // dq: warps per block
constexpr int kRowsPerWarp = 8;               // dq: query rows per warp
constexpr int kBQ = kWarps * kRowsPerWarp;    // query rows per q tile

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Tq) contiguous
  const float* delta;  // (B, H, Tq) contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, H, KV, Tq, Tk;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sdob, sdoh, sdot;
  long long sgqb, sgqh, sgqt, sgkb, sgkh, sgkt, sgvb, sgvh, sgvt;  // dq, dk, dv
  float scale;
  int causal, window;
  float cap;
  int kv_len;
};

// The recomputed probability and score gradient of one (query, key) pair.
__device__ __forceinline__ void pair_grads(float s, float dp, float lse, float delta,
                                           bool live, const BwdParams& p, float& pj,
                                           float& ds) {
  s *= p.scale;
  float dtanh = 1.f;
  if (p.cap > 0.f) {
    const float t = tanhf(s / p.cap);
    s = t * p.cap;
    dtanh = 1.f - t * t;
  }
  pj = live ? expf(s - lse) : 0.f;  // masked: exactly 0
  ds = live ? pj * (dp - delta) * dtanh : 0.f;
}

__device__ __forceinline__ bool pair_live(int qpos, int j, int kv_end, const BwdParams& p) {
  bool live = j < kv_end;
  if (p.causal) live = live && j <= qpos;
  if (p.window > 0) live = live && qpos - j < p.window;
  return live;
}

// -- preprocess -------------------------------------------------------------

constexpr int kPreWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kPreWarps * 32)
bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int H, int Tq, int D, int rows,
                      long long sob, long long soh, long long sot,
                      long long sdb, long long sdh, long long sdt) {
  const int row = blockIdx.x * kPreWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int t = row % Tq, bh = row / Tq, h = bh % H, b = bh / H;
  const T* orow = o + b * sob + h * soh + t * sot;
  const T* drow = dout + b * sdb + h * sdh + t * sdt;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(repro::to_float(orow[c]), repro::to_float(drow[c]), acc);
  acc = repro::warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// -- dq ---------------------------------------------------------------------

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kBQ * D + 2 * kBK * (D + 1)) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32) bwd_dq_kernel(const BwdParams p) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of the warp size");
  constexpr int C = D / 32;  // dq columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kBQ][D]
  float* dOs = Qs + kBQ * D;        // [kBQ][D]
  float* Ks = dOs + kBQ * D;        // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);   // [kBK][D + 1]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.sdob + h * p.sdoh;
  const T* kb = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* vb = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;
  const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Tq;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D, t = q0 + r;
    const bool in = t < p.Tq;
    Qs[idx] = in ? repro::to_float(qb[t * p.sqt + c]) : 0.f;
    dOs[idx] = in ? repro::to_float(dob[t * p.sdot + c]) : 0.f;
  }
  float lse[kRowsPerWarp], delta[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qpos = q0 + warp * kRowsPerWarp + i;
    lse[i] = qpos < p.Tq ? p.lse[row0 + qpos] : 0.f;
    delta[i] = qpos < p.Tq ? p.delta[row0 + qpos] : 0.f;
  }

  // live key range [lo, hi) for the whole q tile, as flash_fwd.cu
  const int q_end = min(q0 + kBQ, p.Tq);
  const int kv_end = min(p.Tk, p.kv_len);
  int hi = kv_end;
  if (p.causal) hi = min(hi, q_end);
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt_lo = lo / kBK;
  const int kt_hi = hi > lo ? (hi + kBK - 1) / kBK : kt_lo;

  float acc[kRowsPerWarp][C];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();  // the previous tile is consumed (and Qs, dOs are staged)
    const int k0 = kt * kBK;
    for (int idx = threadIdx.x; idx < kBK * D; idx += blockDim.x) {
      const int r = idx / D, c = idx % D, t = k0 + r;
      const bool in = t < p.Tk;
      Ks[r * (D + 1) + c] = in ? repro::to_float(kb[t * p.skt + c]) : 0.f;
      Vs[r * (D + 1) + c] = in ? repro::to_float(vb[t * p.svt + c]) : 0.f;
    }
    __syncthreads();

    const int j = k0 + lane;  // this lane's key
    const float* kr = Ks + lane * (D + 1);
    const float* vr = Vs + lane * (D + 1);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i, qpos = q0 + r;
      if (qpos < p.Tq) {  // warp-uniform
        const bool live = pair_live(qpos, j, kv_end, p);
        if (__any_sync(repro::kFullMask, live)) {  // skip a row's dead tile
          const float* qr = Qs + r * D;
          const float* dor = dOs + r * D;
          float s = 0.f, dp = 0.f;
#pragma unroll 8
          for (int e = 0; e < D; ++e) {
            s = fmaf(qr[e], kr[e], s);
            dp = fmaf(dor[e], vr[e], dp);
          }
          float pj, ds;
          pair_grads(s, dp, lse[i], delta[i], live, p, pj, ds);
          float part[C];
#pragma unroll
          for (int c = 0; c < C; ++c) part[c] = 0.f;
#pragma unroll 8
          for (int jj = 0; jj < kBK; ++jj) {
            const float db = __shfl_sync(repro::kFullMask, ds, jj);
            const float* kc = Ks + jj * (D + 1) + lane;
#pragma unroll
            for (int c = 0; c < C; ++c) part[c] = fmaf(db, kc[32 * c], part[c]);
          }
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] += part[c] * p.scale;
        }
      }
    }
  }

  T* dqb = static_cast<T*>(p.dq) + b * p.sgqb + h * p.sgqh;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qpos = q0 + warp * kRowsPerWarp + i;
    if (qpos < p.Tq) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        dqb[qpos * p.sgqt + lane + 32 * c] = repro::from_float<T>(acc[i][c]);
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
// and positions (-1 past the end), into one buffer.
template <typename T, int D, int BM, int LD, int THREADS>
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
  repro::stage_rows<T, D, BM, LD, THREADS>(dOd, [=](int i) -> const T* {
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

template <int D> struct DkvBf16 {
  static constexpr int BN = 16 * kDkvBf16Warps, BM = D <= 64 ? 64 : 32, LD = D + 8;
  static constexpr int smem = (2 * BN + 4 * BM) * LD * 2 + 2 * 3 * BM * 4;
};

template <int D>
__global__ void __launch_bounds__(kDkvBf16Warps * 32) bwd_dkv_bf16(const BwdParams p) {
  using T = __nv_bfloat16;
  constexpr int THREADS = kDkvBf16Warps * 32;
  constexpr int BN = DkvBf16<D>::BN, BM = DkvBf16<D>::BM, LD = DkvBf16<D>::LD;
  constexpr int CW = 32;      // columns (stacked q rows) per pass over a staged tile
  constexpr int NT = CW / 8;  // S^T n-tiles per pass
  constexpr int DT = D / 8;   // dk/dv n-tiles per warp
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);  // [BN][LD]
  T* Vs = Ks + BN * LD;                 // [BN][LD]
  T* Qs = Vs + BN * LD;                 // [2][BM][LD]
  T* dOs = Qs + 2 * BM * LD;            // [2][BM][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BM * LD);  // [2][BM]
  float* Ds = Ls + 2 * BM;                                  // [2][BM]
  int* Ts = reinterpret_cast<int*>(Ds + 2 * BM);            // [2][BM]

  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * BN;
  const int G = p.H / p.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const T* kb = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* vb = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;
  {
    const int Tk = p.Tk;
    const long long skt = p.skt, svt = p.svt;
    repro::stage_rows<T, D, BN, LD, THREADS>(Ks, [=](int i) -> const T* {
      return k0 + i < Tk ? kb + (k0 + i) * skt : nullptr;
    });
    repro::stage_rows<T, D, BN, LD, THREADS>(Vs, [=](int i) -> const T* {
      return k0 + i < Tk ? vb + (k0 + i) * svt : nullptr;
    });
  }

  int q_lo, q_hi, wq_lo, wq_hi;
  query_range(p, k0, BN, q_lo, q_hi);
  query_range(p, k0 + warp * 16, 16, wq_lo, wq_hi);  // this warp's keys
  const int rt_lo = q_lo * G / BM;
  const int rt_hi = q_hi > q_lo ? (q_hi * G + BM - 1) / BM : rt_lo;
  const int kv_end = min(p.Tk, p.kv_len);
  const int ka = k0 + warp * 16 + gq, kb8 = ka + 8;  // this lane's two keys

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  auto stage = [&](int rt, int buf) {
    stage_q_tile<T, D, BM, LD, THREADS>(p, b, kvh, rt * BM, Qs + buf * BM * LD,
                                        dOs + buf * BM * LD, Ls + buf * BM, Ds + buf * BM,
                                        Ts + buf * BM);
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
      const T* dOt = dOs + buf * BM * LD + c0 * LD;
      const float* Lt = Ls + buf * BM + c0;
      const float* Dt = Ds + buf * BM + c0;
      const int* Tt = Ts + buf * BM + c0;

      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_off = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16
                          + (lane >> 4) * 8;
        unsigned ak[4], av[4];
        repro::ldmatrix_x4(ak, Ks + a_off);
        repro::ldmatrix_x4(av, Vs + a_off);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          const int b_off = (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16
                            + ((lane >> 3) & 1) * 8;
          unsigned bq[4], bd[4];
          repro::ldmatrix_x4(bq, Qt + b_off);
          repro::mma_bf16(st[n], ak, bq[0], bq[1]);
          repro::mma_bf16(st[n + 1], ak, bq[2], bq[3]);
          repro::ldmatrix_x4(bd, dOt + b_off);
          repro::mma_bf16(dpt[n], av, bd[0], bd[1]);
          repro::mma_bf16(dpt[n + 1], av, bd[2], bd[3]);
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
#pragma unroll
        for (int n = 0; n < DT; n += 2) {
          const int b_off = (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n * 8
                            + (lane >> 4) * 8;
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
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int c = n * 8 + 2 * cq;
      *reinterpret_cast<unsigned*>(dkb + j * p.sgkt + c) =
          repro::pack_bf16(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
      *reinterpret_cast<unsigned*>(dvb + j * p.sgvt + c) =
          repro::pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
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
//   columns 4 cc + 32 c (64 FMAs per 12 wavefronts). At the end the second
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
  constexpr int CJ = D / 32;   // float4 columns per thread and key in phase 2
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
  const float* kb = static_cast<const float*>(p.k) + b * p.skb + kvh * p.skh;
  const float* vb = static_cast<const float*>(p.v) + b * p.svb + kvh * p.svh;
  {
    const int Tk = p.Tk;
    const long long skt = p.skt, svt = p.svt;
    repro::stage_rows<float, D, BN, LD, THREADS>(Ks, [=](int i) -> const float* {
      return k0 + i < Tk ? kb + (k0 + i) * skt : nullptr;
    });
    repro::stage_rows<float, D, BN, LD, THREADS>(Vs, [=](int i) -> const float* {
      return k0 + i < Tk ? vb + (k0 + i) * svt : nullptr;
    });
  }

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

// -- launch -----------------------------------------------------------------

template <typename F>
cudaError_t allow_smem(F* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int D>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  const cudaError_t e = allow_smem(bwd_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tq + kBQ - 1) / kBQ, p.H, p.B);
  bwd_dq_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t stream) {
  constexpr bool bf16 = sizeof(T) == 2;
  constexpr int smem = bf16 ? DkvBf16<D>::smem : DkvF32<D>::smem;
  constexpr int BN = bf16 ? DkvBf16<D>::BN : DkvF32<D>::BN;
  constexpr int threads = bf16 ? kDkvBf16Warps * 32 : kDkvF32Threads;
  auto* kernel = bf16 ? bwd_dkv_bf16<D> : bwd_dkv_f32<D>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tk + BN - 1) / BN, p.KV, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(bool dkv, int D, const BwdParams& p, cudaStream_t s) {
  switch (D) {
    case 32: return dkv ? launch_dkv<T, 32>(p, s) : launch_dq<T, 32>(p, s);
    case 64: return dkv ? launch_dkv<T, 64>(p, s) : launch_dq<T, 64>(p, s);
    case 128: return dkv ? launch_dkv<T, 128>(p, s) : launch_dq<T, 128>(p, s);
    case 256: return dkv ? launch_dkv<T, 256>(p, s) : launch_dq<T, 256>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dkv, int D, int is_bf16, const BwdParams& p, void* stream) {
  if (p.B == 0 || p.H == 0 || p.Tq == 0 || p.Tk == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? dispatch_d<__nv_bfloat16>(dkv, D, p, s)
                                : dispatch_d<float>(dkv, D, p, s);
  return static_cast<int>(e);
}

}  // namespace

// o, dO: (B, H, Tq, D) in q's dtype, addressed through (batch, head, time)
// strides in elements, last dim contiguous; delta: (B, H, Tq) fp32,
// contiguous.
extern "C" int flash_bwd_preprocess(const void* o, const void* dout, void* delta,
                                    int B, int H, int Tq, int D,
                                    int sob, int soh, int sot, int sdb, int sdh, int sdt,
                                    int is_bf16, void* stream) {
  const int rows = B * H * Tq;
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (rows + kPreWarps - 1) / kPreWarps;
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(delta);
  if (is_bf16) {
    bwd_preprocess_kernel<__nv_bfloat16><<<blocks, kPreWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), out,
        H, Tq, D, rows, sob, soh, sot, sdb, sdh, sdt);
  } else {
    bwd_preprocess_kernel<float><<<blocks, kPreWarps * 32, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), out,
        H, Tq, D, rows, sob, soh, sot, sdb, sdh, sdt);
  }
  return static_cast<int>(cudaGetLastError());
}

// q, dO, dq: (B, H, Tq, D); k, v: (B, KV, Tk, D); lse, delta: (B, H, Tq)
// fp32, contiguous. Strided as flash_fwd; D in {32, 64, 128, 256}.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            int B, int H, int KV, int Tq, int Tk, int D,
                            int sqb, int sqh, int sqt, int skb, int skh, int skt,
                            int svb, int svh, int svt, int sdob, int sdoh, int sdot,
                            int sgqb, int sgqh, int sgqt,
                            float scale, int causal, int window, float cap, int kv_len,
                            int is_bf16, void* stream) {
  const BwdParams p{q, k, v, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(delta), dq, nullptr, nullptr,
                    B, H, KV, Tq, Tk,
                    sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sdob, sdoh, sdot,
                    sgqb, sgqh, sgqt, 0, 0, 0, 0, 0, 0,
                    scale, causal, window, cap, kv_len};
  return run(false, D, is_bf16, p, stream);
}

// dk, dv: (B, KV, Tk, D) in k's dtype, one gradient per KV head (the sum
// over its G query heads); other arguments as flash_bwd_dq.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             int B, int H, int KV, int Tq, int Tk, int D,
                             int sqb, int sqh, int sqt, int skb, int skh, int skt,
                             int svb, int svh, int svt, int sdob, int sdoh, int sdot,
                             int sgkb, int sgkh, int sgkt, int sgvb, int sgvh, int sgvt,
                             float scale, int causal, int window, float cap, int kv_len,
                             int is_bf16, void* stream) {
  const BwdParams p{q, k, v, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(delta), nullptr, dk, dv,
                    B, H, KV, Tq, Tk,
                    sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sdob, sdoh, sdot,
                    0, 0, 0, sgkb, sgkh, sgkt, sgvb, sgvh, sgvt,
                    scale, causal, window, cap, kv_len};
  return run(true, D, is_bf16, p, stream);
}
