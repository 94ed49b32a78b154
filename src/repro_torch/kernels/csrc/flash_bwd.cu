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
// Design (simple and right first; no wgmma, TMA or warp specialisation):
// - All arithmetic is IEEE fp32 on the CUDA cores, as repro's backward
//   upcasts; inputs in fp32 or bf16 are staged in shared memory as fp32.
// - preprocess: one warp per row; o is read as the forward stored it (in
//   q's dtype), as _bwd_preprocess_kernel reads it.
// - dq: one 128-thread block per (q tile of 32 rows, head, batch). Each
//   warp owns 8 query rows; for a row, lane j recomputes the score of key j
//   of the staged KV tile and the warp broadcasts ds_j with shuffles into
//   the row's D/32 dq columns per lane, accumulated in registers. The loop
//   visits live KV tiles only: up to the diagonal when causal, from the
//   window's horizon when windowed, up to kv_len (the _tile_live skips).
// - dk/dv: one block per (KV tile of 32 keys, KV head, batch). It loops
//   over the G query heads of its group and their live q tiles; each warp
//   owns 8 keys, lane i recomputes the pair (query i, key) and the warp
//   broadcasts p_i and ds_i into the key's dk and dv columns. dk and dv are
//   written per KV head: repro's per-query-head buffers and their group
//   sum (a TPU grid-order constraint, kernel.py:328-332) are gone, and with
//   no atomics the result is deterministic.
// - Masked entries get p = 0 and ds = 0 explicitly rather than through
//   exp(NEG_INF - lse): a row with no live key has lse = 0 from the port's
//   forward, and only the mask zeroes it.
// - q, k, v, dO and the gradients are addressed through (batch, head, time)
//   strides, so the model's (B, T, H, d) layout needs no transpose copy.
#include "common.cuh"

namespace {

constexpr int kBK = 32;                       // keys per KV tile
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;               // dq: query rows per warp
constexpr int kBQ = kWarps * kRowsPerWarp;    // query rows per q tile
constexpr int kKeysPerWarp = kBK / kWarps;    // dk/dv: keys per warp

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

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kBK * D + 2 * kBQ * (D + 1) + 2 * kBQ) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32) bwd_dkv_kernel(const BwdParams p) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of the warp size");
  constexpr int C = D / 32;  // dk/dv columns per lane
  extern __shared__ float smem[];
  float* Ks = smem;                   // [kBK][D]
  float* Vs = Ks + kBK * D;           // [kBK][D]
  float* Qs = Vs + kBK * D;           // [kBQ][D + 1]
  float* dOs = Qs + kBQ * (D + 1);    // [kBQ][D + 1]
  float* Ls = dOs + kBQ * (D + 1);    // [kBQ] lse
  float* Ds = Ls + kBQ;               // [kBQ] delta

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int G = p.H / p.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* kb = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* vb = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;
  for (int idx = threadIdx.x; idx < kBK * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D, t = k0 + r;
    const bool in = t < p.Tk;
    Ks[idx] = in ? repro::to_float(kb[t * p.skt + c]) : 0.f;
    Vs[idx] = in ? repro::to_float(vb[t * p.svt + c]) : 0.f;
  }

  // live query range [q_lo, q_hi) for the whole KV tile
  const int kv_end = min(p.Tk, p.kv_len);
  const int k_last = min(k0 + kBK, kv_end) - 1;   // < k0: no live key here
  const int q_lo = p.causal ? k0 : 0;
  int q_hi = p.Tq;
  if (p.window > 0) q_hi = min(q_hi, k_last + p.window);
  if (k_last < k0) q_hi = q_lo;
  const int qt_lo = q_lo / kBQ;
  const int qt_hi = q_hi > q_lo ? (q_hi + kBQ - 1) / kBQ : qt_lo;

  float dk[kKeysPerWarp][C], dv[kKeysPerWarp][C];
#pragma unroll
  for (int jj = 0; jj < kKeysPerWarp; ++jj)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[jj][c] = dv[jj][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
    const T* dob = static_cast<const T*>(p.dout) + b * p.sdob + h * p.sdoh;
    const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Tq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      __syncthreads();  // the previous q tile is consumed (and Ks, Vs are staged)
      const int q0 = qt * kBQ;
      for (int idx = threadIdx.x; idx < kBQ * D; idx += blockDim.x) {
        const int r = idx / D, c = idx % D, t = q0 + r;
        const bool in = t < p.Tq;
        Qs[r * (D + 1) + c] = in ? repro::to_float(qb[t * p.sqt + c]) : 0.f;
        dOs[r * (D + 1) + c] = in ? repro::to_float(dob[t * p.sdot + c]) : 0.f;
      }
      if (threadIdx.x < kBQ) {
        const int t = q0 + threadIdx.x;
        Ls[threadIdx.x] = t < p.Tq ? p.lse[row0 + t] : 0.f;
        Ds[threadIdx.x] = t < p.Tq ? p.delta[row0 + t] : 0.f;
      }
      __syncthreads();

      const int qpos = q0 + lane;  // this lane's query
      const float* qr = Qs + lane * (D + 1);
      const float* dor = dOs + lane * (D + 1);
      const float lse = Ls[lane], delta = Ds[lane];
#pragma unroll
      for (int jj = 0; jj < kKeysPerWarp; ++jj) {
        const int r = warp * kKeysPerWarp + jj, j = k0 + r;
        const bool live = qpos < p.Tq && pair_live(qpos, j, kv_end, p);
        if (__any_sync(repro::kFullMask, live)) {  // skip a key's dead q tile
          const float* kr = Ks + r * D;
          const float* vr = Vs + r * D;
          float s = 0.f, dp = 0.f;
#pragma unroll 8
          for (int e = 0; e < D; ++e) {
            s = fmaf(qr[e], kr[e], s);
            dp = fmaf(dor[e], vr[e], dp);
          }
          float pj, ds;
          pair_grads(s, dp, lse, delta, live, p, pj, ds);
          float pv[C], pk[C];
#pragma unroll
          for (int c = 0; c < C; ++c) pv[c] = pk[c] = 0.f;
#pragma unroll 8
          for (int ii = 0; ii < kBQ; ++ii) {
            const float pb = __shfl_sync(repro::kFullMask, pj, ii);
            const float db = __shfl_sync(repro::kFullMask, ds, ii);
            const float* doc = dOs + ii * (D + 1) + lane;
            const float* qc = Qs + ii * (D + 1) + lane;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              pv[c] = fmaf(pb, doc[32 * c], pv[c]);
              pk[c] = fmaf(db, qc[32 * c], pk[c]);
            }
          }
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dv[jj][c] += pv[c];
            dk[jj][c] += pk[c] * p.scale;
          }
        }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.sgkb + kvh * p.sgkh;
  T* dvb = static_cast<T*>(p.dv) + b * p.sgvb + kvh * p.sgvh;
#pragma unroll
  for (int jj = 0; jj < kKeysPerWarp; ++jj) {
    const int j = k0 + warp * kKeysPerWarp + jj;
    if (j < p.Tk) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dkb[j * p.sgkt + lane + 32 * c] = repro::from_float<T>(dk[jj][c]);
        dvb[j * p.sgvt + lane + 32 * c] = repro::from_float<T>(dv[jj][c]);
      }
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
  constexpr int smem = dkv_smem_bytes<D>();
  const cudaError_t e = allow_smem(bwd_dkv_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tk + kBK - 1) / kBK, p.KV, p.B);
  bwd_dkv_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(p);
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
