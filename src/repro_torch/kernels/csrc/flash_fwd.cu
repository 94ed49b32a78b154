// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_fwd -> _flash_kernel.
//   o = softmax(mask(softcap(q k^T * scale))) v per (batch, query head),
//   GQA by KV head h / G, plus lse = m + log(l) in fp32 (0 where l == 0).
//
// What bounds it on the card: at the serving shapes (T = 26, head_dim 32)
// a (b, h) pair is ~4 KB of q/k/v/o and ~90 KFLOP, so device memory bounds
// it (~1 us at 3.35 TB/s) and in practice the launch does; at the learner
// shape (T = 4096, window 512) the QK^T and PV products bound it
// (~1 GFLOP in fp32 on the CUDA cores).
//
// Design (simple and right first; no wgmma, TMA or warp specialisation):
// - The TPU grid (B, H, q blocks, kv blocks) ran in order with the KV sweep
//   innermost. Here blocks run in parallel: one 128-thread block per
//   (q tile of 32 rows, h, b), and the KV sweep is a loop inside the block
//   that visits only live tiles: up to the diagonal when causal, from the
//   window's horizon when windowed, up to kv_len. The Pallas forward
//   visits every tile.
// - Each KV tile (32 keys) is staged in shared memory as fp32, K with a
//   padded row (D + 1 floats) so lane j reading key j hits its own bank.
// - Each warp owns 8 query rows. For a row, lane j scores key j, the warp
//   reduces max and sum with shuffles, and the online softmax state
//   (m, l and the row's D/32 output columns per lane) stays in registers.
// - The running max starts at NEG_INF = -2**30 as in the reference, but
//   masked keys get p = 0 exactly instead of exp(NEG_INF - m). A row with
//   no live key therefore ends with l == 0, o = 0 and lse = 0 (the l > 0
//   guard of _flash_kernel) and never divides by zero.
// - mixed (bf16 serving): q, k, v are bf16 and their products are exact in
//   fp32, so the scores equal a bf16 MMA with fp32 accumulation; p is
//   rounded to bf16 before p.V as at kernel.py:84, and l sums unrounded p.
// - The kernel reads q, k, v and writes o through (batch, head, time)
//   strides, so the model's (B, T, H, d) activations need no transpose copy.
#include "common.cuh"

namespace {

constexpr int kBK = 32;            // keys per KV tile: one per lane
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;   // query rows per block
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
};

template <int D>
constexpr int smem_bytes() {
  return (kBQ * D + kBK * (D + 1) + kBK * D) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_kernel(const FlashParams p) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of the warp size");
  constexpr int C = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBQ][D]
  float* Ks = Qs + kBQ * D;          // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);    // [kBK][D]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = h / (p.H / p.KV);  // consecutive query heads share a KV head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* kb = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* vb = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D, t = q0 + r;
    Qs[idx] = t < p.Tq ? repro::to_float(qb[t * p.sqt + c]) : 0.f;
  }

  // live key range [lo, hi) for the whole q tile
  const int q_end = min(q0 + kBQ, p.Tq);
  const int kv_end = min(p.Tk, p.kv_len);
  int hi = kv_end;
  if (p.causal) hi = min(hi, q_end);
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt_lo = lo / kBK;
  const int kt_hi = hi > lo ? (hi + kBK - 1) / kBK : kt_lo;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();  // the previous tile is consumed (and Qs is staged)
    const int k0 = kt * kBK;
    for (int idx = threadIdx.x; idx < kBK * D; idx += blockDim.x) {
      const int r = idx / D, c = idx % D, t = k0 + r;
      const bool in = t < p.Tk;
      Ks[r * (D + 1) + c] = in ? repro::to_float(kb[t * p.skt + c]) : 0.f;
      Vs[idx] = in ? repro::to_float(vb[t * p.svt + c]) : 0.f;
    }
    __syncthreads();

    const int j = k0 + lane;  // this lane's key
    const float* kr = Ks + lane * (D + 1);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i, qpos = q0 + r;
      if (qpos < p.Tq) {  // warp-uniform
        const float* qr = Qs + r * D;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) s = fmaf(qr[e], kr[e], s);
        s *= p.scale;
        if (p.cap > 0.f) s = tanhf(s / p.cap) * p.cap;
        bool live = j < kv_end;
        if (p.causal) live = live && j <= qpos;
        if (p.window > 0) live = live && qpos - j < p.window;
        if (__any_sync(repro::kFullMask, live)) {  // skip a row's dead tile
          const float m_new = fmaxf(m[i], repro::warp_max(live ? s : kNegInf));
          float pj = live ? expf(s - m_new) : 0.f;  // masked keys: exactly 0
          const float alpha = expf(m[i] - m_new);   // 0 on the first live tile
          l[i] = alpha * l[i] + repro::warp_sum(pj);
          if (p.mixed) pj = __bfloat162float(__float2bfloat16(pj));
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
#pragma unroll 8
          for (int jj = 0; jj < kBK; ++jj) {
            const float pb = __shfl_sync(repro::kFullMask, pj, jj);
            const float* vr = Vs + jj * D + lane;
#pragma unroll
            for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pb, vr[32 * c], acc[i][c]);
          }
          m[i] = m_new;
        }
      }
    }
  }

  T* ob = static_cast<T*>(p.o) + b * p.sob + h * p.soh;
  float* lseb = p.lse + (static_cast<long long>(b) * p.H + h) * p.Tq;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qpos = q0 + warp * kRowsPerWarp + i;
    if (qpos < p.Tq) {
      const float safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int c = 0; c < C; ++c)
        ob[qpos * p.sot + lane + 32 * c] = repro::from_float<T>(acc[i][c] / safe);
      if (lane == 0) lseb[qpos] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Tq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const FlashParams& p, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(p, s);
    case 64: return launch<T, 64>(p, s);
    case 128: return launch<T, 128>(p, s);
    case 256: return launch<T, 256>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, Tq, D); k, v: (B, KV, Tk, D); o like q; lse: (B, H, Tq) fp32,
// contiguous. q/k/v/o are addressed through their (batch, head, time)
// strides in elements; the last dim is contiguous. D in {32, 64, 128, 256}.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int H, int KV, int Tq, int Tk, int D,
                         int sqb, int sqh, int sqt, int skb, int skh, int skt,
                         int svb, int svh, int svt, int sob, int soh, int sot,
                         float scale, int causal, int window, float cap, int kv_len,
                         int is_bf16, int mixed, void* stream) {
  if (B == 0 || H == 0 || Tq == 0) return static_cast<int>(cudaGetLastError());
  const FlashParams p{q, k, v, o, static_cast<float*>(lse), B, H, KV, Tq, Tk,
                      sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot,
                      scale, causal, window, cap, kv_len, mixed};
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? dispatch_d<__nv_bfloat16>(D, p, s)
                                : dispatch_d<float>(D, p, s);
  return static_cast<int>(e);
}
