// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, rmsnorm_p -> _rmsnorm_kernel.
//   y = x * rsqrt(mean(x^2) + eps) * w per row, fp32 inside, y in x's dtype.
//
// What bounds it on the card: device memory. Each element of x is read
// once and each element of y written once (2 * R * d * sizeof(x) bytes);
// the arithmetic is ~4 flops per element, far below the card's ~20
// flops/byte fp32 ridge. At the port's shapes (a few thousand rows of 128
// or 256) the whole call is a few MB, about one round trip to memory, so
// the design takes latency off each row's critical path:
//
// - A row lives in registers and is read from memory once. A group of G
//   lanes (a power of two, at most 32) holds a row of d = G * VPL * VEC
//   elements, VPL 16-byte vectors of VEC elements per lane: 16 lanes at
//   d = 128 bf16 (two rows per warp), 32 at d = 128 fp32 and d = 256 bf16,
//   4 at d = 32 bf16 (the q/k-norm head width). The sum of squares is
//   reduced within the group with __shfl_xor_sync, and y is scaled and
//   stored from the same registers.
// - Each lane loads its slice of w as 16-byte vectors before its first
//   row's reduction, and again only when its rows pass into the next
//   model's (grouped (M, d) weights): the model boundary is tracked, so
//   there is no division per row.
// - Rows overlap: the grid is the card's resident blocks (SMs times the
//   blocks per SM from the occupancy API, queried once per kernel), each
//   lane group strides over rows and issues its next row's loads before it
//   reduces the current row; there is no tail wave.
// Other widths take a two-pass kernel, one warp per row, with 16-byte
// loads where d and the pointers allow and scalar loads otherwise (odd d,
// a misaligned x or w); its second pass re-reads the row from L1.
//
// The order of operations is _rmsnorm_kernel's, (x * rsqrt(ss / d + eps))
// * w in fp32, with ss / d taken as ss * (1 / d), 1 / d rounded once on the
// host: exact for d a power of two, within one ulp of ss / d otherwise.
//
// The grouped InfServer forward normalises M models' activations in one
// launch: w is (M, d) and row r uses weight row r / rows_per_weight.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The 16-byte vector of T holding f[0..VEC), rounded as from_float<T>.
template <typename T, int VEC>
__device__ __forceinline__ uint4 pack(const float (&f)[VEC]) {
  uint4 u;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) repro::set_word(u, i, __float_as_uint(f[i]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) repro::set_word(u, i, repro::pack_bf16(f[2 * i], f[2 * i + 1]));
  }
  return u;
}

// N floats of w from p (16-byte aligned when N is a multiple of 4).
template <int N>
__device__ __forceinline__ void load_w(const float* __restrict__ p, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + j);
      f[4 * j] = v.x, f[4 * j + 1] = v.y, f[4 * j + 2] = v.z, f[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = __ldg(p + j);
  }
}

// Rows of D = G * VPL * VEC elements in registers; G lanes per row, RPW =
// 32 / G rows per warp. Lane `sub` of a group holds vectors sub + G * k,
// k < VPL, so neighbouring lanes read neighbouring 16 bytes.
template <typename T, int G, int VPL>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                    int rows, int rows_per_weight, float inv_d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NV = G * VPL;          // vectors per row
  constexpr int RPW = 32 / G;
  const int lane = threadIdx.x & 31, sub = lane % G;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int stride = gridDim.x * kWarps * RPW;   // rows per pass of the grid
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);

  auto load_row = [&](int row, uint4 (&v)[VPL]) {
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      v[k] = row < rows ? __ldg(xv + static_cast<size_t>(row) * NV + sub + G * k)
                        : make_uint4(0u, 0u, 0u, 0u);
  };

  int row = warp * RPW + lane / G;
  uint4 cur[VPL];
  load_row(row, cur);
  float wv[VPL][VEC];
  int wend = 0;                        // this lane's weights serve rows below wend
  // the loop bound is the warp's first row, so all 32 lanes run every
  // pass and the full-mask shuffles see every lane
  for (int base = warp * RPW; base < rows; base += stride, row += stride) {
    uint4 nxt[VPL];
    load_row(row + stride, nxt);       // in flight while this row reduces
    if (row < rows && row >= wend) {   // the first row, or the next model's
      const int m = row / rows_per_weight;
      wend = (m + 1) * rows_per_weight;
#pragma unroll
      for (int k = 0; k < VPL; ++k)
        load_w<VEC>(w + static_cast<size_t>(m) * (NV * VEC) + (sub + G * k) * VEC, wv[k]);
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = repro::vec_elem<T>(cur[k], e);
        ss = fmaf(f, f, ss);
      }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(repro::kFullMask, ss, off);
    const float r = rsqrtf(ss * inv_d + eps);
    if (row < rows) {
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] = repro::vec_elem<T>(cur[k], e) * r * wv[k][e];
        yv[static_cast<size_t>(row) * NV + sub + G * k] = pack<T, VEC>(o);
      }
    }
#pragma unroll
    for (int k = 0; k < VPL; ++k) cur[k] = nxt[k];
  }
}

// Any d: one warp per row, two passes over it. VEC = 16 / sizeof(T) when d
// is a multiple of it and x, w and y are 16-byte aligned, else 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                    int rows, int d, int rows_per_weight, float inv_d, float eps) {
  const int lane = threadIdx.x & 31;
  const int nv = d / VEC;
  const float* wr = w;
  long long wend = 0;
  for (long long row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += static_cast<long long>(gridDim.x) * kWarps) {
    if (row >= wend) {                 // warp-uniform: the next model's rows
      const long long m = row / rows_per_weight;
      wend = (m + 1) * rows_per_weight;
      wr = w + m * d;
    }
    const T* xr = x + row * d;
    T* yr = y + row * d;
    float ss = 0.f;
    for (int i = lane; i < nv; i += 32) {
      if constexpr (VEC > 1) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(xr) + i);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = repro::vec_elem<T>(u, e);
          ss = fmaf(f, f, ss);
        }
      } else {
        const float f = repro::to_float(xr[i]);
        ss = fmaf(f, f, ss);
      }
    }
    ss = repro::warp_sum(ss);
    const float r = rsqrtf(ss * inv_d + eps);
    for (int i = lane; i < nv; i += 32) {
      float wv[VEC];
      load_w<VEC>(wr + i * VEC, wv);
      if constexpr (VEC > 1) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(xr) + i);
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] = repro::vec_elem<T>(u, e) * r * wv[e];
        reinterpret_cast<uint4*>(yr)[i] = pack<T, VEC>(o);
      } else {
        yr[i] = repro::from_float<T>(repro::to_float(xr[i]) * r * wv[0]);
      }
    }
  }
}

template <typename T, int G, int VPL>
void launch_rows(const T* x, const float* w, T* y, int rows, int rows_per_weight, float inv_d,
                 float eps, cudaStream_t stream) {
  static const int cap = repro::resident_blocks(rmsnorm_rows_kernel<T, G, VPL>, kThreads);
  const int rows_per_block = kWarps * (32 / G);
  const int grid = std::min((rows + rows_per_block - 1) / rows_per_block, cap);
  rmsnorm_rows_kernel<T, G, VPL><<<grid, kThreads, 0, stream>>>(x, w, y, rows, rows_per_weight,
                                                                 inv_d, eps);
}

template <typename T, int VEC>
void launch_warp(const T* x, const float* w, T* y, int rows, int d, int rows_per_weight,
                 float inv_d, float eps, cudaStream_t stream) {
  static const int cap = repro::resident_blocks(rmsnorm_warp_kernel<T, VEC>, kThreads);
  const int grid = std::min((rows + kWarps - 1) / kWarps, cap);
  rmsnorm_warp_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(x, w, y, rows, d, rows_per_weight,
                                                             inv_d, eps);
}

template <typename T>
void launch(const void* xp, const void* wp, void* yp, int rows, int d, int rows_per_weight,
            float eps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xp);
  const float* w = static_cast<const float*>(wp);
  T* y = static_cast<T*>(yp);
  const float inv_d = 1.f / static_cast<float>(d);
  const bool vec = d % VEC == 0 && repro::aligned16(x) && repro::aligned16(y) && repro::aligned16(w);
  if (!vec) return launch_warp<T, 1>(x, w, y, rows, d, rows_per_weight, inv_d, eps, s);
  switch (d / VEC) {                   // 16-byte vectors per row
    case 4: return launch_rows<T, 4, 1>(x, w, y, rows, rows_per_weight, inv_d, eps, s);
    case 8: return launch_rows<T, 8, 1>(x, w, y, rows, rows_per_weight, inv_d, eps, s);
    case 16: return launch_rows<T, 16, 1>(x, w, y, rows, rows_per_weight, inv_d, eps, s);
    case 32: return launch_rows<T, 32, 1>(x, w, y, rows, rows_per_weight, inv_d, eps, s);
    case 64: return launch_rows<T, 32, 2>(x, w, y, rows, rows_per_weight, inv_d, eps, s);
    default: return launch_warp<T, VEC>(x, w, y, rows, d, rows_per_weight, inv_d, eps, s);
  }
}

}  // namespace

// x: (rows, d) fp32 or bf16, contiguous; w: (rows / rows_per_weight, d) fp32;
// y: like x. Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int rows, int d,
                           int rows_per_weight, float eps, int x_is_bf16, void* stream) {
  if (rows > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16)
      launch<__nv_bfloat16>(x, w, y, rows, d, rows_per_weight, eps, s);
    else
      launch<float>(x, w, y, rows, d, rows_per_weight, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
