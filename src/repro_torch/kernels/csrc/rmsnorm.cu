// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, rmsnorm_p -> _rmsnorm_kernel.
//   y = x * rsqrt(mean(x^2) + eps) * w per row, fp32 inside, y in x's dtype.
//
// What bounds it on the card: device memory. Each element of x is read
// once and each element of y written once (2 * R * d * sizeof(x) bytes);
// the arithmetic is ~4 flops per element, far below the card's ~20
// flops/byte fp32 ridge.
//
// Design: one warp per row, 8 rows per 256-thread block, so a row needs
// no shared memory and no block barrier. Lanes stride over the row with
// 16-byte loads (8 bf16 or 4 fp32 values) when d and the pointers allow,
// else one element at a time (any d). The fp32 sum of squares is reduced
// with shuffles; the second pass re-reads the row, which is at most a few
// KB and still in L1, so HBM sees x once. The order of operations is that
// of _rmsnorm_kernel: (x * rsqrt(sum/d + eps)) * w.
//
// The grouped InfServer forward normalises M models' activations in one
// launch: w is (M, d) and row r uses weight row r / rows_per_weight.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
               int rows, int d, int rows_per_weight, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* yr = y + static_cast<size_t>(row) * d;
  const float* wr = w + static_cast<size_t>(row / rows_per_weight) * d;

  float ss = 0.f;
  if constexpr (VEC > 1) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const int nvec = d / VEC;
    for (int i = lane; i < nvec; i += 32) {
      alignas(16) T a[VEC];
      *reinterpret_cast<uint4*>(a) = __ldg(xv + i);  // one 16-byte load
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = repro::to_float(a[e]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = repro::to_float(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
  ss = repro::warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if constexpr (VEC > 1) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    const int nvec = d / VEC;
    for (int i = lane; i < nvec; i += 32) {
      alignas(16) T a[VEC], o[VEC];
      *reinterpret_cast<uint4*>(a) = __ldg(xv + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[e] = repro::from_float<T>(repro::to_float(a[e]) * r * wr[i * VEC + e]);
      yv[i] = *reinterpret_cast<const uint4*>(o);
    }
  } else {
    for (int i = lane; i < d; i += 32)
      yr[i] = repro::from_float<T>(repro::to_float(xr[i]) * r * wr[i]);
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int rows, int d, int rows_per_weight,
            float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const dim3 grid((rows + kWarps - 1) / kWarps), block(kWarps * 32);
  const bool aligned = d % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const float* wf = static_cast<const float*>(w);
  if (aligned)
    rmsnorm_kernel<T, VEC><<<grid, block, 0, stream>>>(xt, wf, yt, rows, d, rows_per_weight, eps);
  else
    rmsnorm_kernel<T, 1><<<grid, block, 0, stream>>>(xt, wf, yt, rows, d, rows_per_weight, eps);
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
