// Reverse discounted scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/vtrace_scan/kernel.py,
//   reverse_discounted_scan_p -> _scan_kernel.
//   y_t = delta_t + decay_t * y_{t+1} with y_T = init, per row of (B, T);
//   deltas and decays fp32 or bf16, read as fp32; y fp32.
//
// What bounds it on the card: device memory. Each input element is read
// once and each output written once (B * T * (2 * sizeof(in) + 4) bytes);
// the arithmetic is 2 flops per element. At the learner's shapes, (32, 16)
// for GAE and (1, 4096) for V-trace, the whole call is a few tens of KB and
// the launch sets its time.
//
// Design: the TPU kernel tiled the batch and ran the recurrence over T as
// a fori_loop, one lane per row. At B = 1, T = 4096 that would leave the
// card one serial thread, so the recurrence is parallelised over T:
// - One block per row. Each thread owns a contiguous chunk of T and, right
//   to left, composes the chunk's affine map y_start = a * y_end + b
//   (a = prod decay, b = the chunk's scan seeded at 0).
// - A Hillis-Steele scan of those maps from the right, in shared memory,
//   gives each thread the composition of every chunk to its right; applied
//   to init it is the carry y_end entering the chunk.
// - Each thread then runs its chunk again from that carry and writes y.
// Reassociating the recurrence changes rounding against the sequential
// loop: the port holds the kernel to 1e-5 of max |y| (fp32).
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
reverse_scan_kernel(const T* __restrict__ deltas, const T* __restrict__ decays,
                    const float* __restrict__ init, float* __restrict__ y, int len, int chunk) {
  __shared__ float As[kMaxThreads];
  __shared__ float Bs[kMaxThreads];
  const int n = blockDim.x, tid = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * len;
  const T* dr = deltas + off;
  const T* cr = decays + off;
  float* yr = y + off;
  const int start = min(tid * chunk, len);
  const int end = min(start + chunk, len);

  // this chunk's map from y_end to y_start (identity for an empty chunk)
  float a = 1.f, b = 0.f;
  for (int t = end - 1; t >= start; --t) {
    const float c = repro::to_float(cr[t]);
    b = fmaf(c, b, repro::to_float(dr[t]));
    a *= c;
  }
  As[tid] = a;
  Bs[tid] = b;
  __syncthreads();
  // inclusive scan from the right: S_i = f_i o f_{i+1} o ... o f_{n-1}
  for (int step = 1; step < n; step <<= 1) {
    const bool has = tid + step < n;
    float a2 = 1.f, b2 = 0.f;
    if (has) {
      a2 = As[tid + step];
      b2 = Bs[tid + step];
    }
    __syncthreads();
    if (has) {  // f o g (y) = a (a2 y + b2) + b
      b = fmaf(a, b2, b);
      a *= a2;
      As[tid] = a;
      Bs[tid] = b;
    }
    __syncthreads();
  }
  const float y_init = init[blockIdx.x];
  float carry = tid + 1 < n ? fmaf(As[tid + 1], y_init, Bs[tid + 1]) : y_init;
  for (int t = end - 1; t >= start; --t) {
    carry = fmaf(repro::to_float(cr[t]), carry, repro::to_float(dr[t]));
    yr[t] = carry;
  }
}

template <typename T>
cudaError_t launch(const void* deltas, const void* decays, const float* init, float* y,
                   int B, int len, cudaStream_t stream) {
  int threads = 32;  // a power of two, so the scan's steps cover every thread
  while (threads < kMaxThreads && threads < len) threads <<= 1;
  const int chunk = (len + threads - 1) / threads;
  reverse_scan_kernel<T><<<B, threads, 0, stream>>>(
      static_cast<const T*>(deltas), static_cast<const T*>(decays), init, y, len, chunk);
  return cudaGetLastError();
}

}  // namespace

// deltas, decays: (B, T) contiguous, both fp32 or both bf16; init: (B,)
// fp32; y: (B, T) fp32, contiguous.
extern "C" int reverse_scan(const void* deltas, const void* decays, const void* init, void* y,
                            int B, int T, int is_bf16, void* stream) {
  if (B == 0 || T == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const float*>(init);
  auto* out = static_cast<float*>(y);
  const cudaError_t e = is_bf16 ? launch<__nv_bfloat16>(deltas, decays, i, out, B, T, s)
                                : launch<float>(deltas, decays, i, out, B, T, s);
  return static_cast<int>(e);
}
