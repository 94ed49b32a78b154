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
// for GAE and (1, 4096) for V-trace, the whole call is a few tens of KB, so
// its time is latency: the launch, one round trip to memory, and the steps
// of the scan. The design keeps that chain short.
//
// The TPU kernel tiled the batch and ran the recurrence over T as a
// fori_loop, one lane per row. Here the recurrence is parallelised over T
// as a scan of affine maps y_start = a * y_end + b:
// - Each lane owns a chunk of C consecutive elements of a row, C = 4 fp32
//   or 8 bf16: one 16-byte load of each input (scalar loads at the ragged
//   end of a row and for a row that is not 16-byte aligned) into registers,
//   and composes the chunk's map right to left.
// - The lanes of a row compose their maps from the right with
//   __shfl_down_sync (at most 5 steps, no shared memory, no barrier).
// - A row that spans several warps adds one cross-warp step: each warp's
//   map goes through shared memory behind a single barrier, and every warp
//   scans the W warp maps with shuffles.
// - init is read at kernel start; each lane then runs its chunk again from
//   its carry, out of registers, and stores y with 16-byte stores.
// Rows per block follow the shape: where a row fits in 32 chunks (T <= 128
// fp32, 256 bf16), P lanes (a power of two) hold a row and a 128-thread
// block holds 128 / P rows, so the env step's (32, 16) is one block with no
// empty chunk. A longer row gets a block of 32-1024 threads, one tile of
// blockDim * C elements at a time, right to left, each tile's left edge the
// next one's carry: (1, 4096) fp32 is one block of 1024 threads and one
// tile (a chunk of 4 beat 8 with 512 threads and 16 with 256 on the card).
// Reassociating the recurrence changes rounding against the sequential
// loop: the port holds the kernel to 1e-5 of max |y| (fp32). The order of
// every sum is fixed, so two calls give the same bits.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kPackedThreads = 128;
constexpr int kMaxThreads = 1024;

// The C elements from position t0 of a span of n elements (a row, or the
// rest of a row from a tile's start) as fp32; positions at or past n give
// the identity map (decay 1, delta 0). Vector loads when the row's start is
// 16-byte aligned in all three arrays and the vector is whole.
template <typename T, int C>
__device__ __forceinline__ void load_chunk(const T* __restrict__ dr, const T* __restrict__ cr,
                                           int t0, int n, bool row_vec, float (&dv)[C],
                                           float (&cv)[C]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < C / V; ++j) {
    const int p = t0 + j * V;
    if (row_vec && p + V <= n) {
      const uint4 ud = __ldg(reinterpret_cast<const uint4*>(dr + p));
      const uint4 uc = __ldg(reinterpret_cast<const uint4*>(cr + p));
#pragma unroll
      for (int e = 0; e < V; ++e) {
        dv[j * V + e] = repro::vec_elem<T>(ud, e);
        cv[j * V + e] = repro::vec_elem<T>(uc, e);
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const bool in = p + e < n;
        dv[j * V + e] = in ? repro::to_float(dr[p + e]) : 0.f;
        cv[j * V + e] = in ? repro::to_float(cr[p + e]) : 1.f;
      }
    }
  }
}

// y over the chunk from `carry` (y just right of it), right to left, in
// the sequential loop's order; stored with 16-byte stores where whole, and
// only at positions below n.
template <int C>
__device__ __forceinline__ void apply_chunk(float* __restrict__ yr, int t0, int n, bool row_vec,
                                            float carry, const float (&dv)[C],
                                            const float (&cv)[C]) {
  float out[C];
#pragma unroll
  for (int t = C - 1; t >= 0; --t) {
    carry = fmaf(cv[t], carry, dv[t]);
    out[t] = carry;
  }
#pragma unroll
  for (int j = 0; j < C / 4; ++j) {
    const int p = t0 + 4 * j;
    if (row_vec && p + 4 <= n) {
      reinterpret_cast<float4*>(yr + p)[0] =
          make_float4(out[4 * j], out[4 * j + 1], out[4 * j + 2], out[4 * j + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (p + e < n) yr[p + e] = out[4 * j + e];
    }
  }
}

// The chunk's map: y at its first element as a * (y after it) + b.
template <int C>
__device__ __forceinline__ void compose_chunk(const float (&dv)[C], const float (&cv)[C],
                                              float& a, float& b) {
  a = 1.f;
  b = 0.f;
#pragma unroll
  for (int t = C - 1; t >= 0; --t) {
    b = fmaf(cv[t], b, dv[t]);
    a *= cv[t];
  }
}

// Inclusive scan from the right over segments of P lanes (P a power of two
// dividing 32): lane i ends with f_i o f_{i+1} o ... o f_{last of segment}.
template <int MAX_STEPS = 5>
__device__ __forceinline__ void scan_maps_down(float& a, float& b, int seg, int P) {
#pragma unroll
  for (int s = 0; s < MAX_STEPS; ++s) {
    const int off = 1 << s;
    if (off >= P) break;               // P is uniform: every lane takes the same steps
    const float a2 = __shfl_down_sync(repro::kFullMask, a, off);
    const float b2 = __shfl_down_sync(repro::kFullMask, b, off);
    if (seg + off < P) {               // f o g (y) = a (a2 y + b2) + b
      b = fmaf(a, b2, b);
      a *= a2;
    }
  }
}

__device__ __forceinline__ bool row_aligned(const void* d, const void* c, const void* y) {
  return repro::aligned16(d) && repro::aligned16(c) && repro::aligned16(y);
}

// Short rows: P lanes per row, 128 / P rows per block, P * C >= T.
template <typename T, int C>
__global__ void __launch_bounds__(kPackedThreads)
scan_rows_kernel(const T* __restrict__ deltas, const T* __restrict__ decays,
                 const float* __restrict__ init, float* __restrict__ y, int B, int T_, int P) {
  const int lane = threadIdx.x & 31, seg = lane & (P - 1);
  const int row = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * kPackedThreads + threadIdx.x) / P);
  const bool live = row < B;
  const float y_in = live ? init[row] : 0.f;
  const size_t off = static_cast<size_t>(live ? row : 0) * T_;
  const T* dr = deltas + off;
  const T* cr = decays + off;
  float* yr = y + off;
  const bool row_vec = row_aligned(dr, cr, yr);
  const int t0 = seg * C;
  float dv[C], cv[C];
  load_chunk<T, C>(dr, cr, t0, live ? T_ : 0, row_vec, dv, cv);
  float a, b;
  compose_chunk<C>(dv, cv, a, b);
  scan_maps_down(a, b, seg, P);
  // y at each chunk's first element; a lane's carry is its right neighbour's
  const float y_start = fmaf(a, y_in, b);
  const float right = __shfl_down_sync(repro::kFullMask, y_start, 1);
  if (live && t0 < T_)
    apply_chunk<C>(yr, t0, T_, row_vec, seg + 1 < P ? right : y_in, dv, cv);
}

// Long rows: one block per row, blockDim (a multiple of 32) lanes of C
// elements per tile, tiles from the right.
template <typename T, int C>
__global__ void __launch_bounds__(kMaxThreads)
scan_row_block_kernel(const T* __restrict__ deltas, const T* __restrict__ decays,
                      const float* __restrict__ init, float* __restrict__ y, int T_) {
  __shared__ float As[2][32], Bs[2][32];   // each warp's map, by tile parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  float y_in = init[blockIdx.x];
  const size_t off = static_cast<size_t>(blockIdx.x) * T_;
  const T* dr = deltas + off;
  const T* cr = decays + off;
  float* yr = y + off;
  const bool row_vec = row_aligned(dr, cr, yr);
  const int tile = blockDim.x * C, t0 = threadIdx.x * C;
  const int ntiles = (T_ - 1) / tile + 1;
  for (int k = ntiles - 1; k >= 0; --k) {
    const int par = k & 1;
    const size_t start = static_cast<size_t>(k) * tile;
    const int n = T_ - static_cast<int>(start);   // elements from the tile's start to the row's end
    float dv[C], cv[C];
    load_chunk<T, C>(dr + start, cr + start, t0, n, row_vec, dv, cv);
    float a, b;
    compose_chunk<C>(dv, cv, a, b);
    scan_maps_down(a, b, lane, 32);
    if (lane == 0) {                   // lane 0 holds its whole warp's map
      As[par][warp] = a;
      Bs[par][warp] = b;
    }
    __syncthreads();
    // every warp scans the W warp maps: lane l ends with warps l..W-1
    float wa = lane < W ? As[par][lane] : 1.f;
    float wb = lane < W ? Bs[par][lane] : 0.f;
    scan_maps_down(wa, wb, lane, W);
    const float z = fmaf(wa, y_in, wb);   // y at warp l's first element
    const float after_warp = __shfl_sync(repro::kFullMask, z, min(warp + 1, 31));
    const float warp_carry = warp + 1 < W ? after_warp : y_in;
    const float next_y_in = __shfl_sync(repro::kFullMask, z, 0);
    const float y_start = fmaf(a, warp_carry, b);
    const float right = __shfl_down_sync(repro::kFullMask, y_start, 1);
    if (t0 < n) apply_chunk<C>(yr + start, t0, n, row_vec, lane < 31 ? right : warp_carry, dv, cv);
    y_in = next_y_in;
  }
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T>
cudaError_t launch(const void* deltas, const void* decays, const float* init, float* y, int B,
                   int T_, cudaStream_t stream) {
  const T* d = static_cast<const T*>(deltas);
  const T* c = static_cast<const T*>(decays);
  constexpr int C = 16 / sizeof(T);    // one 16-byte vector of each input per lane
  const int chunks = (T_ - 1) / C + 1;
  if (chunks <= 32) {
    const int P = next_pow2(chunks);
    const int rows_per_block = kPackedThreads / P;
    const int grid = (B + rows_per_block - 1) / rows_per_block;
    scan_rows_kernel<T, C><<<grid, kPackedThreads, 0, stream>>>(d, c, init, y, B, T_, P);
  } else {
    const int threads = std::min(kMaxThreads, next_pow2(chunks));
    scan_row_block_kernel<T, C><<<B, threads, 0, stream>>>(d, c, init, y, T_);
  }
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
