// Helpers shared by the port's CUDA kernels: warp reductions, the
// conversions between the storage types (fp32, bf16) and fp32 arithmetic,
// and the sm_80+ primitives the flash-attention kernels build on
// (cp.async, ldmatrix, mma.sync m16n8k16 bf16 -> fp32), as inline PTX.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bfloat16)
}

// The blocks of `kernel`, launched with `threads` threads, that the card
// holds at once: its SMs times the resident blocks per SM.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return sms * per_sm > 1 ? sms * per_sm : 1;
}

// -- 16-byte vectors of fp32 or bf16 held as uint4 ---------------------------

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// 32-bit word i of u (i a compile-time constant after unrolling).
__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

__device__ __forceinline__ void set_word(uint4& u, int i, unsigned v) {
  if (i == 0) u.x = v;
  else if (i == 1) u.y = v;
  else if (i == 2) u.z = v;
  else u.w = v;
}

// Element e of a 16-byte vector of T, as fp32 (bf16: its bits shifted up,
// which is __bfloat162float).
template <typename T>
__device__ __forceinline__ float vec_elem(const uint4& u, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(u, e));
  } else {
    const unsigned w = word(u, e / 2);
    return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
  }
}

// acc + a . b over four lanes, in order x, y, z, w.
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// Lane u of v (u a compile-time constant after unrolling).
__device__ __forceinline__ float lane4(float4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// -- asynchronous copies global -> shared (cp.async) ----------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes; both addresses 16-byte aligned. L2 only (.cg): every tile is
// read once per block.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Every committed group but the newest N has landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS rows of D elements into shared memory (row pitch LD elements) by a
// block of THREADS threads, with 16-byte cp.async; row_ptr(i) is row i's
// address, or null for a row past the end, which is zero-filled.
template <typename T, int D, int ROWS, int LD, int THREADS, typename RowPtr>
__device__ __forceinline__ void stage_rows(T* dst, RowPtr row_ptr) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = D / E;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * E;
    const T* src = row_ptr(r);
    T* d = dst + r * LD + c;
    if (src) {
      cp_async16(d, src + c);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// -- tensor-core fragments (mma.sync.m16n8k16, bf16 in, fp32 accumulate) --------
//
// Lane l = 4 g + c holds, of a 16x16 A tile (row major): a0 = (g, 2c..2c+1),
// a1 = (g + 8, 2c..), a2 = (g, 2c + 8..), a3 = (g + 8, 2c + 8..); of a 16x8
// B tile (k x n): b0 = (2c..2c+1, g), b1 = (2c + 8.., g); of the 16x8 fp32
// accumulator: d0, d1 = (g, 2c..2c+1), d2, d3 = (g + 8, 2c..2c+1).

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b for one 16x16 (A) by 16x8 (B) bf16 product in fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16x2, rounded to nearest even; x in the low half.
__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Two floats as bf16 hi + lo (hi = bf16(x), lo = bf16(x - hi)): two MMAs on
// hi and lo keep x to ~2^-16 relative, where hi alone rounds it at ~2^-9.
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

}  // namespace repro
