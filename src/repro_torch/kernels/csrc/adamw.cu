// AdamW's update and the global gradient norm for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its optimizer to XLA, which
// fuses AdamW's elementwise chain into one pass over each leaf. Run eagerly,
// the port's plain body (`kernels/adamw/ref.py`) is ~15 fp32 ops a leaf, each
// writing a whole temporary; these kernels are the one pass that XLA makes.
//
// What bounds them on the card: device memory. The update reads each
// param's grad, both moments and its base (the fp32 master, or the param)
// and writes both moments, the master and the param: 28 bytes a param for
// bf16 params with fp32 master (2 + 3 * 4 read, 3 * 4 + 2 written) and for
// fp32 params, 22 for bf16 params without master, against 14-17 flops. The
// norm reads each grad once: 2 bytes a bf16 param. So the design streams
// those bytes once and spends nothing else:
// - One launch per leaf, over the whole leaf: no slices, no temporaries.
//   A grid-stride loop over vectors of 8 elements with 64-bit offsets; the
//   grid is what the card holds at once (SMs times resident blocks).
// - 16-byte loads and stores: 8 bf16, or 2 x 4 fp32. The ragged tail (n % 8)
//   goes element by element, and so does a whole leaf whose pointers are
//   not all 16-byte aligned (a view into a larger tensor).
// - Streaming cache hints (ld/st.global.cs): each byte is touched once.
// - The clip scale, lr and bias corrections are read from device memory, so
//   the host never waits for the norm.
// The update's output pointers may equal its inputs (in place): each thread
// reads an element before it writes it, and no other thread touches it.
//
// Arithmetic: the plain body's, op for op, in fp32: the clipped grad rounded
// to the grad's dtype (JAX's clip), m and v, m / bc1 / (sqrt(v / bc2) + eps),
// the weight decay term, base - lr * u, and the cast to the param's dtype.
// Each rounding is spelled (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn) so
// that nvcc cannot contract a product and a sum into an FMA: the kernel
// gives eager PyTorch's bits on the card.
//
// The norm: each block sums the squares of its share of a leaf in fp32 and
// writes the sum to its own slot of a workspace; one single-block kernel
// sums the slots in a fixed order and writes the norm and the clip scale
// min(1, max_norm / (norm + 1e-9)). No atomics, so two calls give the same
// bits. A leaf that is one rank's shard (a DTensor's) has its slots summed
// by the same kernel into one value per set of mesh dims, which the wrapper
// all-reduces before the last sum: a few bytes cross ranks, not the slots.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                 // elements of a thread's step
constexpr int kFinishThreads = 1024;

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[kVec]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  } else {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = repro::vec_elem<T>(u, e);
  }
}

// f rounded to T (nearest even) and stored at p (16-byte aligned).
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&f)[kVec]) {
  if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(f[4], f[5], f[6], f[7]));
  } else {
    uint4 u;
#pragma unroll
    for (int i = 0; i < 4; ++i) repro::set_word(u, i, repro::pack_bf16(f[2 * i], f[2 * i + 1]));
    __stcs(reinterpret_cast<uint4*>(p), u);
  }
}

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;   // omb: one minus b, rounded once from double
};

struct Scalars {
  float scale, lr, bc1, bc2;
};

// One element's step: m and v updated, the new base returned.
template <typename G, bool WD, bool CLIP>
__device__ __forceinline__ float step(float g, float& m, float& v, float base, const Hyper& h,
                                      const Scalars& k) {
  if constexpr (CLIP) {
    g = __fmul_rn(g, k.scale);
    if constexpr (sizeof(G) == 2) g = __bfloat162float(__float2bfloat16_rn(g));
  }
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  float u = __fdiv_rn(__fdiv_rn(m, k.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.bc2)), h.eps));
  if constexpr (WD) u = __fadd_rn(u, __fmul_rn(base, h.wd));
  return __fsub_rn(base, __fmul_rn(k.lr, u));
}

// B is the base's type: the fp32 master with MASTER, else the param's.
template <typename G, typename P, bool MASTER, bool WD, bool CLIP>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const G* g, const float* m, const float* v,
             const std::conditional_t<MASTER, float, P>* base, float* m_out, float* v_out,
             float* master_out, P* p_out, long long n, long long nvec, const float* scale,
             const float* lr, const float* bc1, const float* bc2, Hyper h) {
  const Scalars k{CLIP ? *scale : 1.f, *lr, *bc1, *bc2};
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long i = first; i < nvec; i += stride) {
    const long long o = i * kVec;
    float gf[kVec], mf[kVec], vf[kVec], bf[kVec];
    load8(g + o, gf);
    load8(m + o, mf);
    load8(v + o, vf);
    load8(base + o, bf);
#pragma unroll
    for (int e = 0; e < kVec; ++e) bf[e] = step<G, WD, CLIP>(gf[e], mf[e], vf[e], bf[e], h, k);
    store8(m_out + o, mf);
    store8(v_out + o, vf);
    if constexpr (MASTER) store8(master_out + o, bf);
    store8(p_out + o, bf);
  }
  for (long long i = nvec * kVec + first; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    const float b = step<G, WD, CLIP>(repro::to_float(g[i]), mi, vi, repro::to_float(base[i]),
                                      h, k);
    m_out[i] = mi;
    v_out[i] = vi;
    if constexpr (MASTER) master_out[i] = b;
    p_out[i] = repro::from_float<P>(b);
  }
}

struct UpdateArgs {
  const void *g, *m, *v, *base;
  void *m_out, *v_out, *master_out, *p_out;
  long long n;
  const float *scale, *lr, *bc1, *bc2;
  Hyper h;
};

template <typename G, typename P, bool MASTER, bool WD, bool CLIP>
void launch_update(const UpdateArgs& a, cudaStream_t stream) {
  using B = std::conditional_t<MASTER, float, P>;
  auto kernel = adamw_kernel<G, P, MASTER, WD, CLIP>;
  static const int cap = repro::resident_blocks(kernel, kThreads);
  const bool vec = repro::aligned16(a.g) && repro::aligned16(a.m) && repro::aligned16(a.v) &&
                   repro::aligned16(a.base) && repro::aligned16(a.m_out) &&
                   repro::aligned16(a.v_out) && repro::aligned16(a.p_out) &&
                   (!MASTER || repro::aligned16(a.master_out));
  const long long nvec = vec ? a.n / kVec : 0;
  const long long steps = nvec > a.n - nvec * kVec ? nvec : a.n - nvec * kVec;
  const long long want = (steps + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < cap ? want : cap);
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const G*>(a.g), static_cast<const float*>(a.m), static_cast<const float*>(a.v),
      static_cast<const B*>(a.base), static_cast<float*>(a.m_out), static_cast<float*>(a.v_out),
      static_cast<float*>(a.master_out), static_cast<P*>(a.p_out), a.n, nvec, a.scale, a.lr,
      a.bc1, a.bc2, a.h);
}

// f(std::true_type) or f(std::false_type): a runtime flag as a template one.
template <typename F>
void with_flag(bool flag, F&& f) {
  if (flag)
    f(std::true_type{});
  else
    f(std::false_type{});
}

// Partial sums of squares of g's n elements: block b's into partial[b].
template <typename G>
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const G* g, long long n, long long nvec, float* partial) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float acc = 0.f;
  for (long long i = first; i < nvec; i += stride) {
    float f[kVec];
    load8(g + i * kVec, f);
    // pairwise within the vector: a shorter chain of fp32 roundings
    const float s = ((f[0] * f[0] + f[1] * f[1]) + (f[2] * f[2] + f[3] * f[3])) +
                    ((f[4] * f[4] + f[5] * f[5]) + (f[6] * f[6] + f[7] * f[7]));
    acc += s;
  }
  for (long long i = nvec * kVec + first; i < n; i += stride) {
    const float f = repro::to_float(g[i]);
    acc = fmaf(f, f, acc);
  }
  __shared__ float warps[kThreads / 32];
  acc = repro::warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < kThreads / 32 ? warps[threadIdx.x] : 0.f;
    s = repro::warp_sum(s);
    if (threadIdx.x == 0) partial[blockIdx.x] = s;
  }
}

// out[0] = sqrt(sum of partial[0..slots)), or with root == 0 the sum itself;
// with clip (and root), out[1] = the clip scale.
__global__ void __launch_bounds__(kFinishThreads)
norm_finish_kernel(const float* partial, int slots, float* out, float max_norm, int root,
                   int clip) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < slots; i += kFinishThreads) acc += partial[i];
  __shared__ float warps[kFinishThreads / 32];
  acc = repro::warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    const float total = repro::warp_sum(warps[threadIdx.x]);
    if (threadIdx.x == 0) {
      if (!root) {
        out[0] = total;
        return;
      }
      const float norm = __fsqrt_rn(total);
      out[0] = norm;
      if (clip) {
        // the plain clip's max_norm / (norm + 1e-9): PyTorch's reciprocal
        // times max_norm; clamp(max=1) keeps a NaN
        const float r = __fmul_rn(__frcp_rn(__fadd_rn(norm, static_cast<float>(1e-9))), max_norm);
        out[1] = r > 1.f ? 1.f : r;
      }
    }
  }
}

}  // namespace

// One leaf's AdamW step. g: n fp32 or bf16 grads; m, v: fp32 moments; base:
// the fp32 master (master != 0) or the param (in the param's dtype); the
// outputs m_out, v_out, master_out (master only) and p_out (fp32 or bf16)
// may be the inputs. scale (read with clip only), lr, bc1, bc2: fp32 device
// scalars. Returns cudaGetLastError() after the launch.
extern "C" int adamw_update(const void* g, const void* m, const void* v, const void* base,
                            void* m_out, void* v_out, void* master_out, void* p_out, long long n,
                            const void* scale, const void* lr, const void* bc1, const void* bc2,
                            float b1, float omb1, float b2, float omb2, float eps, float wd,
                            int g_is_bf16, int p_is_bf16, int master, int clip, void* stream) {
  if (n > 0) {
    const UpdateArgs a{g, m, v, base, m_out, v_out, master_out, p_out, n,
                       static_cast<const float*>(scale), static_cast<const float*>(lr),
                       static_cast<const float*>(bc1), static_cast<const float*>(bc2),
                       Hyper{b1, omb1, b2, omb2, eps, wd}};
    auto s = static_cast<cudaStream_t>(stream);
    with_flag(g_is_bf16, [&](auto gb) {
      with_flag(p_is_bf16, [&](auto pb) {
        with_flag(master, [&](auto ms) {
          with_flag(wd != 0.f, [&](auto w) {
            with_flag(clip, [&](auto c) {
              using G = std::conditional_t<decltype(gb)::value, __nv_bfloat16, float>;
              using P = std::conditional_t<decltype(pb)::value, __nv_bfloat16, float>;
              launch_update<G, P, decltype(ms)::value, decltype(w)::value, decltype(c)::value>(
                  a, s);
            });
          });
        });
      });
    });
  }
  return static_cast<int>(cudaGetLastError());
}

// The sum of squares of g's n elements (fp32 or bf16) in `blocks` partial
// sums, written to partial[0..blocks).
extern "C" int global_norm_sumsq(const void* g, long long n, int g_is_bf16, void* partial,
                                 int blocks, void* stream) {
  if (n > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    const bool vec = repro::aligned16(g);
    const long long nvec = vec ? n / kVec : 0;
    float* out = static_cast<float*>(partial);
    if (g_is_bf16)
      sumsq_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(g), n, nvec, out);
    else
      sumsq_kernel<float><<<blocks, kThreads, 0, s>>>(static_cast<const float*>(g), n, nvec, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0] = sqrt of the sum of partial[0..slots) (fp32, in a fixed order);
// with clip, out[1] = min(1, max_norm / (out[0] + 1e-9)). With root == 0,
// out[0] = the sum alone: a shard's share, summed across ranks before the
// root finish reads it.
extern "C" int global_norm_finish(const void* partial, int slots, void* out, float max_norm,
                                  int root, int clip, void* stream) {
  norm_finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), slots, static_cast<float*>(out), max_norm, root, clip);
  return static_cast<int>(cudaGetLastError());
}
