// One AdamW update over every leaf the optimizer hands it, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves optax's adamw to XLA, which
// fuses the whole update into one pass under jit. The port ran it as 13
// torch._foreach_* passes (train/optim.py, the path the CPU keeps), which move
// about 128 bytes per fp32 element; this kernel reads each element's p, g, m
// and v once and writes p, m and v once: 28 bytes with fp32 moments, 20 with
// both in bf16. (ops/adamw.py: the host side, and the rule that sends a leaf
// here; the foreach chain is the plain PyTorch version of this arithmetic.)
//
// Per element, in fp32 and in the foreach chain's order (train/optim.py's
// module docstring), with t the update's count, c the clip factor (read on
// the device from a 0-d tensor, so the host never waits), wd the leaf's
// weight decay (0 where it does not decay) and s its layer-decay scale:
//   g <- g c;  m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
//   u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p
//   p <- p + (-lr u) s
// A bf16 moment follows the chain's two rules: with kUpcastFirst (nu_dtype
// set) it is upcast first; otherwise (optax's adamw, mu_dtype alone) b1 m is
// computed and rounded in bf16 with b1 rounded to bf16. The update uses the
// new moments in fp32; they are stored rounded to nearest-even.
//
// What bounds it: a handful of flops per 28 bytes, far below the ~295 flops a
// byte where the H100 stops being bound by memory. So the design only keeps
// the bytes moving: 16-byte loads and stores of four elements where a leaf's
// four pointers allow (a scalar loop where they do not, and for the tail);
// one block of 256 threads per work item, a chunk of one leaf, so tens of
// thousands of blocks fill the 132 SMs whatever the leaves' sizes. A block
// finds its leaf by a binary search of the leaves' first items in the one
// table the launch takes: a record per leaf with its pointers, which change
// every step, and its constants, built by the host each step; the table is
// copied with each launch, and nothing stays on the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// One record per leaf (ops/adamw.py LEAF, built by `launch_table`).
struct Leaf {
  float* p;
  const float* g;
  void* m;
  void* v;
  long long n;       // elements
  long long first;   // the leaf's first work item (block)
  float wd;          // weight decay where the leaf decays, else 0
  float scale;       // layer-decay scale, 1 without
  int vec;           // 1: every pointer allows four-element loads and stores
  int pad;
};
static_assert(sizeof(Leaf) == 64, "ops/adamw.py LEAF");

struct Step {
  float b1, b2, omb1, omb2, b1_stored, bc1, bc2, eps, neg_lr;
  int scaled;      // layer decay: -lr u and s rounded one at a time
};

template <typename T>
struct alignas(4 * sizeof(T)) Pack4 {
  T v[4];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// The intrinsics fix where the foreach chain rounds: each torch op rounds
// its result, and an op with an alpha or value multiplies and adds as one.
template <typename MuT, typename NuT, bool kUpcastFirst>
__device__ __forceinline__ void element(float& p, float g, MuT& m, NuT& v, bool clipped,
                                        float c, float wd, float s, const Step& st) {
  if (clipped) g = __fmul_rn(g, c);
  float m32;
  if constexpr (std::is_same_v<MuT, float>) {
    m32 = __fmaf_rn(st.omb1, g, __fmul_rn(m, st.b1));
  } else if constexpr (kUpcastFirst) {
    m32 = __fadd_rn(__fmul_rn(to_f(m), st.b1), __fmul_rn(g, st.omb1));
  } else {
    const float bm = to_f(__float2bfloat16_rn(__fmul_rn(to_f(m), st.b1_stored)));
    m32 = __fadd_rn(bm, __fmul_rn(g, st.omb1));
  }
  const float gg = __fmul_rn(g, g);
  float v32;
  if constexpr (std::is_same_v<NuT, float>) {
    v32 = __fmaf_rn(st.omb2, gg, __fmul_rn(v, st.b2));
  } else {
    v32 = __fadd_rn(__fmul_rn(to_f(v), st.b2), __fmul_rn(gg, st.omb2));
  }
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v32, st.bc2)), st.eps);
  float u = __fdiv_rn(__fdiv_rn(m32, st.bc1), denom);
  if (wd != 0.f) u = __fmaf_rn(wd, p, u);
  p = st.scaled ? __fadd_rn(p, __fmul_rn(__fmul_rn(u, st.neg_lr), s))
                : __fmaf_rn(st.neg_lr, u, p);
  m = from_f<MuT>(m32);
  v = from_f<NuT>(v32);
}

template <typename MuT, typename NuT, bool kUpcastFirst>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const Leaf* __restrict__ leaves, int n_leaves, const float* __restrict__ clip,
             long long chunk, Step st) {
  // The last leaf whose first item is at most this block (an empty leaf
  // shares its first item with the next one, which then wins).
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (leaves[mid].first <= blockIdx.x) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Leaf q = leaves[lo];
  const long long start = (blockIdx.x - q.first) * chunk;
  const long long len = min(chunk, q.n - start);
  float* __restrict__ p = q.p + start;
  const float* __restrict__ g = q.g + start;
  MuT* __restrict__ m = static_cast<MuT*>(q.m) + start;
  NuT* __restrict__ v = static_cast<NuT*>(q.v) + start;
  const bool clipped = clip != nullptr;
  const float cf = clipped ? *clip : 1.f;
  long long done = 0;
  if (q.vec) {
    const long long n4 = len / 4;
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      Pack4<float> pp = reinterpret_cast<const Pack4<float>*>(p)[i];
      const Pack4<float> gg = reinterpret_cast<const Pack4<float>*>(g)[i];
      Pack4<MuT> mm = reinterpret_cast<const Pack4<MuT>*>(m)[i];
      Pack4<NuT> vv = reinterpret_cast<const Pack4<NuT>*>(v)[i];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        element<MuT, NuT, kUpcastFirst>(pp.v[k], gg.v[k], mm.v[k], vv.v[k], clipped, cf,
                                        q.wd, q.scale, st);
      }
      reinterpret_cast<Pack4<float>*>(p)[i] = pp;
      reinterpret_cast<Pack4<MuT>*>(m)[i] = mm;
      reinterpret_cast<Pack4<NuT>*>(v)[i] = vv;
    }
    done = n4 * 4;
  }
  for (long long i = done + threadIdx.x; i < len; i += kThreads) {
    float pi = p[i];
    MuT mi = m[i];
    NuT vi = v[i];
    element<MuT, NuT, kUpcastFirst>(pi, g[i], mi, vi, clipped, cf, q.wd, q.scale, st);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

template <typename MuT, typename NuT>
cudaError_t launch(bool upcast_first, int blocks, cudaStream_t stream, const Leaf* leaves,
                   int n_leaves, const float* clip, long long chunk, const Step& st) {
  if (upcast_first) {
    adamw_kernel<MuT, NuT, true><<<blocks, kThreads, 0, stream>>>(leaves, n_leaves, clip, chunk,
                                                                   st);
  } else {
    adamw_kernel<MuT, NuT, false><<<blocks, kThreads, 0, stream>>>(leaves, n_leaves, clip,
                                                                    chunk, st);
  }
  return cudaGetLastError();
}

}  // namespace

// leaves: n_leaves Leaf records on the device; blocks: the work items, the
// last leaf's first item plus its chunks; clip: a 0-d fp32 tensor or null;
// chunk: elements a work item covers (a multiple of 4); mu_type and
// nu_type: 0 fp32, 1 bf16. Returns the launch's cudaError_t (0 on success,
// cudaErrorInvalidValue for an unknown type).
extern "C" int csmae_adamw(const void* leaves, int n_leaves, int blocks, const void* clip,
                           long long chunk, float b1, float b2, float omb1, float omb2,
                           float b1_stored, float bc1, float bc2, float eps, float neg_lr,
                           int scaled, int mu_type, int nu_type, int upcast_first,
                           void* stream) {
  if (n_leaves <= 0 || blocks <= 0) return cudaSuccess;
  const Step st{b1, b2, omb1, omb2, b1_stored, bc1, bc2, eps, neg_lr, scaled};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto ls = static_cast<const Leaf*>(leaves);
  const auto cl = static_cast<const float*>(clip);
  const bool up = upcast_first != 0;
  if (mu_type == 0 && nu_type == 0) {
    return launch<float, float>(up, blocks, s, ls, n_leaves, cl, chunk, st);
  }
  if (mu_type == 1 && nu_type == 0) {
    return launch<__nv_bfloat16, float>(up, blocks, s, ls, n_leaves, cl, chunk, st);
  }
  if (mu_type == 0 && nu_type == 1) {
    return launch<float, __nv_bfloat16>(up, blocks, s, ls, n_leaves, cl, chunk, st);
  }
  if (mu_type == 1 && nu_type == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(up, blocks, s, ls, n_leaves, cl, chunk, st);
  }
  return cudaErrorInvalidValue;
}
