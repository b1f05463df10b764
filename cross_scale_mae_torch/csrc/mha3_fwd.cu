// Attention forward on the raw qkv projection layout, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_mha3_kernel` of
// cross_scale_mae_tpu/ops/attention.py (launched by `_mha3_fwd_pallas`).
// Same function: qkv (N, L, 3D) -> out (N, L, D) with D = H * HD; head h's
// q, k and v are the columns [h*HD, (h+1)*HD) of each D-wide third. For each
// head, out_h = softmax(q_h k_h^T * HD^-0.5) v_h with fp32 logits and softmax,
// the probabilities rounded to the input type before the PV product, and the
// PV sum in fp32 (the op order of the Pallas kernel and of
// mha_v3_reference in cross_scale_mae_torch/ops/attention.py).
//
// What bounds it: the whole (L, L) score matrix of one head is tiny (L is 17
// to 257), so the work is 4*L*L*HD flops for 4*L*HD elements moved: about
// L flops per byte in bf16, far below the H100's ~295 flops per byte. The
// kernel is bound by memory: each qkv element should be read once and each
// output element written once.
//
// Design: one block of 128 threads per (sample, head). The block copies k_h
// and v_h into shared memory with 16-byte loads, into rows padded by 16 bytes
// so that 16-byte reads of eight consecutive rows fall in distinct banks.
// Each warp then takes query rows in turn: its lanes stride over the keys to
// form the fp32 logits, a warp shuffle takes the max and the sum, and each
// lane accumulates the output columns it owns. Nothing of the score matrix
// leaves the SM. The row loop is scalar fp32 FMA work; tensor cores and TMA
// are left to a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
struct Geometry {
  static constexpr int kVec = 16 / sizeof(T);      // elements in 16 bytes
  static constexpr int kChunks = HD / kVec;        // 16-byte chunks per head row
  static constexpr int kPitch = HD + kVec;         // padded shared row, elements
  static constexpr int kCols = (HD + 31) / 32;     // output columns per lane
};

template <typename T, int HD>
size_t smem_bytes(int L) {
  using G = Geometry<T, HD>;
  return 2 * size_t(L) * G::kPitch * sizeof(T)     // k_h, v_h
         + size_t(kWarps) * HD * sizeof(float)     // one query row per warp
         + size_t(kWarps) * L * sizeof(float);     // one score row per warp
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
mha3_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int L, int H, float scale) {
  using G = Geometry<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + size_t(L) * G::kPitch;
  float* qrows = reinterpret_cast<float*>(vs + size_t(L) * G::kPitch);
  float* srows = qrows + kWarps * HD;

  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const int D = H * HD;
  const size_t row = 3 * size_t(D);
  const T* base = qkv + size_t(n) * L * row + size_t(h) * HD;

  for (int idx = threadIdx.x; idx < L * G::kChunks; idx += kThreads) {
    const int j = idx / G::kChunks;
    const int c = idx - j * G::kChunks;
    const T* src = base + j * row + c * G::kVec;
    const uint4 kv = *reinterpret_cast<const uint4*>(src + D);
    const uint4 vv = *reinterpret_cast<const uint4*>(src + 2 * D);
    *reinterpret_cast<uint4*>(ks + j * G::kPitch + c * G::kVec) = kv;
    *reinterpret_cast<uint4*>(vs + j * G::kPitch + c * G::kVec) = vv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* q = qrows + warp * HD;
  float* s = srows + warp * L;
  T* obase = out + size_t(n) * L * D + size_t(h) * HD;

  for (int i = warp; i < L; i += kWarps) {
    const T* qsrc = base + i * row;
    for (int d = lane; d < HD; d += 32) q[d] = to_f(qsrc[d]);
    __syncwarp();

    // Logits: lane-strided over keys, fp32 sums of products of the inputs,
    // scaled after the dot as the Pallas kernel does.
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const T* kr = ks + j * G::kPitch;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * G::kVec);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int t = 0; t < G::kVec; ++t) acc = fmaf(q[c * G::kVec + t], to_f(e[t]), acc);
      }
      acc *= scale;
      s[j] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(s[j] - m);
      s[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    // p = e / sum, rounded to the input type (the Pallas kernel's
    // `.astype(x.dtype)` before the PV product).
    for (int j = lane; j < L; j += 32) s[j] = to_f(from_f<T>(s[j] / sum));
    __syncwarp();

    float acc[G::kCols];
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) acc[c] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float p = s[j];
      const T* vr = vs + j * G::kPitch;
#pragma unroll
      for (int c = 0; c < G::kCols; ++c) {
        const int d = lane + 32 * c;
        if (HD % 32 == 0 || d < HD) acc[c] = fmaf(p, to_f(vr[d]), acc[c]);
      }
    }
    T* orow = obase + size_t(i) * D;
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) {
      const int d = lane + 32 * c;
      if (HD % 32 == 0 || d < HD) orow[d] = from_f<T>(acc[c]);
    }
    __syncwarp();  // q and s are rewritten for the next row
  }
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, void* out, int n, int L, int H, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(L);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mha3_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  mha3_fwd_kernel<T, HD><<<n * H, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), L, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* qkv, void* out, int n, int L, int H, int hd, float scale,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(qkv, out, n, L, H, scale, stream);
    case 32: return launch<T, 32>(qkv, out, n, L, H, scale, stream);
    case 64: return launch<T, 64>(qkv, out, n, L, H, scale, stream);
    case 80: return launch<T, 80>(qkv, out, n, L, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha3_fwd(const void* qkv, void* out, int n, int L, int H, int hd,
                              int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(qkv, out, n, L, H, hd, scale, s);
  if (dtype == 0) return dispatch<float>(qkv, out, n, L, H, hd, scale, s);
  return cudaErrorInvalidValue;
}
