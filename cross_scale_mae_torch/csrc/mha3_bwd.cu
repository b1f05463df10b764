// Attention backward on the raw qkv projection layout, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_mha3_bwd_kernel` of
// cross_scale_mae_tpu/ops/attention.py (launched by `_mha3_bwd_pallas`, the
// backward of the custom VJP `pallas_mha_v3`, which saves only qkv). Same
// function: qkv (N, L, 3D) and dO (N, L, D) -> dqkv (N, L, 3D), D = H * HD,
// head h's q, k, v, dO, dq, dk and dv in the columns [h*HD, (h+1)*HD) of
// their D-wide thirds. For each head, in the Pallas kernel's op order:
//   P   = softmax(q k^T * scale)  fp32 logits (scale after the dot), fp32 P
//   dV  = P_b^T dO                P_b = P rounded to the input type
//   dP  = dO V^T                  fp32
//   row = sum_j dP * P            with the fp32 P
//   dS  = P * (dP - row) * scale  rounded to the input type
//   dQ  = dS K,  dK = dS^T Q      fp32 sums, stored in the input type
// (mha3_bwd_reference in cross_scale_mae_torch/ops/attention.py is the plain
// PyTorch version.)
//
// What bounds it: the Pallas CostEstimate counts 7*N*L*D elements moved
// (qkv and dO read, dqkv written) against 10*N*H*L*L*HD flops. At the
// training shapes (L = 17 and 65) that is far below the H100's ~295 flops
// per byte, so the kernel is bound by memory: in bf16 about 0.042 ms at
// (768, 17, 12x64) and 0.107 ms at (768, 65, 16x32) at 3.35 TB/s.
//
// Design: one block of 128 threads per (sample, head), so that dK and dV,
// which are sums over query rows, are reduced inside one block with no
// atomics: the result does not depend on scheduling, and a rerun gives the
// same bits. The score matrix is never stored; P is recomputed, which keeps
// shared memory linear in L (any L whose forward fits takes at most
// 28*L + 16*HD bytes more here):
//   pass A, one warp per query row i (k_h, v_h in shared memory): logits,
//     max, sum, P, dP, row, dS; writes dq_i, and keeps max_i, sum_i, row_i
//     in shared memory;
//   pass B, one warp per key row j (q_h, dO_h now in the same shared
//     memory): recomputes P_ij and dP_ij with the same arithmetic as pass A
//     (bit for bit), forms dS_ij, and writes dk_j and dv_j.
// Each head's inputs are read twice from global memory (once per pass; the
// second read mostly hits L2) and each output element is written once.
// Rows are copied to shared memory with 16-byte loads into rows padded by
// 16 bytes, as in mha3_fwd.cu. The arithmetic is scalar fp32 FMA with IEEE
// expf and division; tensor cores and TMA are left to a later version.

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

// x rounded to the input type and back: the Pallas kernel's `.astype(x.dtype)`.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

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
  static constexpr int kScratch = 2 * HD;          // + 2 * L: per-warp fp32 scratch
};

template <typename T, int HD>
size_t smem_bytes(int L) {
  using G = Geometry<T, HD>;
  return 2 * size_t(L) * G::kPitch * sizeof(T)                 // two (L, HD) tiles
         + 3 * size_t(L) * sizeof(float)                       // max, sum, row per query
         + size_t(kWarps) * (G::kScratch + 2 * L) * sizeof(float);  // per-warp rows
}

// Copy rows [0, L) of the head's columns at `src` (row stride `stride`
// elements) into a padded shared tile.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int L, size_t stride) {
  using G = Geometry<T, HD>;
  for (int idx = threadIdx.x; idx < L * G::kChunks; idx += kThreads) {
    const int j = idx / G::kChunks;
    const int c = idx - j * G::kChunks;
    *reinterpret_cast<uint4*>(dst + j * G::kPitch + c * G::kVec) =
        *reinterpret_cast<const uint4*>(src + j * stride + c * G::kVec);
  }
}

// sum_d a[d] * row[d] in ascending d: a in fp32 (warp scratch), row a padded
// shared row of the input type. Pass A and pass B call this with the same
// operands in the same order, so they compute the same bits.
template <typename T, int HD>
__device__ __forceinline__ float dot_row(const float* a, const T* row) {
  using G = Geometry<T, HD>;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + c * G::kVec);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int t = 0; t < G::kVec; ++t) acc = fmaf(a[c * G::kVec + t], to_f(e[t]), acc);
  }
  return acc;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
mha3_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                T* __restrict__ dqkv, int L, int H, float scale) {
  using G = Geometry<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile0 = reinterpret_cast<T*>(smem);               // k_h, then q_h
  T* tile1 = tile0 + size_t(L) * G::kPitch;            // v_h, then dO_h
  float* row_max = reinterpret_cast<float*>(tile1 + size_t(L) * G::kPitch);
  float* row_sum = row_max + L;
  float* row_dot = row_sum + L;                        // row_i = sum_j dP_ij P_ij
  float* scratch = row_dot + L;

  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const int D = H * HD;
  const size_t stride = 3 * size_t(D);
  const T* qbase = qkv + size_t(n) * L * stride + size_t(h) * HD;
  const T* dobase = dout + size_t(n) * L * D + size_t(h) * HD;
  T* dbase = dqkv + size_t(n) * L * stride + size_t(h) * HD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* a_row = scratch + warp * (G::kScratch + 2 * L);  // q_i / k_j, fp32
  float* b_row = a_row + HD;                              // dO_i / v_j, fp32
  float* p_row = b_row + HD;                              // P (or P_b) along the row
  float* s_row = p_row + L;                               // dP, then dS

  // ---- pass A: query rows. k_h -> tile0, v_h -> tile1.
  load_tile<T, HD>(tile0, qbase + D, L, stride);
  load_tile<T, HD>(tile1, qbase + 2 * D, L, stride);
  __syncthreads();

  for (int i = warp; i < L; i += kWarps) {
    for (int d = lane; d < HD; d += 32) {
      a_row[d] = to_f(qbase[i * stride + d]);
      b_row[d] = to_f(dobase[size_t(i) * D + d]);
    }
    __syncwarp();
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const float s = dot_row<T, HD>(a_row, tile0 + j * G::kPitch) * scale;
      p_row[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(p_row[j] - m);
      p_row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float rdot = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = p_row[j] / sum;
      const float dp = dot_row<T, HD>(b_row, tile1 + j * G::kPitch);
      p_row[j] = p;
      s_row[j] = dp;
      rdot = fmaf(dp, p, rdot);
    }
    rdot = warp_sum(rdot);
    for (int j = lane; j < L; j += 32) {
      s_row[j] = round_to<T>(p_row[j] * (s_row[j] - rdot) * scale);
    }
    __syncwarp();
    // dq_i = sum_j dS_ij k_j, each lane owning columns lane + 32c.
    float acc[G::kCols];
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) acc[c] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float ds = s_row[j];
      const T* kr = tile0 + j * G::kPitch;
#pragma unroll
      for (int c = 0; c < G::kCols; ++c) {
        const int d = lane + 32 * c;
        if (HD % 32 == 0 || d < HD) acc[c] = fmaf(ds, to_f(kr[d]), acc[c]);
      }
    }
    T* dq = dbase + i * stride;
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) {
      const int d = lane + 32 * c;
      if (HD % 32 == 0 || d < HD) dq[d] = from_f<T>(acc[c]);
    }
    if (lane == 0) {
      row_max[i] = m;
      row_sum[i] = sum;
      row_dot[i] = rdot;
    }
    __syncwarp();  // the scratch rows are rewritten for the next row
  }
  __syncthreads();  // every warp is done with k_h, v_h; the row stats are in

  // ---- pass B: key rows. q_h -> tile0, dO_h -> tile1.
  load_tile<T, HD>(tile0, qbase, L, stride);
  load_tile<T, HD>(tile1, dobase, L, size_t(D));
  __syncthreads();

  for (int j = warp; j < L; j += kWarps) {
    for (int d = lane; d < HD; d += 32) {
      a_row[d] = to_f(qbase[j * stride + D + d]);
      b_row[d] = to_f(qbase[j * stride + 2 * D + d]);
    }
    __syncwarp();
    for (int i = lane; i < L; i += 32) {
      // The same operands, order and rounding as pass A's P_ij and dP_ij.
      const float s = dot_row<T, HD>(a_row, tile0 + i * G::kPitch) * scale;
      const float p = expf(s - row_max[i]) / row_sum[i];
      const float dp = dot_row<T, HD>(b_row, tile1 + i * G::kPitch);
      p_row[i] = round_to<T>(p);
      s_row[i] = round_to<T>(p * (dp - row_dot[i]) * scale);
    }
    __syncwarp();
    // dk_j = sum_i dS_ij q_i and dv_j = sum_i P_b,ij dO_i.
    float dk[G::kCols], dv[G::kCols];
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) dk[c] = dv[c] = 0.f;
    for (int i = 0; i < L; ++i) {
      const float ds = s_row[i];
      const float pb = p_row[i];
      const T* qr = tile0 + i * G::kPitch;
      const T* dr = tile1 + i * G::kPitch;
#pragma unroll
      for (int c = 0; c < G::kCols; ++c) {
        const int d = lane + 32 * c;
        if (HD % 32 == 0 || d < HD) {
          dk[c] = fmaf(ds, to_f(qr[d]), dk[c]);
          dv[c] = fmaf(pb, to_f(dr[d]), dv[c]);
        }
      }
    }
    T* drow = dbase + j * stride;
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) {
      const int d = lane + 32 * c;
      if (HD % 32 == 0 || d < HD) {
        drow[D + d] = from_f<T>(dk[c]);
        drow[2 * D + d] = from_f<T>(dv[c]);
      }
    }
    __syncwarp();
  }
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, const void* dout, void* dqkv, int n, int L, int H,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(L);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mha3_bwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  mha3_bwd_kernel<T, HD><<<n * H, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv), L, H,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* qkv, const void* dout, void* dqkv, int n, int L, int H,
                     int hd, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(qkv, dout, dqkv, n, L, H, scale, stream);
    case 32: return launch<T, 32>(qkv, dout, dqkv, n, L, H, scale, stream);
    case 64: return launch<T, 64>(qkv, dout, dqkv, n, L, H, scale, stream);
    case 80: return launch<T, 80>(qkv, dout, dqkv, n, L, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha3_bwd(const void* qkv, const void* dout, void* dqkv, int n, int L,
                              int H, int hd, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(qkv, dout, dqkv, n, L, H, hd, scale, s);
  if (dtype == 0) return dispatch<float>(qkv, dout, dqkv, n, L, H, hd, scale, s);
  return cudaErrorInvalidValue;
}
