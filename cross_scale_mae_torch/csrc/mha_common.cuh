// The attention bodies shared by the package's six kernels, for Hopper
// (sm_90a): mha3_fwd.cu and mha3_bwd.cu (K1, the raw qkv projection
// layout), mha_fwd.cu and mha_bwd.cu (K2, head-folded q, k, v) and
// mha2_fwd.cu and mha2_bwd.cu (K3, the (N, L, 3H, hd) layout: K1's bytes with K2's
// numerics). Each kernel is a thin __global__ function that finds its
// (sample, head)'s base pointers and row strides and calls one body below;
// the bodies differ between K1 and K2/K3 only in `kRound`, the two
// roundings to the input type that K1's Pallas kernels make and the others
// do not (P before the PV and dV products, dS before the dQ and dK
// products).
//
// What bounds them: the whole (L, L) score matrix of one head is tiny (L is
// 17 to 257), so the work is about L flops per byte moved in bf16, far below
// the H100's ~295 flops per byte: the kernels are bound by memory, and each
// input element should be read once and each output element written once.
//
// Forward design: one block of 128 threads per (sample, head). The block
// copies k and v into shared memory with 16-byte loads, into rows padded by
// 16 bytes so that 16-byte reads of eight consecutive rows fall in distinct
// banks. Each warp then takes query rows in turn: its lanes stride over the
// keys to form the fp32 logits, warp shuffles take the max and the sum, and
// each lane accumulates the output columns it owns. Nothing of the score
// matrix leaves the SM.
//
// Backward design: one block per (sample, head), so that dK and dV, which
// are sums over query rows, are reduced inside one block with no atomics:
// the result does not depend on scheduling, and a rerun gives the same bits.
// The score matrix is never stored; P is recomputed, which keeps shared
// memory linear in L:
//   pass A, one warp per query row i (k, v in shared memory): logits, max,
//     sum, P, dP, row = sum_j dP_ij P_ij, dS; writes dq_i, and keeps max_i,
//     sum_i, row_i in shared memory;
//   pass B, one warp per key row j (q, dO now in the same shared memory):
//     recomputes P_ij and dP_ij with the same arithmetic as pass A (bit for
//     bit), forms dS_ij, and writes dk_j and dv_j.
// Each head's inputs are read twice from global memory (once per pass; the
// second read mostly hits L2) and each output element is written once.
//
// The arithmetic is scalar fp32 FMA with IEEE expf and division; tensor
// cores and TMA are left to a later version.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace csmae {

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

// x rounded to the input type and back (the Pallas kernels' `.astype(x.dtype)`)
// when kRound, else x unchanged.
template <typename T, bool kRound>
__device__ __forceinline__ float maybe_round(float x) {
  if constexpr (kRound) return to_f(from_f<T>(x));
  return x;
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
  static constexpr int kScratch = 2 * HD;          // + 2 * L: per-warp fp32 scratch
};

// Dynamic shared memory of one forward block: k and v in the input type,
// one fp32 query row and one fp32 score row per warp.
template <typename T, int HD>
size_t fwd_smem_bytes(int L) {
  using G = Geometry<T, HD>;
  return 2 * size_t(L) * G::kPitch * sizeof(T)
         + size_t(kWarps) * HD * sizeof(float)
         + size_t(kWarps) * L * sizeof(float);
}

// Of one backward block: two (L, HD) tiles in the input type; max, sum and
// row per query row; per warp two fp32 head rows and two fp32 rows of L.
template <typename T, int HD>
size_t bwd_smem_bytes(int L) {
  using G = Geometry<T, HD>;
  return 2 * size_t(L) * G::kPitch * sizeof(T)
         + 3 * size_t(L) * sizeof(float)
         + size_t(kWarps) * (G::kScratch + 2 * L) * sizeof(float);
}

// Copy rows [0, L) of a head at `src` (row stride `stride` elements) into a
// padded shared tile.
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
// shared row of the input type. The forward and both backward passes call
// this with the same operands in the same order, so they compute the same
// bits.
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

// One (sample, head) of the forward: q, k, v rows at stride `in_stride`,
// out rows at `out_stride`. out = softmax(q k^T * scale) v with fp32 logits
// (scale after the dot) and softmax, P rounded to the input type when
// kRound, the PV sum in fp32, and the output rounded once.
template <typename T, int HD, bool kRound>
__device__ __forceinline__ void attend_fwd(const T* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v, size_t in_stride,
                                           T* __restrict__ out, size_t out_stride, int L,
                                           float scale) {
  using G = Geometry<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + size_t(L) * G::kPitch;
  float* qrows = reinterpret_cast<float*>(vs + size_t(L) * G::kPitch);
  float* srows = qrows + kWarps * HD;

  load_tile<T, HD>(ks, k, L, in_stride);
  load_tile<T, HD>(vs, v, L, in_stride);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qr = qrows + warp * HD;
  float* s = srows + warp * L;

  for (int i = warp; i < L; i += kWarps) {
    const T* qsrc = q + i * in_stride;
    for (int d = lane; d < HD; d += 32) qr[d] = to_f(qsrc[d]);
    __syncwarp();

    // Logits: lane-strided over keys, scaled after the dot.
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const float acc = dot_row<T, HD>(qr, ks + j * G::kPitch) * scale;
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
    for (int j = lane; j < L; j += 32) s[j] = maybe_round<T, kRound>(s[j] / sum);
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
    T* orow = out + i * out_stride;
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) {
      const int d = lane + 32 * c;
      if (HD % 32 == 0 || d < HD) orow[d] = from_f<T>(acc[c]);
    }
    __syncwarp();  // qr and s are rewritten for the next row
  }
}

// One (sample, head) of the backward: q, k, v rows at `in_stride`, dO rows
// at `do_stride`, dq, dk, dv rows at `out_stride`. With P_r and dS_r the
// values rounded to the input type when kRound (else P and dS themselves):
//   P   = softmax(q k^T * scale)  fp32 logits (scale after the dot), fp32 P
//   dV  = P_r^T dO
//   dP  = dO V^T                  fp32
//   row = sum_j dP * P            with the fp32 P
//   dS  = P * (dP - row) * scale
//   dQ  = dS_r K,  dK = dS_r^T Q  fp32 sums
// and each output rounded once to the input type.
template <typename T, int HD, bool kRound>
__device__ __forceinline__ void attend_bwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    size_t in_stride, const T* __restrict__ dout, size_t do_stride, T* __restrict__ dq,
    T* __restrict__ dk, T* __restrict__ dv, size_t out_stride, int L, float scale) {
  using G = Geometry<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile0 = reinterpret_cast<T*>(smem);               // k, then q
  T* tile1 = tile0 + size_t(L) * G::kPitch;            // v, then dO
  float* row_max = reinterpret_cast<float*>(tile1 + size_t(L) * G::kPitch);
  float* row_sum = row_max + L;
  float* row_dot = row_sum + L;                        // row_i = sum_j dP_ij P_ij
  float* scratch = row_dot + L;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* a_row = scratch + warp * (G::kScratch + 2 * L);  // q_i / k_j, fp32
  float* b_row = a_row + HD;                              // dO_i / v_j, fp32
  float* p_row = b_row + HD;                              // P (or P_r) along the row
  float* s_row = p_row + L;                               // dP, then dS (or dS_r)

  // ---- pass A: query rows. k -> tile0, v -> tile1.
  load_tile<T, HD>(tile0, k, L, in_stride);
  load_tile<T, HD>(tile1, v, L, in_stride);
  __syncthreads();

  for (int i = warp; i < L; i += kWarps) {
    for (int d = lane; d < HD; d += 32) {
      a_row[d] = to_f(q[i * in_stride + d]);
      b_row[d] = to_f(dout[i * do_stride + d]);
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
      s_row[j] = maybe_round<T, kRound>(p_row[j] * (s_row[j] - rdot) * scale);
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
    T* dqr = dq + i * out_stride;
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) {
      const int d = lane + 32 * c;
      if (HD % 32 == 0 || d < HD) dqr[d] = from_f<T>(acc[c]);
    }
    if (lane == 0) {
      row_max[i] = m;
      row_sum[i] = sum;
      row_dot[i] = rdot;
    }
    __syncwarp();  // the scratch rows are rewritten for the next row
  }
  __syncthreads();  // every warp is done with k, v; the row stats are in

  // ---- pass B: key rows. q -> tile0, dO -> tile1.
  load_tile<T, HD>(tile0, q, L, in_stride);
  load_tile<T, HD>(tile1, dout, L, do_stride);
  __syncthreads();

  for (int j = warp; j < L; j += kWarps) {
    for (int d = lane; d < HD; d += 32) {
      a_row[d] = to_f(k[j * in_stride + d]);
      b_row[d] = to_f(v[j * in_stride + d]);
    }
    __syncwarp();
    for (int i = lane; i < L; i += 32) {
      // The same operands, order and rounding as pass A's P_ij and dP_ij.
      const float s = dot_row<T, HD>(a_row, tile0 + i * G::kPitch) * scale;
      const float p = expf(s - row_max[i]) / row_sum[i];
      const float dp = dot_row<T, HD>(b_row, tile1 + i * G::kPitch);
      p_row[i] = maybe_round<T, kRound>(p);
      s_row[i] = maybe_round<T, kRound>(p * (dp - row_dot[i]) * scale);
    }
    __syncwarp();
    // dk_j = sum_i dS_ij q_i and dv_j = sum_i P_ij dO_i.
    float gk[G::kCols], gv[G::kCols];
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) gk[c] = gv[c] = 0.f;
    for (int i = 0; i < L; ++i) {
      const float ds = s_row[i];
      const float p = p_row[i];
      const T* qr = tile0 + i * G::kPitch;
      const T* dr = tile1 + i * G::kPitch;
#pragma unroll
      for (int c = 0; c < G::kCols; ++c) {
        const int d = lane + 32 * c;
        if (HD % 32 == 0 || d < HD) {
          gk[c] = fmaf(ds, to_f(qr[d]), gk[c]);
          gv[c] = fmaf(p, to_f(dr[d]), gv[c]);
        }
      }
    }
    T* dkr = dk + j * out_stride;
    T* dvr = dv + j * out_stride;
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) {
      const int d = lane + 32 * c;
      if (HD % 32 == 0 || d < HD) {
        dkr[d] = from_f<T>(gk[c]);
        dvr[d] = from_f<T>(gv[c]);
      }
    }
    __syncwarp();
  }
}

// Launch `kernel` on `grid` blocks of kThreads with `smem` bytes of dynamic
// shared memory, raising the kernel's limit first when it is above 48 KiB.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), size_t smem, int grid, cudaStream_t stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
struct Type {
  using type = T;
};

// Calls f(Type<T>{}, std::integral_constant<int, HD>{}) for the element type
// (dtype 0 = float32, 1 = bfloat16) and head width the kernels are built
// for; cudaErrorInvalidValue for any other.
template <typename T, typename F>
cudaError_t dispatch_hd(int hd, F&& f) {
  switch (hd) {
    case 16: return f(Type<T>{}, std::integral_constant<int, 16>{});
    case 32: return f(Type<T>{}, std::integral_constant<int, 32>{});
    case 64: return f(Type<T>{}, std::integral_constant<int, 64>{});
    case 80: return f(Type<T>{}, std::integral_constant<int, 80>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t dispatch(int dtype, int hd, F&& f) {
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, f);
  if (dtype == 0) return dispatch_hd<float>(hd, f);
  return cudaErrorInvalidValue;
}

}  // namespace csmae
