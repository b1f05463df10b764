// The tensor-core body of K2's forward in bfloat16, for Hopper (sm_90a):
// mha_fwd.cu runs it for bf16 inputs and keeps the scalar body of
// mha_common.cuh (attend_fwd) for fp32 inputs. K2's backward (mha_bwd.cu)
// keeps the scalar body for both types: PERF.md section 6 says why.
//
// Replaces, for bf16, the Pallas kernel `_mha_kernel` of
// cross_scale_mae_tpu/ops/attention.py: every operand read as fp32, the
// logits fp32 sums scaled after the dot, an fp32 softmax, P kept in fp32
// and the output rounded once to bf16.
//
// What bounds it: one head's whole (L, L) score matrix is small (L is 17
// to 257), so the work is about L flops per byte moved, under the H100's
// ~295 flops per byte in bf16: bound by memory. The scalar body did not
// get near that bound, because each fp32 FMA read an operand from shared
// memory; here the products run on the tensor cores.
//
// Numerics on the tensor cores. mma.sync m16n8k16 takes bf16 operands and
// sums in fp32. A product of two bf16 numbers is exact in fp32, so the
// logits (q k^T) are the Pallas kernel's fp32 sums of fp32 operands, in
// another order (and with the tensor cores' own truncating adds). P is an
// fp32 matrix, which a bf16 operand would round (K1's order, the control
// chip_smoke.py must catch); it is split into kSplitTerms bf16 terms,
// p_hi = bf16(p), p_mid = bf16(p - p_hi), p_lo = bf16(p - p_hi - p_mid),
// and P V taken term by term into one fp32 accumulator. Three terms of 8
// bits carry all 24 of an fp32 value; two carry 16, and in an fp32
// emulation of the split (tests/test_torch_port_attention.py) two terms
// moved the mean error of the rounded outputs to as much as 2**-17 of
// their mean, where three left them equal to the plain version's.
//
// Design. One block per (sample, head), one warp per 16-row query tile (5
// warps at L = 65, 2 at L = 17; at most kTcMaxWarps, each taking tiles in
// turn). The block copies the head's q, k and v to shared memory once, by
// 16-byte cp.async copies, rows padded by 16 bytes so that ldmatrix's
// eight row reads fall in distinct banks, rows L to the next multiple of 16
// zero-filled; keys beyond L are masked to -inf in the logits. q and k
// reach the logits' products by ldmatrix, v the P V product by ldmatrix
// transposed; the warp turns its fp32 logits (the C layout) into P V's A
// operand in registers, so P never leaves them. The logits of up to kKT
// key tiles are held at a time: when all keys fit (L <= 80, kSingle) one
// sweep keeps them, else a first sweep takes the row max and sum (online,
// fp32) and a second recomputes the logits; then P = e / sum, split, and
// O += P v. Shared memory is three (L, HD + 8) bf16 tiles: linear in L,
// 141 KB at L = 257, HD = 80. With kSingle the kernel is held to 128
// registers, for 3 blocks of 5 warps on an SM at L = 65.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace csmae {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kTcMaxWarps = 8;
constexpr int kTcMaxThreads = 32 * kTcMaxWarps;
// bf16 terms of each fp32 P value in the P V product.
constexpr int kSplitTerms = 3;
// Key tiles of 16 a query tile holds in registers in one sweep: 80 keys,
// so L <= 80 (every ViT at 64 px or 128 px) needs one sweep.
constexpr int kKT = 5;

template <int HD>
struct TcGeometry {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  static constexpr int kPitch = HD + 8;  // shared row, elements: 16 bytes of pad
  static constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  static constexpr int kKc = HD / 16;     // k-steps of 16 along the head width
  static constexpr int kN = HD / 8;       // n-tiles of 8 along the head width
};

__host__ __device__ inline int padded_rows(int L) { return (L + 15) & ~15; }

// Dynamic shared memory of one block: the q, k and v tiles.
template <int HD>
size_t tc_fwd_smem_bytes(int L) {
  return 3 * size_t(padded_rows(L)) * TcGeometry<HD>::kPitch * sizeof(bf16);
}

// Whether every key of a row fits one sweep: the kernel's kSingle.
__host__ __device__ inline bool one_sweep(int L) { return (padded_rows(L) >> 4) <= kKT; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Rows [0, L) of a head at `src` (rows HD apart) into a padded shared tile
// by cp.async; rows [L, padded_rows(L)) zero-filled. The caller waits.
template <int HD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int L) {
  using G = TcGeometry<HD>;
  const int rows = padded_rows(L);
  for (int idx = threadIdx.x; idx < rows * G::kChunks; idx += blockDim.x) {
    const int r = idx / G::kChunks;
    const int c = idx - r * G::kChunks;
    bf16* d = dst + r * G::kPitch + c * 8;
    if (r < L) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(d)),
                   "l"(src + size_t(r) * HD + c * 8));
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Waits for the block's cp.async copies, then for every thread.
__device__ __forceinline__ void wait_tiles() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B operands of two n-tiles from a shared tile whose rows are the n index
// (k^T in the logits): rows n0..n0+15, columns k0..k0+15. b[0], b[1]
// feed n-tile n0, b[2], b[3] n-tile n0 + 8.
template <int HD>
__device__ __forceinline__ void ldsm_b_rows_n(uint32_t (&b)[4], const bf16* tile, int n0, int k0,
                                              int lane) {
  const int row = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int col = k0 + (((lane >> 3) & 1) << 3);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(tile + row * TcGeometry<HD>::kPitch + col)));
}

// B operands of two n-tiles from a shared tile whose rows are the k index
// (v in P V): rows k0..k0+15, columns n0..n0+15, transposed on load.
template <int HD>
__device__ __forceinline__ void ldsm_b_rows_k(uint32_t (&b)[4], const bf16* tile, int k0, int n0,
                                              int lane) {
  const int row = k0 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int col = n0 + ((lane >> 4) << 3);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(tile + row * TcGeometry<HD>::kPitch + col)));
}

// The A operand of rows r0..r0+15, columns k0..k0+15 of a shared tile.
template <int HD>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile, int r0, int k0,
                                       int lane) {
  const int row = r0 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int col = k0 + ((lane >> 4) << 3);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(tile + row * TcGeometry<HD>::kPitch + col)));
}

// acc = A B^T for the rows r0..r0+15 of the shared tile `rows` against KT
// tiles of 16 rows of the shared tile `tile` from tile t0, over the head
// width; tiles at or beyond `ntiles` are left 0. The C layout:
// acc[kt][h][e] is row r0 + lane/4 + 8 (e/2), column
// (t0 + kt) 16 + 8 h + 2 (lane % 4) + e % 2.
template <int HD, int KT>
__device__ __forceinline__ void products(float (&acc)[KT][2][4], const bf16* rows, int r0,
                                         const bf16* tile, int t0, int ntiles, int lane) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[kt][h][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < TcGeometry<HD>::kKc; ++kc) {
    uint32_t a[4];
    ldsm_a<HD>(a, rows, r0, kc * 16, lane);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (t0 + kt < ntiles) {
        uint32_t b[4];
        ldsm_b_rows_n<HD>(b, tile, (t0 + kt) * 16, kc * 16, lane);
        mma_bf16(acc[kt][0], a, b[0], b[1]);
        mma_bf16(acc[kt][1], a, b[2], b[3]);
      }
    }
  }
}

// The column index of acc[kt][h][e] within its sweep (see `products`).
__device__ __forceinline__ int col_of(int t0, int kt, int h, int e, int lane) {
  return (t0 + kt) * 16 + 8 * h + 2 * (lane & 3) + (e & 1);
}

// Logits: scaled after the dot; columns at or beyond L masked to -inf.
template <int KT>
__device__ __forceinline__ void scale_mask(float (&s)[KT][2][4], int t0, int L, float scale,
                                           int lane) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[kt][h][e] = col_of(t0, kt, h, e, lane) < L ? s[kt][h][e] * scale : -INFINITY;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Online row max and sum over one sweep of masked logits: m holds the max
// of the row so far (the same in the four lanes of a quad), l this lane's
// part of sum exp(s - m). With `keep`, s becomes exp(s - m).
template <int KT>
__device__ __forceinline__ void row_stats(float (&s)[KT][2][4], float (&m)[2], float (&l)[2],
                                          bool keep) {
  float cm[2] = {m[0], m[1]};
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[kt][h][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    cm[r] = quad_max(cm[r]);
    l[r] *= expf(m[r] - cm[r]);  // 0 on the first sweep (l = 0, m = -inf)
    m[r] = cm[r];
  }
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[kt][h][e] - m[e >> 1]);
        l[e >> 1] += p;
        if (keep) s[kt][h][e] = p;
      }
}

// The bf16 terms of the pair (x, y), packed as one A-operand register each.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t (&out)[kSplitTerms][4],
                                           int slot) {
#pragma unroll
  for (int t = 0; t < kSplitTerms; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    out[t][slot] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    x -= f.x;  // exact: x minus its own bf16 rounding
    y -= f.y;
  }
}

// acc += X B for the fp32 X of one sweep (the C layout of `products`:
// rows r0.., columns the k index) against the shared tile's rows t0 16..
// (the k index) over the head width, X split into kSplitTerms bf16 terms.
template <int HD, int KT>
__device__ __forceinline__ void accumulate_split(float (&acc)[TcGeometry<HD>::kN][4],
                                                 const float (&x)[KT][2][4], const bf16* tile,
                                                 int t0, int ntiles, int lane) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (t0 + kt < ntiles) {
      uint32_t a[kSplitTerms][4];
      split_pair(x[kt][0][0], x[kt][0][1], a, 0);
      split_pair(x[kt][0][2], x[kt][0][3], a, 1);
      split_pair(x[kt][1][0], x[kt][1][1], a, 2);
      split_pair(x[kt][1][2], x[kt][1][3], a, 3);
#pragma unroll
      for (int np = 0; np < TcGeometry<HD>::kN / 2; ++np) {
        uint32_t b[4];
        ldsm_b_rows_k<HD>(b, tile, (t0 + kt) * 16, np * 16, lane);
#pragma unroll
        for (int t = 0; t < kSplitTerms; ++t) {
          mma_bf16(acc[2 * np], a[t], b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a[t], b[2], b[3]);
        }
      }
    }
  }
}

template <int HD>
__device__ __forceinline__ void zero(float (&acc)[TcGeometry<HD>::kN][4]) {
#pragma unroll
  for (int n = 0; n < TcGeometry<HD>::kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// Rows r0..r0+15 of an (L, HD) output from an accumulator, rounded once to
// bf16; rows at or beyond L are not written.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[TcGeometry<HD>::kN][4],
                                           int L, int r0, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + (lane >> 2) + 8 * half;
    if (r < L) {
#pragma unroll
      for (int n = 0; n < TcGeometry<HD>::kN; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + size_t(r) * HD + n * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
      }
    }
  }
}

// The end of a loop over sweeps of kKT key tiles: with kSingle (every key
// in one sweep, ntiles <= kKT) a constant, so the loop is one pass that
// the compiler lays out straight, with no registers held across it.
template <bool kSingle>
__device__ __forceinline__ int sweep_end(int ntiles) {
  return kSingle ? 1 : ntiles;
}

// Row stats of one query tile (rows r0.. of the shared q tile `qs`, keys
// of `ks`): with kSingle, P = softmax(q k^T scale) in `s`; else only the
// row max m and the total l.
template <int HD, bool kSingle>
__device__ __forceinline__ void query_stats(float (&s)[kKT][2][4], float (&m)[2], float (&l)[2],
                                            const bf16* qs, const bf16* ks, int L, int r0,
                                            int ntiles, float scale, int lane) {
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int t0 = 0; t0 < sweep_end<kSingle>(ntiles); t0 += kKT) {
    products<HD, kKT>(s, qs, r0, ks, t0, ntiles, lane);
    scale_mask<kKT>(s, t0, L, scale, lane);
    row_stats<kKT>(s, m, l, kSingle);
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if (kSingle) {
#pragma unroll
    for (int kt = 0; kt < kKT; ++kt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[kt][h][e] /= l[e >> 1];
  }
}

// P of one sweep from its logits and the row's m and l.
template <int HD>
__device__ __forceinline__ void probs(float (&s)[kKT][2][4], const float (&m)[2],
                                      const float (&l)[2], const bf16* qs, const bf16* ks, int L,
                                      int r0, int t0, int ntiles, float scale, int lane) {
  products<HD, kKT>(s, qs, r0, ks, t0, ntiles, lane);
  scale_mask<kKT>(s, t0, L, scale, lane);
#pragma unroll
  for (int kt = 0; kt < kKT; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[kt][h][e] = expf(s[kt][h][e] - m[e >> 1]) / l[e >> 1];
}

// One (sample, head) of the forward: q, k, v, out (L, HD), rows HD apart.
template <int HD, bool kSingle>
__device__ __forceinline__ void attend_fwd_tc(const bf16* __restrict__ q,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v, bf16* __restrict__ out,
                                              int L, float scale) {
  using G = TcGeometry<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = padded_rows(L);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + rows * G::kPitch;
  bf16* vs = ks + rows * G::kPitch;
  load_tile_async<HD>(qs, q, L);
  load_tile_async<HD>(ks, k, L);
  load_tile_async<HD>(vs, v, L);
  wait_tiles();

  const int lane = threadIdx.x & 31;
  const int ntiles = rows >> 4;
  for (int qt = threadIdx.x >> 5; qt < ntiles; qt += blockDim.x >> 5) {
    const int r0 = qt * 16;
    float s[kKT][2][4], m[2], l[2];
    query_stats<HD, kSingle>(s, m, l, qs, ks, L, r0, ntiles, scale, lane);
    float o[G::kN][4];
    zero<HD>(o);
    for (int t0 = 0; t0 < sweep_end<kSingle>(ntiles); t0 += kKT) {
      if (!kSingle) probs<HD>(s, m, l, qs, ks, L, r0, t0, ntiles, scale, lane);
      accumulate_split<HD, kKT>(o, s, vs, t0, ntiles, lane);
    }
    store_rows<HD>(out, o, L, r0, lane);
  }
}

// Threads of one block: a warp per 16-row tile, at most kTcMaxWarps.
inline int block_threads(int L) {
  const int tiles = padded_rows(L) >> 4;
  return 32 * (tiles < kTcMaxWarps ? tiles : kTcMaxWarps);
}

// Launch `kernel` on `grid` blocks of block_threads(L) with `smem` bytes of
// dynamic shared memory, raising the kernel's limit first when it is above
// 48 KiB.
template <typename... Params, typename... Args>
cudaError_t launch_tc(void (*kernel)(Params...), size_t smem, int grid, int L,
                      cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block_threads(L), smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace csmae
