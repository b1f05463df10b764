// The tensor-core bodies of the bf16 attention kernels, for Hopper
// (sm_90a): the forward of K1 (mha3_fwd.cu), K2 (mha_fwd.cu) and K3
// (mha2_fwd.cu), and the backward of K1 (mha3_bwd.cu), K2 (mha_bwd.cu) and
// K3 (mha2_bwd.cu). fp32 inputs keep the scalar bodies of mha_common.cuh
// (attend_fwd, attend_bwd).
//
// Replaces, for bf16, the Pallas kernels `_mha3_kernel`, `_mha3_bwd_kernel`,
// `_mha_kernel`, `_mha_bwd_kernel`, `_mha2_kernel` and `_mha2_bwd_kernel` of
// cross_scale_mae_tpu/ops/attention.py: the logits fp32 sums scaled after
// the dot, an fp32 softmax; K2 and K3 keep P (and in the backward dS) in
// fp32, K1 rounds P to bf16 before P V (and in the backward before dV, and
// dS before dQ and dK).
//
// What bounds them: one head's whole (L, L) score matrix is small (L is 17
// to 257), so the work is about L flops per byte moved, under the H100's
// ~295 flops per byte in bf16: bound by memory. The scalar bodies did not
// get near that bound, because each fp32 FMA read an operand from shared
// memory; here the products run on the tensor cores.
//
// Numerics on the tensor cores. mma.sync m16n8k16 takes bf16 operands and
// sums in fp32. A product of two bf16 numbers is exact in fp32, so the
// logits (q k^T) and dP (dO v^T) are the Pallas kernels' fp32 sums of the
// same operands, in another order (and with the tensor cores' own
// truncating adds). P and dS are fp32 matrices, which a bf16 operand would
// round; each is split into kTerms bf16 terms, x_hi = bf16(x), x_mid =
// bf16(x - x_hi), x_lo = bf16(x - x_hi - x_mid), and its product taken
// term by term. Three terms of 8 bits carry all 24 of an fp32 value (K2,
// kSplitTerms); one term is bf16(x) itself, K1's `.astype(bf16)` of P and
// dS (kK1SplitTerms). In an fp32 emulation of the split
// (tests/test_torch_port_attention.py) two terms moved the mean error of
// K2's rounded outputs to as much as 2**-17 of their mean, where three left
// them equal to the plain version's. K1f takes its logits on the CUDA
// cores in the plain version's fp32 order (`products` with kFfma) and adds
// each 16-key slice of P V with round-to-nearest (`accumulate_split` with
// kRn): mha3_fwd.cu says why.
//
// Forward design. One block per (sample, head), one warp per 16-row query
// tile (5 warps at L = 65, 2 at L = 17; at most kTcMaxWarps, each taking
// tiles in turn). The block copies the head's q, k and v to shared memory
// once, by 16-byte cp.async copies (rows in_stride apart in global memory:
// HD for K2's folded heads, 3D for K1's qkv projection), rows padded by 16
// bytes so that ldmatrix's eight row reads fall in distinct banks, rows L
// to the next multiple of 16 zero-filled; keys beyond L are masked to -inf
// in the logits. q and k reach the logits' products by ldmatrix, v the P V
// product by ldmatrix transposed; the warp turns its fp32 logits (the C
// layout) into P V's A operand in registers, so P never leaves them. The
// logits of up to kKT key tiles are held at a time: when all keys fit (L
// <= 80, kSingle) one sweep keeps them, else a first sweep takes the row
// max and sum (online, fp32) and a second recomputes the logits; then P =
// e / sum, split, and O += P v. Shared memory is three (L, HD + 8) bf16
// tiles: linear in L, 141 KB at L = 257, HD = 80. With kSingle the kernel
// is held to 128 registers, for 3 blocks of 5 warps on an SM at L = 65.
//
// Backward design (attend_bwd_tc). One block per (sample, head), so that
// dK and dV, sums over query rows, are reduced inside one block with no
// atomics: a second launch gives the same bits. q, k, v and dO go to four
// padded shared tiles once (rows in_stride and do_stride apart in global
// memory, as in the forward). Pass A, a warp per 16 query rows: the
// forward's row stats (and P, with kSingle), row = sum_j dP P with dP = dO
// v^T one key tile at a time, then dS = P (dP - row) scale and dQ += dS K,
// dS split in three terms (K2) or rounded once (K1); the row max, sum and
// `row` go to shared memory. Pass B, a warp per 16 key rows, one query tile
// at a time: S^T = k q^T and dP^T = v dO^T, P^T from pass A's stats with
// the same arithmetic, dS^T, then dV += P^T dO and dK += dS^T Q, P and dS
// split or rounded as in pass A, each 16-row slice's product added with
// round-to-nearest (K1b's and K3b's one-sweep kernels at HD >= 64: dV
// and dK in a loop each, kOneAcc). Only the accumulators of a pass and
// one tile of P and dP live in registers.
// Shared memory: four (L, HD + 8) bf16 tiles and three fp32 rows, 190 KB
// at L = 257, HD = 80. The output type is a parameter: bf16 for the
// training path, fp32 for the accuracy checks of chip_smoke.py, which hold
// the unrounded sums against an fp64 computation; the bf16 outputs are
// those fp32 values rounded once.

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
// bf16 terms of each fp32 P (and dS) value in K2's products.
constexpr int kSplitTerms = 3;
// K1's forward: P rounded once to bf16, the Pallas kernel's own rounding.
constexpr int kK1SplitTerms = 1;
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

// Dynamic shared memory of one forward block: the q, k and v tiles.
template <int HD>
size_t tc_fwd_smem_bytes(int L) {
  return 3 * size_t(padded_rows(L)) * TcGeometry<HD>::kPitch * sizeof(bf16);
}

// Of one backward block: the q, k, v and dO tiles, and the row max, sum
// and sum_j dP P of every query row.
template <int HD>
size_t tc_bwd_smem_bytes(int L) {
  return 4 * size_t(padded_rows(L)) * TcGeometry<HD>::kPitch * sizeof(bf16)
         + 3 * size_t(padded_rows(L)) * sizeof(float);
}

// Whether every key of a row fits one sweep: the kernel's kSingle.
__host__ __device__ inline bool one_sweep(int L) { return (padded_rows(L) >> 4) <= kKT; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Rows [0, L) of a head at `src` (rows `stride` elements apart) into a
// padded shared tile by cp.async; rows [L, padded_rows(L)) zero-filled.
// The caller waits.
template <int HD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int L,
                                                size_t stride) {
  using G = TcGeometry<HD>;
  const int rows = padded_rows(L);
  for (int idx = threadIdx.x; idx < rows * G::kChunks; idx += blockDim.x) {
    const int r = idx / G::kChunks;
    const int c = idx - r * G::kChunks;
    bf16* d = dst + r * G::kPitch + c * 8;
    if (r < L) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(d)),
                   "l"(src + size_t(r) * stride + c * 8));
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

// d = A B, from a zero accumulator.
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// acc += d, on the CUDA cores with round-to-nearest.
__device__ __forceinline__ void add_rn(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
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

// The column index of acc[kt][h][e] within its sweep (see `products`).
__device__ __forceinline__ int col_of(int t0, int kt, int h, int e, int lane) {
  return (t0 + kt) * 16 + 8 * h + 2 * (lane & 3) + (e & 1);
}

// Eight bf16 values of a shared row (16 bytes) as fp32.
__device__ __forceinline__ void load8(float (&x)[8], const bf16* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// acc = A B^T for the rows r0..r0+15 of the shared tile `rows` against KT
// tiles of 16 rows of the shared tile `tile` from tile t0, over the head
// width; tiles at or beyond `ntiles` are left 0. The C layout:
// acc[kt][h][e] is row r0 + lane/4 + 8 (e/2), column
// (t0 + kt) 16 + 8 h + 2 (lane % 4) + e % 2. On the tensor cores; or, with
// kFfma, on the CUDA cores in the plain version's fp32 order, each element
// one fmaf chain over the head width from 0 up (the scalar body's
// `dot_row`, whose logits equal mha_v3_reference's on the card).
template <int HD, int KT, bool kFfma = false>
__device__ __forceinline__ void products(float (&acc)[KT][2][4], const bf16* rows, int r0,
                                         const bf16* tile, int t0, int ntiles, int L, int lane) {
  using G = TcGeometry<HD>;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[kt][h][e] = 0.f;
  if constexpr (kFfma) {
    // Rows and columns past L are skipped where a whole half tile lies
    // there (a choice the same for every lane): their logits are masked or
    // never stored.
    const bf16* ra = rows + (r0 + (lane >> 2)) * G::kPitch;
    const bool second_half = r0 + 8 < L;  // rows r0 + 8.. hold queries
#pragma unroll 1
    for (int c = 0; c < G::kChunks; ++c) {
      float qa[8], qb[8];
      load8(qa, ra + c * 8);
      load8(qb, ra + 8 * G::kPitch + c * 8);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if ((t0 + kt) * 16 + 8 * h < L) {
            const bf16* kr = tile + col_of(t0, kt, h, 0, lane) * G::kPitch + c * 8;
            float ka[8], kb[8];
            load8(ka, kr);
            load8(kb, kr + G::kPitch);
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              acc[kt][h][0] = fmaf(qa[t], ka[t], acc[kt][h][0]);
              acc[kt][h][1] = fmaf(qa[t], kb[t], acc[kt][h][1]);
            }
            if (second_half) {
#pragma unroll
              for (int t = 0; t < 8; ++t) {
                acc[kt][h][2] = fmaf(qb[t], ka[t], acc[kt][h][2]);
                acc[kt][h][3] = fmaf(qb[t], kb[t], acc[kt][h][3]);
              }
            }
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int kc = 0; kc < G::kKc; ++kc) {
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
}

// Logits: scaled after the dot, by a product never fused into a later add;
// columns at or beyond L masked to -inf.
template <int KT>
__device__ __forceinline__ void scale_mask(float (&s)[KT][2][4], int t0, int L, float scale,
                                           int lane) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[kt][h][e] =
            col_of(t0, kt, h, e, lane) < L ? __fmul_rn(s[kt][h][e], scale) : -INFINITY;
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

// The kTerms bf16 terms of the pair (x, y), packed as one A-operand
// register each.
template <int kTerms>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t (&out)[kTerms][4],
                                           int slot) {
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    out[t][slot] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    x -= f.x;  // exact: x minus its own bf16 rounding
    y -= f.y;
  }
}

// acc += X B for the fp32 X of one sweep (the C layout of `products`:
// rows r0.., columns the k index) against the shared tile's rows t0 16..
// (the k index) over the head width, X split into kTerms bf16 terms. With
// kRn each 16-row slice's product, its terms from the smallest and from a
// zero accumulator, is added to acc on the CUDA cores with
// round-to-nearest; else the tensor cores add every term into acc
// themselves, truncating.
template <int HD, int KT, int kTerms, bool kRn>
__device__ __forceinline__ void accumulate_split(float (&acc)[TcGeometry<HD>::kN][4],
                                                 const float (&x)[KT][2][4], const bf16* tile,
                                                 int t0, int ntiles, int lane) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (t0 + kt < ntiles) {
      uint32_t a[kTerms][4];
      split_pair<kTerms>(x[kt][0][0], x[kt][0][1], a, 0);
      split_pair<kTerms>(x[kt][0][2], x[kt][0][3], a, 1);
      split_pair<kTerms>(x[kt][1][0], x[kt][1][1], a, 2);
      split_pair<kTerms>(x[kt][1][2], x[kt][1][3], a, 3);
#pragma unroll
      for (int np = 0; np < TcGeometry<HD>::kN / 2; ++np) {
        uint32_t b[4];
        ldsm_b_rows_k<HD>(b, tile, (t0 + kt) * 16, np * 16, lane);
        if constexpr (kRn) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float d[4];
            mma_bf16_zero(d, a[kTerms - 1], b[2 * half], b[2 * half + 1]);
#pragma unroll
            for (int t = kTerms - 2; t >= 0; --t) mma_bf16(d, a[t], b[2 * half], b[2 * half + 1]);
            add_rn(acc[2 * np + half], d);
          }
        } else {
#pragma unroll
          for (int t = 0; t < kTerms; ++t) {
            mma_bf16(acc[2 * np], a[t], b[0], b[1]);
            mma_bf16(acc[2 * np + 1], a[t], b[2], b[3]);
          }
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

__device__ __forceinline__ void store_pair(bf16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store_pair(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

// Rows r0..r0+15 of an (L, HD) output (rows `stride` elements apart) from
// an accumulator, rounded once to the output type; rows at or beyond L
// are not written.
template <int HD, typename TO>
__device__ __forceinline__ void store_rows(TO* dst, const float (&acc)[TcGeometry<HD>::kN][4],
                                           int L, int r0, int lane, size_t stride) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + (lane >> 2) + 8 * half;
    if (r < L) {
#pragma unroll
      for (int n = 0; n < TcGeometry<HD>::kN; ++n)
        store_pair(dst + size_t(r) * stride + n * 8 + 2 * (lane & 3), acc[n][2 * half],
                   acc[n][2 * half + 1]);
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
template <int HD, bool kSingle, bool kFfma = false>
__device__ __forceinline__ void query_stats(float (&s)[kKT][2][4], float (&m)[2], float (&l)[2],
                                            const bf16* qs, const bf16* ks, int L, int r0,
                                            int ntiles, float scale, int lane) {
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int t0 = 0; t0 < sweep_end<kSingle>(ntiles); t0 += kKT) {
    products<HD, kKT, kFfma>(s, qs, r0, ks, t0, ntiles, L, lane);
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
template <int HD, bool kFfma = false>
__device__ __forceinline__ void probs(float (&s)[kKT][2][4], const float (&m)[2],
                                      const float (&l)[2], const bf16* qs, const bf16* ks, int L,
                                      int r0, int t0, int ntiles, float scale, int lane) {
  products<HD, kKT, kFfma>(s, qs, r0, ks, t0, ntiles, L, lane);
  scale_mask<kKT>(s, t0, L, scale, lane);
#pragma unroll
  for (int kt = 0; kt < kKT; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[kt][h][e] = expf(s[kt][h][e] - m[e >> 1]) / l[e >> 1];
}

// One (sample, head) of the forward: q, k, v (L, HD) rows `in_stride`
// apart, out rows `out_stride` apart. kK1: K1's numerics, the logits in the
// plain fp32 order, P rounded once to bf16 and each 16-key slice of P V
// added with round-to-nearest; else K2's, P split into kSplitTerms terms
// and every product summed by the tensor cores.
template <int HD, bool kSingle, bool kK1>
__device__ __forceinline__ void attend_fwd_tc(const bf16* __restrict__ q,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v, size_t in_stride,
                                              bf16* __restrict__ out, size_t out_stride, int L,
                                              float scale) {
  using G = TcGeometry<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = padded_rows(L);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + rows * G::kPitch;
  bf16* vs = ks + rows * G::kPitch;
  load_tile_async<HD>(qs, q, L, in_stride);
  load_tile_async<HD>(ks, k, L, in_stride);
  load_tile_async<HD>(vs, v, L, in_stride);
  wait_tiles();

  const int lane = threadIdx.x & 31;
  const int ntiles = rows >> 4;
  for (int qt = threadIdx.x >> 5; qt < ntiles; qt += blockDim.x >> 5) {
    const int r0 = qt * 16;
    float s[kKT][2][4], m[2], l[2];
    query_stats<HD, kSingle, kK1>(s, m, l, qs, ks, L, r0, ntiles, scale, lane);
    float o[G::kN][4];
    zero<HD>(o);
    for (int t0 = 0; t0 < sweep_end<kSingle>(ntiles); t0 += kKT) {
      if (!kSingle) probs<HD, kK1>(s, m, l, qs, ks, L, r0, t0, ntiles, scale, lane);
      accumulate_split<HD, kKT, kK1 ? kK1SplitTerms : kSplitTerms, kK1>(o, s, vs, t0, ntiles,
                                                                      lane);
    }
    store_rows<HD>(out, o, L, r0, lane, out_stride);
  }
}

// Pass B's tile of the backward: P^T of the key rows j0..j0+15 (rows of
// the shared k tile) against query tile t, from pass A's row max and sum
// with pass A's arithmetic, and with kDs dS^T from dP^T = v dO^T and pass
// A's row = sum_j dP P; 0 past L.
template <int HD, bool kDs>
__device__ __forceinline__ void key_tile(float (&p)[1][2][4], float (&ds)[1][2][4],
                                         const bf16* qs, const bf16* ks, const bf16* vs,
                                         const bf16* dos, const float* row_max,
                                         const float* row_sum, const float* row_dot, int j0,
                                         int t, int ntiles, int L, float scale, int lane) {
  products<HD, 1>(p, ks, j0, qs, t, ntiles, L, lane);  // (q k^T)^T
  if (kDs) products<HD, 1>(ds, vs, j0, dos, t, ntiles, L, lane);  // dP^T
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = col_of(t, 0, h, e, lane);
      if (i < L) {
        const float pe = expf(__fmul_rn(p[0][h][e], scale) - row_max[i]) / row_sum[i];
        p[0][h][e] = pe;
        if (kDs) ds[0][h][e] = pe * (ds[0][h][e] - row_dot[i]) * scale;
      } else {
        p[0][h][e] = 0.f;
        if (kDs) ds[0][h][e] = 0.f;
      }
    }
}

// One (sample, head) of the backward: q, k, v (L, HD) rows `in_stride`
// apart (HD for K2's folded heads, 3D for K1's qkv projection), dO rows
// `do_stride` apart (HD or D), dq, dk, dv rows `out_stride` apart (HD or
// 3D). With P = softmax(q k^T scale) (fp32 logits scaled after the dot,
// fp32 softmax), in the Pallas kernels' algebra:
//   dV = P^T dO,  dP = dO V^T,  row = sum_j dP P,  dS = P (dP - row) scale,
//   dQ = dS K,  dK = dS^T Q,
// row and dS taken from the fp32 P. kK1: K1's numerics, P rounded once to
// bf16 as dV's operand and dS once as dQ's and dK's (one split term,
// kK1SplitTerms, the Pallas kernel's `.astype(bf16)`); else K2's, P and dS
// split into kSplitTerms bf16 terms. Either way each 16-row slice of their
// products is added with round-to-nearest (the tensor cores' own truncating
// adds leave a bias that the sum over a step's tokens keeps; PERF.md
// section 6), and each output is rounded once to TO.
//
// Pass B's logits are k q^T, pass A's q k^T: the same bf16 products taken
// in the same k-step order, but the order of the adds inside one mma.sync
// is the hardware's, so the two passes are not guaranteed to agree bit for
// bit. Where a logit differs in its last fp32 bit, pass B's P (and dS) may
// round to another bf16 value than pass A's: dK and dV then use a P one
// bf16 ulp from dQ's. chip_smoke.py's [train_grads_fp64] holds the result
// against float64, which absorbs that.
//
// kOneAcc: pass B takes dV and dK in a loop each, the second recomputing
// P^T with the same arithmetic, so that one accumulator lives at a time:
// the same bits with fewer registers. K1b's and K2b's kernels take the
// default; K3b's set it for their one-sweep kernel at HD >= 64
// (mha2_bwd.cu says why).
template <int HD, bool kSingle, bool kK1, typename TO,
          bool kOneAcc = kK1 && kSingle && HD >= 64>
__device__ __forceinline__ void attend_bwd_tc(const bf16* __restrict__ q,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v, size_t in_stride,
                                              const bf16* __restrict__ dout, size_t do_stride,
                                              TO* __restrict__ dq, TO* __restrict__ dk,
                                              TO* __restrict__ dv, size_t out_stride, int L,
                                              float scale) {
  using G = TcGeometry<HD>;
  constexpr int kTerms = kK1 ? kK1SplitTerms : kSplitTerms;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = padded_rows(L);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + rows * G::kPitch;
  bf16* vs = ks + rows * G::kPitch;
  bf16* dos = vs + rows * G::kPitch;
  float* row_max = reinterpret_cast<float*>(dos + rows * G::kPitch);
  float* row_sum = row_max + rows;
  float* row_dot = row_sum + rows;  // sum_j dP_ij P_ij
  load_tile_async<HD>(qs, q, L, in_stride);
  load_tile_async<HD>(ks, k, L, in_stride);
  load_tile_async<HD>(vs, v, L, in_stride);
  load_tile_async<HD>(dos, dout, L, do_stride);
  wait_tiles();

  const int lane = threadIdx.x & 31;
  const int ntiles = rows >> 4;
  const int warps = blockDim.x >> 5;

  // ---- pass A: a warp per 16 query rows.
  for (int qt = threadIdx.x >> 5; qt < ntiles; qt += warps) {
    const int r0 = qt * 16;
    float s[kKT][2][4], m[2], l[2];
    query_stats<HD, kSingle>(s, m, l, qs, ks, L, r0, ntiles, scale, lane);
    float rd[2] = {0.f, 0.f};
    for (int t0 = 0; t0 < sweep_end<kSingle>(ntiles); t0 += kKT) {
      if (!kSingle) probs<HD>(s, m, l, qs, ks, L, r0, t0, ntiles, scale, lane);
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt) {
        if (t0 + kt < ntiles) {
          float dp[1][2][4];
          products<HD, 1>(dp, dos, r0, vs, t0 + kt, ntiles, L, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) rd[e >> 1] = fmaf(dp[0][h][e], s[kt][h][e], rd[e >> 1]);
        }
      }
    }
    rd[0] = quad_sum(rd[0]);
    rd[1] = quad_sum(rd[1]);
    float acc[G::kN][4];
    zero<HD>(acc);
    for (int t0 = 0; t0 < sweep_end<kSingle>(ntiles); t0 += kKT) {
      if (!kSingle) probs<HD>(s, m, l, qs, ks, L, r0, t0, ntiles, scale, lane);
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt) {
        if (t0 + kt < ntiles) {
          float ds[1][2][4];
          products<HD, 1>(ds, dos, r0, vs, t0 + kt, ntiles, L, lane);  // dP, as above
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ds[0][h][e] = s[kt][h][e] * (ds[0][h][e] - rd[e >> 1]) * scale;
          accumulate_split<HD, 1, kTerms, /*kRn=*/true>(acc, ds, ks, t0 + kt, ntiles, lane);
        }
      }
    }
    store_rows<HD>(dq, acc, L, r0, lane, out_stride);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + (lane >> 2) + 8 * half;
        row_max[r] = m[half];
        row_sum[r] = l[half];
        row_dot[r] = rd[half];
      }
    }
  }
  __syncthreads();  // every query row's stats are in

  // ---- pass B: a warp per 16 key rows, one query tile at a time. K1b's
  // one-sweep kernel is held to 128 registers (mha3_bwd.cu); at HD >= 64
  // its two accumulators do not fit them beside a tile's products (pass B
  // alone then needs more, and spilled under the cap), so there dV and dK
  // take a loop each (kOneAcc): the same bits, no spill at HD = 64, a few
  // percent more time at the encoder's shape (PERF.md section 6).
  for (int jt = threadIdx.x >> 5; jt < ntiles; jt += warps) {
    const int j0 = jt * 16;
    if constexpr (kOneAcc) {
      float acc[G::kN][4];
      zero<HD>(acc);
      for (int t = 0; t < ntiles; ++t) {
        float p[1][2][4], unused[1][2][4];
        key_tile<HD, false>(p, unused, qs, ks, vs, dos, row_max, row_sum, row_dot, j0, t,
                            ntiles, L, scale, lane);
        accumulate_split<HD, 1, kTerms, /*kRn=*/true>(acc, p, dos, t, ntiles, lane);
      }
      store_rows<HD>(dv, acc, L, j0, lane, out_stride);
      zero<HD>(acc);
      for (int t = 0; t < ntiles; ++t) {
        float p[1][2][4], ds[1][2][4];
        key_tile<HD, true>(p, ds, qs, ks, vs, dos, row_max, row_sum, row_dot, j0, t, ntiles,
                           L, scale, lane);
        accumulate_split<HD, 1, kTerms, /*kRn=*/true>(acc, ds, qs, t, ntiles, lane);
      }
      store_rows<HD>(dk, acc, L, j0, lane, out_stride);
    } else {
      float gk[G::kN][4], gv[G::kN][4];
      zero<HD>(gk);
      zero<HD>(gv);
      for (int t = 0; t < ntiles; ++t) {
        float p[1][2][4], ds[1][2][4];
        key_tile<HD, true>(p, ds, qs, ks, vs, dos, row_max, row_sum, row_dot, j0, t, ntiles,
                           L, scale, lane);
        accumulate_split<HD, 1, kTerms, /*kRn=*/true>(gv, p, dos, t, ntiles, lane);
        accumulate_split<HD, 1, kTerms, /*kRn=*/true>(gk, ds, qs, t, ntiles, lane);
      }
      store_rows<HD>(dk, gk, L, j0, lane, out_stride);
      store_rows<HD>(dv, gv, L, j0, lane, out_stride);
    }
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
