// Attention backward on the (N, L, 3H, hd) qkv layout, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_mha2_bwd_kernel` of
// cross_scale_mae_tpu/ops/attention.py (launched by `_mha2_cvjp_bwd`, the
// backward of the custom VJP `pallas_mha_qkv`, which saves only qkv). Same
// function: qkv (N, L, 3H, HD) and dO (N, L, H, HD) -> dqkv (N, L, 3H, HD)
// in the qkv layout, K1's bytes (rows 3D long in qkv and dqkv, D long in
// dO, D = H * HD). For each head, with every operand read as fp32:
//   P   = softmax(q k^T * scale)  fp32 logits (scale after the dot)
//   dV  = P^T dO
//   dP  = dO V^T
//   row = sum_j dP * P
//   dS  = P * (dP - row) * scale  not rounded
//   dQ  = dS K,  dK = dS^T Q      fp32 sums, each output rounded once
// K2's numerics on K1's rows (mha_qkv_bwd_reference in
// cross_scale_mae_torch/ops/attention.py is the plain PyTorch version).
//
// Bound by memory: the Pallas CostEstimate counts 7*N*L*H*HD elements moved
// (qkv and dO read, dqkv written) against 10*N*H*L*L*HD flops; in bf16 about
// 0.013 ms at ViT-B's (64, 65, 12x64), 0.107 ms at the decoder's (768, 65,
// 16x32) and 0.011 ms at the longest (8, 257, 16x80), at 3.35 TB/s.
//
// Which body runs. bf16 inputs run the tensor-core body of mha_tc.cuh
// (attend_bwd_tc without kK1, K2b's: the logits and dP as mma.sync
// products, P and dS split into three bf16 terms as the operands of dV and
// of dQ and dK, each 16-row slice added with round-to-nearest; a warp per
// 16 query rows, then per 16 key rows), here on rows 3D apart in qkv and
// dqkv and D apart in dO, as K1b reads them: the scalar body took every
// product as an fp32 FMA with an operand from shared memory, a warp per
// query row, and lost even to its own plain version at L = 257. fp32
// inputs keep the scalar body of mha_common.cuh (128 threads, two passes),
// which takes fp32 operands as they are. Both take one block per (sample,
// head) and no atomics, so a second launch gives the same bits.
//
// Registers. K2's three split terms need more of them than K1b's one: held
// to 128 (two blocks of eight warps, K1b's cap), the one-sweep kernel
// (L <= 80) spilled at HD = 64 even with pass B's dV and dK in a loop each
// (kOneAcc in mha_tc.cuh), and so did K2b's uncapped launch bounds, where
// ptxas chose 128 on its own. So ptxas is told one block an SM is enough
// and takes what it needs (121 to 244 registers), and the one-sweep kernel
// at HD >= 64 takes pass B with one accumulator, which keeps it at 138 and
// 161 registers where it would take 204 and 244 (PERF.md section 6;
// chip_smoke.py [build] prints every count).

#include <type_traits>

#include "mha_common.cuh"
#include "mha_tc.cuh"

namespace {

using namespace csmae;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
mha2_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                T* __restrict__ dqkv, int L, int H, float scale) {
  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const size_t D = size_t(H) * HD;
  const size_t head = size_t(n) * L * 3 * D + size_t(h) * HD;
  const T* q = qkv + head;
  T* dq = dqkv + head;
  attend_bwd<T, HD, /*kRound=*/false>(q, q + D, q + 2 * D, 3 * D,
                                      dout + size_t(n) * L * D + size_t(h) * HD, D,
                                      dq, dq + D, dq + 2 * D, 3 * D, L, scale);
}

// kSingle: every key in one sweep (L <= 80).
template <int HD, bool kSingle, typename TO>
__global__ void __launch_bounds__(tc::kTcMaxThreads, 1)
mha2_bwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const __nv_bfloat16* __restrict__ dout, TO* __restrict__ dqkv, int L,
                   int H, float scale) {
  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const size_t D = size_t(H) * HD;
  const size_t head = size_t(n) * L * 3 * D + size_t(h) * HD;
  const __nv_bfloat16* q = qkv + head;
  TO* dq = dqkv + head;
  tc::attend_bwd_tc<HD, kSingle, /*kK1=*/false, TO, /*kOneAcc=*/kSingle && HD >= 64>(
      q, q + D, q + 2 * D, 3 * D, dout + size_t(n) * L * D + size_t(h) * HD, D, dq, dq + D,
      dq + 2 * D, 3 * D, L, scale);
}

// Outputs of the input type (kF32Out false) or fp32.
template <bool kF32Out>
int launch_bwd(const void* qkv, const void* dout, void* dqkv, int n, int L, int H, int hd,
               int dtype, float scale, void* stream) {
  return dispatch(dtype, hd, [&](auto type, auto head_dim) -> cudaError_t {
    using T = typename decltype(type)::type;
    constexpr int HD = decltype(head_dim)::value;
    const auto s = static_cast<cudaStream_t>(stream);
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      using TO = std::conditional_t<kF32Out, float, T>;
      return tc::launch_tc(tc::one_sweep(L) ? mha2_bwd_tc_kernel<HD, true, TO>
                                            : mha2_bwd_tc_kernel<HD, false, TO>,
                           tc::tc_bwd_smem_bytes<HD>(L), n * H, L, s,
                           static_cast<const T*>(qkv), static_cast<const T*>(dout),
                           static_cast<TO*>(dqkv), L, H, scale);
    } else {  // fp32 inputs: fp32 outputs either way
      return launch(mha2_bwd_kernel<T, HD>, bwd_smem_bytes<T, HD>(L), n * H, s,
                    static_cast<const T*>(qkv), static_cast<const T*>(dout),
                    static_cast<T*>(dqkv), L, H, scale);
    }
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha2_bwd(const void* qkv, const void* dout, void* dqkv, int n, int L,
                              int H, int hd, int dtype, float scale, void* stream) {
  return launch_bwd<false>(qkv, dout, dqkv, n, L, H, hd, dtype, scale, stream);
}

// The same sums written as fp32, before their rounding to the input type:
// the accuracy checks' entry (chip_smoke.py [kernel],
// tests/test_torch_port_cuda.py).
extern "C" int csmae_mha2_bwd_f32(const void* qkv, const void* dout, void* dqkv, int n, int L,
                                  int H, int hd, int dtype, float scale, void* stream) {
  return launch_bwd<true>(qkv, dout, dqkv, n, L, H, hd, dtype, scale, stream);
}
