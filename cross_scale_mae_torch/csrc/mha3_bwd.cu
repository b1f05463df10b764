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
// Bound by memory: the Pallas CostEstimate counts 7*N*L*D elements moved
// (qkv and dO read, dqkv written) against 10*N*H*L*L*HD flops; in bf16 about
// 0.042 ms at (768, 17, 12x64) and 0.107 ms at (768, 65, 16x32) at 3.35
// TB/s. bf16 inputs run the tensor-core body of mha_tc.cuh (attend_bwd_tc
// with kK1: the logits and dP as mma.sync products, P and dS rounded once
// to bf16, K1's own roundings, as the operands of dV and of dQ and dK, each
// 16-row slice added with round-to-nearest; a warp per 16 query rows, then
// per 16 key rows); fp32 inputs the scalar body of mha_common.cuh (128
// threads, two passes). Both take one block per (sample, head), rows 3D
// apart in qkv and dqkv and D apart in dO, and no atomics. The tensor-core
// one-sweep kernel (L <= 80) is held to 128 registers up to HD = 64: at the
// decoder's shape (L = 65, HD = 32, 5 warps, 27 KB of shared memory) that
// fits 3 blocks an SM, at the encoder's (L = 17, HD = 64, 2 warps, 18 KB)
// 8. At HD = 64 that needs pass B's dV and dK in a loop each (kOneAcc in
// mha_tc.cuh); at HD = 80 even then 128 spilled, so there ptxas takes what
// it needs (chip_smoke.py [build] prints the count).

#include <type_traits>

#include "mha_common.cuh"
#include "mha_tc.cuh"

namespace {

using namespace csmae;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
mha3_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                T* __restrict__ dqkv, int L, int H, float scale) {
  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const size_t D = size_t(H) * HD;
  const size_t head = size_t(n) * L * 3 * D + size_t(h) * HD;
  const T* q = qkv + head;
  T* dq = dqkv + head;
  attend_bwd<T, HD, /*kRound=*/true>(q, q + D, q + 2 * D, 3 * D,
                                     dout + size_t(n) * L * D + size_t(h) * HD, D,
                                     dq, dq + D, dq + 2 * D, 3 * D, L, scale);
}

// kSingle: every key in one sweep (L <= 80); at most 128 registers then,
// up to HD = 64.
template <int HD, bool kSingle, typename TO>
__global__ void __launch_bounds__(tc::kTcMaxThreads, kSingle && HD <= 64 ? 2 : 1)
mha3_bwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const __nv_bfloat16* __restrict__ dout, TO* __restrict__ dqkv, int L,
                   int H, float scale) {
  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const size_t D = size_t(H) * HD;
  const size_t head = size_t(n) * L * 3 * D + size_t(h) * HD;
  const __nv_bfloat16* q = qkv + head;
  TO* dq = dqkv + head;
  tc::attend_bwd_tc<HD, kSingle, /*kK1=*/true, TO>(
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
      return tc::launch_tc(tc::one_sweep(L) ? mha3_bwd_tc_kernel<HD, true, TO>
                                            : mha3_bwd_tc_kernel<HD, false, TO>,
                           tc::tc_bwd_smem_bytes<HD>(L), n * H, L, s,
                           static_cast<const T*>(qkv), static_cast<const T*>(dout),
                           static_cast<TO*>(dqkv), L, H, scale);
    } else {  // fp32 inputs: fp32 outputs either way
      return launch(mha3_bwd_kernel<T, HD>, bwd_smem_bytes<T, HD>(L), n * H, s,
                    static_cast<const T*>(qkv), static_cast<const T*>(dout),
                    static_cast<T*>(dqkv), L, H, scale);
    }
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha3_bwd(const void* qkv, const void* dout, void* dqkv, int n, int L,
                              int H, int hd, int dtype, float scale, void* stream) {
  return launch_bwd<false>(qkv, dout, dqkv, n, L, H, hd, dtype, scale, stream);
}

// The same sums written as fp32, before their rounding to the input type:
// the accuracy checks' entry (chip_smoke.py [train_grads_fp64],
// tests/test_torch_port_cuda.py).
extern "C" int csmae_mha3_bwd_f32(const void* qkv, const void* dout, void* dqkv, int n, int L,
                                  int H, int hd, int dtype, float scale, void* stream) {
  return launch_bwd<true>(qkv, dout, dqkv, n, L, H, hd, dtype, scale, stream);
}
