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
// TB/s. The design is in mha_common.cuh: one block of 128 threads per
// (sample, head), two passes, no atomics; here with rows 3D apart in qkv and
// dqkv and D apart in dO.

#include "mha_common.cuh"

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha3_bwd(const void* qkv, const void* dout, void* dqkv, int n, int L,
                              int H, int hd, int dtype, float scale, void* stream) {
  return dispatch(dtype, hd, [&](auto type, auto head_dim) {
    using T = typename decltype(type)::type;
    constexpr int HD = decltype(head_dim)::value;
    return launch(mha3_bwd_kernel<T, HD>, bwd_smem_bytes<T, HD>(L), n * H,
                  static_cast<cudaStream_t>(stream), static_cast<const T*>(qkv),
                  static_cast<const T*>(dout), static_cast<T*>(dqkv), L, H, scale);
  });
}
