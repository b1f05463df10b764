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
// (mha_qkv_bwd_reference in cross_scale_mae_torch/ops/attention.py is the
// plain PyTorch version.)
//
// Bound by memory: qkv and dO read once and dqkv written once, 7*N*L*D
// elements against 10*N*H*L*L*HD flops; in bf16 about 0.107 ms at the
// decoder's (768, 65, 16x32) at 3.35 TB/s. One block of 128 threads per
// (sample, head) runs the shared two-pass backward body of mha_common.cuh
// without K1's roundings, so dK and dV need no atomics.

#include "mha_common.cuh"

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha2_bwd(const void* qkv, const void* dout, void* dqkv, int n, int L,
                              int H, int hd, int dtype, float scale, void* stream) {
  return dispatch(dtype, hd, [&](auto type, auto head_dim) {
    using T = typename decltype(type)::type;
    constexpr int HD = decltype(head_dim)::value;
    return launch(mha2_bwd_kernel<T, HD>, bwd_smem_bytes<T, HD>(L), n * H,
                  static_cast<cudaStream_t>(stream), static_cast<const T*>(qkv),
                  static_cast<const T*>(dout), static_cast<T*>(dqkv), L, H, scale);
  });
}
