// Attention backward on head-folded q, k, v, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_mha_bwd_kernel` of
// cross_scale_mae_tpu/ops/attention.py (launched by `_mha_folded_bwd`, the
// backward of the custom VJP `_mha_folded`, which saves q, k and v). Same
// function: q, k, v, dO (BH, L, HD) -> dq, dk, dv (BH, L, HD), each a
// contiguous tensor with one (sample, head) per leading index. In the Pallas
// kernel's op order, with every operand read as fp32:
//   P   = softmax(q k^T * scale)  fp32 logits (scale after the dot), fp32 P
//   dV  = P^T dO                  with the fp32 P
//   dP  = dO V^T                  fp32
//   row = sum_j dP * P
//   dS  = P * (dP - row) * scale  fp32, not rounded
//   dQ  = dS K,  dK = dS^T Q      fp32 sums
// and each output rounded once to the input type (mha_folded_bwd_reference
// in cross_scale_mae_torch/ops/attention.py is the plain PyTorch version).
// Unlike K1b (mha3_bwd.cu), neither P nor dS is rounded on the way.
//
// Bound by memory: the Pallas CostEstimate counts 7*BH*L*HD elements moved
// (q, k, v and dO read, dq, dk and dv written) against 10*BH*L*L*HD flops;
// in bf16 about 0.14 ms at the ViT-L finetune shape (BH = 512*16, L = 65,
// HD = 64) at 3.35 TB/s. The design is in mha_common.cuh: one block of 128
// threads per (sample, head), two passes, no atomics; here with rows HD
// apart in every tensor.

#include "mha_common.cuh"

namespace {

using namespace csmae;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
mha_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
               T* __restrict__ dv, int L, float scale) {
  const size_t head = size_t(blockIdx.x) * L * HD;
  attend_bwd<T, HD, /*kRound=*/false>(q + head, k + head, v + head, HD, dout + head, HD,
                                      dq + head, dk + head, dv + head, HD, L, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha_bwd(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, int bh, int L, int hd, int dtype,
                             float scale, void* stream) {
  return dispatch(dtype, hd, [&](auto type, auto head_dim) {
    using T = typename decltype(type)::type;
    constexpr int HD = decltype(head_dim)::value;
    return launch(mha_bwd_kernel<T, HD>, bwd_smem_bytes<T, HD>(L), bh,
                  static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
                  static_cast<T*>(dv), L, scale);
  });
}
