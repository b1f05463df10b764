// Attention forward on head-folded q, k, v, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_mha_kernel` of
// cross_scale_mae_tpu/ops/attention.py (launched by `_mha_fwd_call`, under
// `_mha_folded`, `pallas_mha` and `mha`). Same function: q, k, v (BH, L, HD)
// -> out (BH, L, HD), each a contiguous tensor with one (sample, head) per
// leading index. For each, out = softmax(q k^T * HD^-0.5) v in the Pallas
// kernel's op order: the operands are read as fp32, the logits are fp32 sums
// scaled after the dot, the softmax is fp32, P stays fp32 into the PV sum,
// and only the output is rounded, once, to the input type
// (mha_folded_reference in cross_scale_mae_torch/ops/attention.py is the
// plain PyTorch version). Unlike K1f (mha3_fwd.cu), P is not rounded.
//
// Bound by memory: the Pallas CostEstimate counts 4*BH*L*HD elements moved
// against 4*BH*L*L*HD flops, about 0.08 ms at the ViT-L finetune shape
// (BH = 512*16, L = 65, HD = 64) at 3.35 TB/s. The design is in
// mha_common.cuh: one block of 128 threads per (sample, head), here with
// rows HD apart in every tensor.

#include "mha_common.cuh"

namespace {

using namespace csmae;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, int L, float scale) {
  const size_t head = size_t(blockIdx.x) * L * HD;
  attend_fwd<T, HD, /*kRound=*/false>(q + head, k + head, v + head, HD, out + head, HD, L,
                                      scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha_fwd(const void* q, const void* k, const void* v, void* out, int bh,
                             int L, int hd, int dtype, float scale, void* stream) {
  return dispatch(dtype, hd, [&](auto type, auto head_dim) {
    using T = typename decltype(type)::type;
    constexpr int HD = decltype(head_dim)::value;
    return launch(mha_fwd_kernel<T, HD>, fwd_smem_bytes<T, HD>(L), bh,
                  static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
                  L, scale);
  });
}
