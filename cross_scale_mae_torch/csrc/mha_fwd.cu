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
// (BH = 512*16, L = 65, HD = 64) at 3.35 TB/s. bf16 inputs run the
// tensor-core body of mha_tc.cuh (mma.sync products, P split into bf16
// terms, one warp per 16 query rows, q, k and v in shared memory); fp32
// inputs the scalar body of mha_common.cuh (128 threads). Both take one
// block per (sample, head), with rows HD apart in every tensor.

#include <type_traits>

#include "mha_common.cuh"
#include "mha_tc.cuh"

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

// kSingle: every key in one sweep (L <= 80); at most 128 registers then,
// so that two blocks of eight warps fit an SM.
template <int HD, bool kSingle>
__global__ void __launch_bounds__(tc::kTcMaxThreads, kSingle ? 2 : 1)
mha_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int L,
                  float scale) {
  const size_t head = size_t(blockIdx.x) * L * HD;
  tc::attend_fwd_tc<HD, kSingle, /*kK1=*/false>(
      q + head, k + head, v + head, HD, out + head, HD, L, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha_fwd(const void* q, const void* k, const void* v, void* out, int bh,
                             int L, int hd, int dtype, float scale, void* stream) {
  return dispatch(dtype, hd, [&](auto type, auto head_dim) -> cudaError_t {
    using T = typename decltype(type)::type;
    constexpr int HD = decltype(head_dim)::value;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return tc::launch_tc(tc::one_sweep(L) ? mha_fwd_tc_kernel<HD, true>
                                            : mha_fwd_tc_kernel<HD, false>,
                           tc::tc_fwd_smem_bytes<HD>(L), bh, L,
                           static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<T*>(out), L, scale);
    } else {
      return launch(mha_fwd_kernel<T, HD>, fwd_smem_bytes<T, HD>(L), bh,
                    static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
                    static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
                    L, scale);
    }
  });
}
