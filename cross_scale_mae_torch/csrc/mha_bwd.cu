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
// HD = 64) at 3.35 TB/s. bf16 inputs run the tensor-core body of mha_tc.cuh
// (attend_bwd_tc: mma.sync products, P and dS split into three bf16 terms,
// each 16-row slice added with round-to-nearest; a warp per 16 query rows,
// then per 16 key rows); fp32 inputs the scalar body of mha_common.cuh (128
// threads, two passes). Both take one block per (sample, head), with rows
// HD apart in every tensor, and no atomics.

#include <type_traits>

#include "mha_common.cuh"
#include "mha_tc.cuh"

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

// kSingle: every key in one sweep (L <= 80).
template <int HD, bool kSingle, typename TO>
__global__ void __launch_bounds__(tc::kTcMaxThreads)
mha_bwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  TO* __restrict__ dq, TO* __restrict__ dk, TO* __restrict__ dv, int L,
                  float scale) {
  const size_t head = size_t(blockIdx.x) * L * HD;
  tc::attend_bwd_tc<HD, kSingle, /*kK1=*/false, TO>(q + head, k + head, v + head, HD,
                                                    dout + head, HD, dq + head, dk + head,
                                                    dv + head, HD, L, scale);
}

// Outputs of the input type (kF32Out false) or fp32.
template <bool kF32Out>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
               void* dk, void* dv, int bh, int L, int hd, int dtype, float scale,
               void* stream) {
  return dispatch(dtype, hd, [&](auto type, auto head_dim) -> cudaError_t {
    using T = typename decltype(type)::type;
    constexpr int HD = decltype(head_dim)::value;
    const auto s = static_cast<cudaStream_t>(stream);
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      using TO = std::conditional_t<kF32Out, float, T>;
      return tc::launch_tc(tc::one_sweep(L) ? mha_bwd_tc_kernel<HD, true, TO>
                                            : mha_bwd_tc_kernel<HD, false, TO>,
                           tc::tc_bwd_smem_bytes<HD>(L), bh, L, s, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<const T*>(dout), static_cast<TO*>(dq),
                           static_cast<TO*>(dk), static_cast<TO*>(dv), L, scale);
    } else {  // fp32 inputs: fp32 outputs either way
      return launch(mha_bwd_kernel<T, HD>, bwd_smem_bytes<T, HD>(L), bh, s,
                    static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<const T*>(dout),
                    static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), L, scale);
    }
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha_bwd(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, int bh, int L, int hd, int dtype,
                             float scale, void* stream) {
  return launch_bwd<false>(q, k, v, dout, dq, dk, dv, bh, L, hd, dtype, scale, stream);
}

// The same sums written as fp32, before their rounding to the input type:
// the accuracy checks' entry (chip_smoke.py, tests/test_torch_port_cuda.py).
extern "C" int csmae_mha_bwd_f32(const void* q, const void* k, const void* v,
                                 const void* dout, void* dq, void* dk, void* dv, int bh, int L,
                                 int hd, int dtype, float scale, void* stream) {
  return launch_bwd<true>(q, k, v, dout, dq, dk, dv, bh, L, hd, dtype, scale, stream);
}
