// Attention forward on the raw qkv projection layout, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_mha3_kernel` of
// cross_scale_mae_tpu/ops/attention.py (launched by `_mha3_fwd_pallas`).
// Same function: qkv (N, L, 3D) -> out (N, L, D) with D = H * HD; head h's
// q, k and v are the columns [h*HD, (h+1)*HD) of each D-wide third. For each
// head, out_h = softmax(q_h k_h^T * HD^-0.5) v_h with fp32 logits and softmax,
// the probabilities rounded to the input type before the PV product, and the
// PV sum in fp32 (the op order of the Pallas kernel and of
// mha_v3_reference in cross_scale_mae_torch/ops/attention.py).
//
// Bound by memory: at the serving shape (N = 64, L = 65, 12 heads of 64)
// about 0.0076 ms at 3.35 TB/s. bf16 inputs run the body of mha_tc.cuh,
// one warp per 16 query rows: the logits on the CUDA cores in
// mha_v3_reference's fp32 order (one fmaf chain per element), P rounded once
// to bf16 (one split term, the Pallas kernel's own rounding) as the A
// operand of P V on the tensor cores, each 16-key slice's product added
// with round-to-nearest. The logits keep the plain order because the probe's
// kernel-vs-plain gate (chip_smoke.py [linprobe]) holds the ViT-B logits to
// 2**-7 of the plain path's, which even an fp64 attention misses (0.0079;
// PERF.md section 6). fp32 inputs run the scalar body of mha_common.cuh (128
// threads). Both take one block per (sample, head), with rows 3D apart in
// qkv and D apart in out.

#include <type_traits>

#include "mha_common.cuh"
#include "mha_tc.cuh"

namespace {

using namespace csmae;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
mha3_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int L, int H, float scale) {
  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const size_t D = size_t(H) * HD;
  const T* q = qkv + size_t(n) * L * 3 * D + size_t(h) * HD;
  attend_fwd<T, HD, /*kRound=*/true>(q, q + D, q + 2 * D, 3 * D,
                                     out + size_t(n) * L * D + size_t(h) * HD, D, L, scale);
}

// kSingle: every key in one sweep (L <= 80); at most 128 registers then,
// so that two blocks of eight warps fit an SM.
template <int HD, bool kSingle>
__global__ void __launch_bounds__(tc::kTcMaxThreads, kSingle ? 2 : 1)
mha3_fwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                   int L, int H, float scale) {
  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const size_t D = size_t(H) * HD;
  const __nv_bfloat16* q = qkv + size_t(n) * L * 3 * D + size_t(h) * HD;
  tc::attend_fwd_tc<HD, kSingle, /*kK1=*/true>(
      q, q + D, q + 2 * D, 3 * D, out + size_t(n) * L * D + size_t(h) * HD, D, L, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha3_fwd(const void* qkv, void* out, int n, int L, int H, int hd,
                              int dtype, float scale, void* stream) {
  return dispatch(dtype, hd, [&](auto type, auto head_dim) -> cudaError_t {
    using T = typename decltype(type)::type;
    constexpr int HD = decltype(head_dim)::value;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return tc::launch_tc(tc::one_sweep(L) ? mha3_fwd_tc_kernel<HD, true>
                                            : mha3_fwd_tc_kernel<HD, false>,
                           tc::tc_fwd_smem_bytes<HD>(L), n * H, L,
                           static_cast<cudaStream_t>(stream), static_cast<const T*>(qkv),
                           static_cast<T*>(out), L, H, scale);
    } else {
      return launch(mha3_fwd_kernel<T, HD>, fwd_smem_bytes<T, HD>(L), n * H,
                    static_cast<cudaStream_t>(stream), static_cast<const T*>(qkv),
                    static_cast<T*>(out), L, H, scale);
    }
  });
}
