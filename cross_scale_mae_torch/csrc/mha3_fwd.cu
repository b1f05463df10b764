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
// about 0.0076 ms at 3.35 TB/s. The design is in mha_common.cuh: one block
// of 128 threads per (sample, head), here with rows 3D apart in qkv and D
// apart in out.

#include "mha_common.cuh"

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha3_fwd(const void* qkv, void* out, int n, int L, int H, int hd,
                              int dtype, float scale, void* stream) {
  return dispatch(dtype, hd, [&](auto type, auto head_dim) {
    using T = typename decltype(type)::type;
    constexpr int HD = decltype(head_dim)::value;
    return launch(mha3_fwd_kernel<T, HD>, fwd_smem_bytes<T, HD>(L), n * H,
                  static_cast<cudaStream_t>(stream), static_cast<const T*>(qkv),
                  static_cast<T*>(out), L, H, scale);
  });
}
