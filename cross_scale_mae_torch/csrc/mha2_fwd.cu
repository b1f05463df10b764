// Attention forward on the (N, L, 3H, hd) qkv layout, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_mha2_kernel` of
// cross_scale_mae_tpu/ops/attention.py (launched by `_mha2_fwd_call`, the
// forward of `pallas_mha_qkv`). Same function: qkv (N, L, 3H, HD) -> out
// (N, L, H, HD), q head g at [0, H), k at [H, 2H), v at [2H, 3H) of the
// second-minor axis. Those are the bytes of K1's (N, L, 3D) layout with
// D = H * HD: q head g starts at column g*HD of a row 3D long, k head g at
// D + g*HD. For each head, out_g = softmax(q_g k_g^T * HD^-0.5) v_g with
// every operand read as fp32, fp32 logits, softmax and PV sum, P not
// rounded, and the output rounded once: K2's numerics (mha_qkv_reference in
// cross_scale_mae_torch/ops/attention.py is the plain PyTorch version).
//
// Bound by memory, as K1f: at ViT-B's shape (N = 64, L = 65, 12 heads of 64)
// qkv read once and out written once take about 0.0076 ms at 3.35 TB/s. The
// Pallas kernel runs one program per sample and loops over the heads; here
// one block of 128 threads per (sample, head) runs the shared forward body
// of mha_common.cuh without K1's rounding of P, rows 3D apart in qkv and D
// apart in out.

#include "mha_common.cuh"

namespace {

using namespace csmae;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
mha2_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int L, int H, float scale) {
  const int n = blockIdx.x / H;
  const int h = blockIdx.x - n * H;
  const size_t D = size_t(H) * HD;
  const T* q = qkv + size_t(n) * L * 3 * D + size_t(h) * HD;
  attend_fwd<T, HD, /*kRound=*/false>(q, q + D, q + 2 * D, 3 * D,
                                      out + size_t(n) * L * D + size_t(h) * HD, D, L, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int csmae_mha2_fwd(const void* qkv, void* out, int n, int L, int H, int hd,
                              int dtype, float scale, void* stream) {
  return dispatch(dtype, hd, [&](auto type, auto head_dim) {
    using T = typename decltype(type)::type;
    constexpr int HD = decltype(head_dim)::value;
    return launch(mha2_fwd_kernel<T, HD>, fwd_smem_bytes<T, HD>(L), n * H,
                  static_cast<cudaStream_t>(stream), static_cast<const T*>(qkv),
                  static_cast<T*>(out), L, H, scale);
  });
}
