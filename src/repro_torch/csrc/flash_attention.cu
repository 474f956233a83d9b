// Flash-attention forward for the full-sequence path of the LM.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, called by flash_attention_fwd): online-softmax attention,
// causal (qpos >= kpos from position 0) or bidirectional, grouped-query
// (query head h reads kv head h / G), keys past Sk masked, key tiles wholly
// above the diagonal skipped, float32 m / l / acc, no backward.
//
// Design.  The Pallas kernel walks (head, q block, k block) in order with
// the accumulators in VMEM scratch across the k sweep.  Here one block owns
// 64 query rows of one (batch, kv head) and walks the keys in a loop, the
// accumulators in registers (attention_tile.cuh).  The tensors stay in the
// model's (B, S, H, hd) layout: the block computes its own offsets, so
// there is no transpose and no padding copy.  Rows of one block share one
// query head unless Sq < 64.
//
// Bound on an H100: operations.  Causal attention over S keys does
// 2 * 2 * S^2 / 2 * hd flops per query head (QK^T and PV); at B = 1,
// S = 8192, 16 heads of 128 that is 275 GFLOP, 0.278 ms at 989 TFLOP/s,
// against 2 * 8192 * (16 + 2 * 8) * 128 * 2 B = 134 MB of input and output
// (0.04 ms at 3.35 TB/s).  This first version uses mma.sync (not wgmma) and
// spends one extra P.V product on p's bfloat16 remainder.

#include "attention_tile.cuh"

namespace {

using namespace attention_tile;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Params p) {
  attention_block<T, HD, false>(p);
}

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>();
  static const cudaError_t granted = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (granted != cudaSuccess) return static_cast<int>(granted);
  const dim3 grid((p.G * p.Sq + kRows - 1) / kRows, p.B * p.n_kv, 1);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o (B, Sq, Hq, hd), k/v (B, Sk, n_kv, hd),
// contiguous; hd a multiple of 16 up to 128, Hq a multiple of n_kv.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int B, int Sq, int Sk, int Hq, int n_kv,
                                      int hd, int causal, float scale, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0) return 0;
  Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.n_kv = n_kv; p.G = Hq / n_kv; p.hd = hd;
  p.key_end = Sk;
  p.causal = causal;
  p.q_offset = 0;
  p.n_splits = 1;
  p.split_keys = (Sk + kKeys - 1) / kKeys * kKeys;
  p.scale = scale;
  if (dtype == 1) {
    return hd <= 64 ? launch<__nv_bfloat16, 64>(p, stream)
                    : launch<__nv_bfloat16, 128>(p, stream);
  }
  return hd <= 64 ? launch<float, 64>(p, stream) : launch<float, 128>(p, stream);
}
