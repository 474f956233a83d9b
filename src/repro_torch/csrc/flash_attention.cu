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
// 128 query rows of one (batch, kv head) and walks the keys in a loop, the
// accumulators in registers.  The tensors stay in the model's (B, S, H, hd)
// layout: TMA maps and the block's own offsets address it, so there is no
// transpose and no padding copy.
//   bfloat16 (attention_hopper.cuh): 384 threads, one producer warp
//   streaming 128-key K/V tiles by TMA into a ring of 3 slots (4 at
//   head_dim <= 64), two consumer warpgroups of 64 rows running QK^T and PV
//   on wgmma in turns, each overlapping its softmax with its previous PV.
//   Shared memory 230,448 B at head_dim 128 (148,544 B at 64), one block
//   per SM; ptxas: 168 registers at the 384-thread launch bound, which
//   setmaxnreg moves to 240 per consumer and 24 per producer thread, no
//   spills.  p goes into PV rounded once to bfloat16: the remainder
//   product cost 36-39 % more time at S = 8192 and every check passes
//   without it (PERF.md, the kernel findings).
//   float32 (attention_tile.cuh): the CUDA-core tile, 64 rows, 64-key
//   tiles, 168,960 B of shared memory and 192 registers at head_dim 128,
//   for holding the algorithm at float32 tolerance.
//
// Bound on an H100: operations.  Causal attention over S keys does
// 2 * 2 * S^2 / 2 * hd flops per query head (QK^T and PV); at B = 1,
// S = 8192, 16 heads of 128 that is 275 GFLOP, 0.278 ms at 989 TFLOP/s,
// against 2 * 8192 * (16 + 2 * 8) * 128 * 2 B = 134 MB of input and output
// (0.04 ms at 3.35 TB/s).

#include "attention_hopper.cuh"
#include "attention_tile.cuh"

namespace {

using attention_tile::Params;

template <int HD>
__global__ void __launch_bounds__(attention_hopper::kThreads, 1)
    flash_attention_bf16(const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, const Params p) {
  attention_hopper::attention_block<HD, false>(&kmap, &vmap, p);
}

template <int HD>
__global__ void __launch_bounds__(attention_tile::kThreads) flash_attention_f32(Params p) {
  attention_tile::attention_block_f32<HD, false>(p);
}

template <int HD>
int launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = attention_tile::smem_bytes<HD>();
  static const cudaError_t granted = cudaFuncSetAttribute(
      flash_attention_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (granted != cudaSuccess) return static_cast<int>(granted);
  const int rows = attention_tile::kRows;
  const dim3 grid((p.G * p.Sq + rows - 1) / rows, p.B * p.n_kv, 1);
  flash_attention_f32<HD><<<grid, attention_tile::kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o (B, Sq, Hq, hd), k/v (B, Sk, n_kv, hd),
// contiguous, 16-byte aligned; hd a multiple of 16 up to 128, Hq a multiple
// of n_kv.
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
  const int tile = attention_hopper::kKeys;
  p.split_keys = (Sk + tile - 1) / tile * tile;
  p.scale = scale;
  if (dtype == 1) {
    return hd <= 64
               ? attention_hopper::launch<64, flash_attention_bf16<64>>(p, stream)
               : attention_hopper::launch<128, flash_attention_bf16<128>>(p, stream);
  }
  return hd <= 64 ? launch_f32<64>(p, stream) : launch_f32<128>(p, stream);
}
