// Flash-decoding for the serving path of the LM: prefill and decode steps
// attend their Sq new queries over the KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel, called by decode_attention_fwd): the G * Sq rows of one
// kv head (row r = (g = r / Sq, qi = r % Sq)) against the cache, fill level
// kv_len given at run time, query qi at position kv_len - Sq + qi seeing
// keys kpos <= its position, cache slots past kv_len never read.
//
// Design.  The Pallas kernel holds all G * Sq rows of a kv head in one
// block and walks 512-key chunks in order.  At prefill (Sq = 2048, G = 2)
// that is 4096 rows, more than a block can hold, so rows are tiled by 128.
//   bfloat16 runs the Hopper tile of flash_attention.cu
//   (attention_hopper.cuh: a producer warp, a TMA ring of 3 slots of
//   128-key K/V tiles, two wgmma consumer warpgroups of 64 rows, 230,448 B
//   of shared memory, 168 registers at the launch bound raised to 240 per
//   consumer, no spills, p rounded once to bfloat16).  Its K/V maps end at
//   key_end = min(S_max, kv_len), so slots past kv_len come back as zeros
//   and are never read.
//   float32 runs the CUDA-core tile (attention_tile.cuh, 194 registers).
// At decode (Sq = 1) each block has G * Sq = 2 live rows, so one consumer
// warpgroup works and the other exits, and there are only B * n_kv row
// tiles (64 at B = 8) for 132 SMs, each of which would stream a whole cache
// head: the keys are split across blocks instead (split-K flash-decoding),
// each block writing float32 partial (acc, m, l), and a combine pass
// rescales and sums the splits.  The wrapper picks the split count
// (decode_attention/ops.py::split_plan): one wave of blocks, 2 splits at
// B = 8, since one 230 KB block fills an SM; it is 1 at prefill, where the
// combine is skipped.  Both launches make one call of the wrapper.  kv_len
// arrives as an argument, so a step needs no device-to-host read.
//
// Bound on an H100: bytes at decode (every visible cache slot of K and V
// read once: 1.07 GB for B = 8, kv_len = 32768, 8 kv heads of 128, 0.32 ms
// at 3.35 TB/s); operations at prefill (B = 8, Sq = kv_len = 2048:
// 137 GFLOP causal, 0.139 ms at 989 TFLOP/s).

#include "attention_hopper.cuh"
#include "attention_tile.cuh"

namespace {

using attention_tile::kMaxHD;
using attention_tile::kNegInf;
using attention_tile::Params;

template <int HD>
__global__ void __launch_bounds__(attention_hopper::kThreads, 1)
    decode_attention_bf16(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const Params p) {
  attention_hopper::attention_block<HD, true>(&kmap, &vmap, p);
}

template <int HD>
__global__ void __launch_bounds__(attention_tile::kThreads) decode_attention_f32(Params p) {
  attention_tile::attention_block_f32<HD, true>(p);
}

// One block per query row: out = sum_i acc_i e^(m_i - m) / max(sum_i l_i e^(m_i - m), 1e-30).
template <typename T>
__global__ void __launch_bounds__(kMaxHD) decode_combine_kernel(Params p) {
  const int n_rows = p.G * p.Sq;
  const int r = blockIdx.x;
  const int bkv = blockIdx.y;
  const int d = threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.y) * n_rows;  // per split
  const long long row = static_cast<long long>(bkv) * n_rows + r;
  float m = kNegInf;
  for (int i = 0; i < p.n_splits; ++i) m = fmaxf(m, p.part_ml[(i * stride + row) * 2]);
  float l = 0.f, acc = 0.f;
  for (int i = 0; i < p.n_splits; ++i) {
    const long long at = i * stride + row;
    const float w = expf(p.part_ml[at * 2] - m);
    l += w * p.part_ml[at * 2 + 1];
    if (d < p.hd) acc += w * p.part_acc[at * kMaxHD + d];
  }
  if (d >= p.hd) return;
  const int b = bkv / p.n_kv, kvh = bkv % p.n_kv;
  const int g = r / p.Sq, qi = r % p.Sq;
  const int Hq = p.n_kv * p.G;
  T* out = static_cast<T*>(p.o);
  out[((static_cast<long long>(b) * p.Sq + qi) * Hq + kvh * p.G + g) * p.hd + d] =
      attention_tile::from_float<T>(acc / fmaxf(l, 1e-30f));
}

template <int HD>
int launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = attention_tile::smem_bytes<HD>();
  static const cudaError_t granted = cudaFuncSetAttribute(
      decode_attention_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (granted != cudaSuccess) return static_cast<int>(granted);
  const int rows = attention_tile::kRows;
  const dim3 grid((p.G * p.Sq + rows - 1) / rows, p.B * p.n_kv, p.n_splits);
  decode_attention_f32<HD><<<grid, attention_tile::kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int combine(const Params& p, cudaStream_t stream) {
  decode_combine_kernel<T><<<dim3(p.G * p.Sq, p.B * p.n_kv), kMaxHD, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o (B, Sq, Hq, hd), caches
// (B, S_max, n_kv, hd), contiguous, 16-byte aligned; hd a multiple of 16 up
// to 128.  With n_splits > 1, part_acc holds n_splits * B * n_kv * G * Sq *
// 128 floats and part_ml twice n_splits * B * n_kv * G * Sq; split_keys is
// a multiple of 128.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, void* o,
                                       float* part_acc, float* part_ml, int dtype, int B,
                                       int Sq, int S_max, int Hq, int n_kv, int hd, int kv_len,
                                       int n_splits, int split_keys, float scale,
                                       cudaStream_t stream) {
  if (B <= 0 || Sq <= 0) return 0;
  Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.part_acc = part_acc; p.part_ml = part_ml;
  p.B = B; p.Sq = Sq; p.Sk = S_max; p.n_kv = n_kv; p.G = Hq / n_kv; p.hd = hd;
  p.key_end = kv_len < S_max ? kv_len : S_max;
  p.causal = 1;
  p.q_offset = kv_len - Sq;
  p.n_splits = n_splits;
  p.split_keys = split_keys;
  p.scale = scale;
  int err;
  if (dtype == 1) {
    err = hd <= 64 ? attention_hopper::launch<64, decode_attention_bf16<64>>(p, stream)
                   : attention_hopper::launch<128, decode_attention_bf16<128>>(p, stream);
  } else {
    err = hd <= 64 ? launch_f32<64>(p, stream) : launch_f32<128>(p, stream);
  }
  if (err != 0 || n_splits == 1) return err;
  return dtype == 1 ? combine<__nv_bfloat16>(p, stream) : combine<float>(p, stream);
}
