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
// that is 4096 rows, more than a block can hold, so rows are tiled by 64
// (attention_tile.cuh).  At decode (Sq = 1) there are only B * n_kv row
// tiles (64 at B = 8) for 132 SMs, and each would stream a whole cache
// head: the keys are split across blocks instead (split-K flash-decoding),
// each block writing float32 partial (acc, m, l), and a combine pass
// rescales and sums the splits.  The wrapper picks the split count from
// the grid size; it is 1 at prefill, where the combine is skipped.  Both
// launches make one call of the wrapper.  kv_len arrives as an argument,
// so a step needs no device-to-host read.
//
// Bound on an H100: bytes at decode (every visible cache slot of K and V
// read once: 1.07 GB for B = 8, kv_len = 32768, 8 kv heads of 128, 0.32 ms
// at 3.35 TB/s); operations at prefill (B = 8, Sq = kv_len = 2048:
// 137 GFLOP causal, 0.139 ms at 989 TFLOP/s).

#include "attention_tile.cuh"

namespace {

using namespace attention_tile;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Params p) {
  attention_block<T, HD, true>(p);
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
      from_float<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>();
  static const cudaError_t granted = cudaFuncSetAttribute(
      decode_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (granted != cudaSuccess) return static_cast<int>(granted);
  const int n_rows = p.G * p.Sq;
  const dim3 grid((n_rows + kRows - 1) / kRows, p.B * p.n_kv, p.n_splits);
  decode_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return static_cast<int>(err);
  decode_combine_kernel<T><<<dim3(n_rows, p.B * p.n_kv), kMaxHD, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o (B, Sq, Hq, hd), caches
// (B, S_max, n_kv, hd), contiguous; hd a multiple of 16 up to 128.  With
// n_splits > 1, part_acc holds n_splits * B * n_kv * G * Sq * 128 floats and
// part_ml twice n_splits * B * n_kv * G * Sq; split_keys is a multiple of 64.
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
  if (dtype == 1) {
    return hd <= 64 ? launch<__nv_bfloat16, 64>(p, stream)
                    : launch<__nv_bfloat16, 128>(p, stream);
  }
  return hd <= 64 ? launch<float, 64>(p, stream) : launch<float, 128>(p, stream);
}
