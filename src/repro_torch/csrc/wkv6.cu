// Chunked WKV6 recurrence (RWKV6 time-mix, data-dependent decay).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6/kernel.py
// (_wkv6_kernel, called by wkv6_fwd), and with it the XLA chunk scan of
// src/repro/models/ssm.py (_rwkv_chunk under lax.scan in rwkv_time_mix),
// which computes the same function.  Per head, S in R^{hs x hs}:
//
//   out_t = r_t @ (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Within a chunk of C steps the recurrence runs in parallel with the
// log-space factorisation of the reference: logD = cumsum(log w),
// logDm1 = logD - log w, and every decay factor is exp of a non-positive
// difference, never a ratio of cumulative products (with w clamped at
// 1e-8 a chunk's cumulative log reaches about -1180, and a ratio would
// overflow).  Per chunk:
//   out[q]  = (r[q] * D_{q-1}) S0
//           + sum_{d<q} (sum_c r[q,c] k[d,c] exp(min(logDm1[q,c] - logD[d,c], 0))) v[d]
//           + (r[q] . (u * k[q])) v[q]
//   S0     <- diag(D_C) S0 + sum_d (k[d] * exp(logD_C - logD[d]))^T v[d]
//
// Design.  The Pallas kernel walks (bh, chunk) in order, the state in VMEM
// scratch across the chunk sweep.  Here one block owns one (batch, head)
// and a slice of VS value columns, walks the chunks in a loop and keeps
// its hs x VS slice of the state in shared memory: the value columns of S
// and out are independent, so a small batch splits them across blocks
// (the intra-chunk matrix is recomputed per split).  The initial state may
// be given (the model carries it between calls); none means zeros, the
// Pallas kernel's init.  Inputs stay in the model's (B, T, H, hs) layout,
// so there is no transpose; a ragged last chunk is masked in the kernel
// (w = 1, r = k = v = 0: the state does not change), so there is no
// padding copy.  All arithmetic is float32 on the CUDA cores.
//
// Bound on an H100: operations.  The function itself needs the step
// recurrence's 5 hs^2 flops per (token, head) (2 hs^2 for r S, 3 hs^2 for
// diag(w) S + k v^T): at B = 8, T = 2048, H = 40, hs = 64 that is
// 13.4 GFLOP (0.20 ms at the 67 TFLOP/s float32 rate) against about 600 MB
// of traffic (0.18 ms at 3.35 TB/s).  The chunked form chosen here does
// more: per chunk and head about 2 C hs^2 (inter) + 5 C(C-1)/2 hs (intra
// matrix and its product with v) + 2 C hs^2 (state) flops, 17.4 GFLOP at
// that shape, and C(C-1)/2 hs exps of the pair decay, 1.3 G.  This first
// version reads its operands from shared memory for every product (no
// register tiling, no tensor cores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxHs = 64;
constexpr int kMaxChunk = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16(x);
}

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;  // (B, H, hs, hs) or null for zeros
  void* out;
  float* s_out;     // (B, H, hs, hs)
  int B, T, H, hs, chunk, vs;
};

// Floats of shared memory a block needs; rows are padded by one so that
// walks down a column do not collide on a bank.
__host__ __device__ constexpr int smem_floats(int hs, int C, int vs) {
  return 4 * C * (hs + 1) + C * (vs + 1) + C * (C + 1) + hs * (vs + 1) + 2 * hs + C;
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) wkv6_kernel(Params p) {
  extern __shared__ float smem[];
  const int hs = p.hs, C = p.chunk, VS = p.vs, T = p.T, H = p.H;
  const int ld = hs + 1, ldv = VS + 1, lda = C + 1;
  float* r_s = smem;            // (C, hs): r, then r * D_{q-1}
  float* k_s = r_s + C * ld;    // (C, hs): k, then k * exp(logD_C - logD)
  float* ld_s = k_s + C * ld;   // (C, hs): logD
  float* lm_s = ld_s + C * ld;  // (C, hs): log w, then logD_{q-1}
  float* v_s = lm_s + C * ld;   // (C, VS)
  float* a_s = v_s + C * ldv;   // (C, C): the strictly lower intra-chunk matrix
  float* S_s = a_s + C * lda;   // (hs, VS): the state's slice
  float* u_s = S_s + hs * ldv;  // (hs)
  float* dC_s = u_s + hs;       // (hs): D_C
  float* b_s = dC_s + hs;       // (C): the bonus diagonal

  const Tin* r = static_cast<const Tin*>(p.r);
  const Tin* k = static_cast<const Tin*>(p.k);
  const Tin* v = static_cast<const Tin*>(p.v);
  Tout* out = static_cast<Tout*>(p.out);
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * VS;
  const int tid = threadIdx.x;
  // element (b, t, h, c) of a (B, T, H, hs) tensor
  auto at = [&](int t, int c) { return (static_cast<size_t>(b) * T + t) * H * hs +
                                       static_cast<size_t>(h) * hs + c; };
  const size_t s_base = static_cast<size_t>(bh) * hs * hs;

  for (int i = tid; i < hs * VS; i += kThreads) {
    const int c = i / VS, j = i % VS;
    S_s[c * ldv + j] = p.s0 ? p.s0[s_base + static_cast<size_t>(c) * hs + v0 + j] : 0.f;
  }
  for (int c = tid; c < hs; c += kThreads) u_s[c] = p.u[h * hs + c];

  const int n_pairs = C * (C - 1) / 2;
  for (int t0 = 0; t0 < T; t0 += C) {
    // Load the chunk; steps past T are w = 1, r = k = v = 0.
    for (int i = tid; i < C * hs; i += kThreads) {
      const int q = i / hs, c = i % hs, t = t0 + q;
      const bool live = t < T;
      const size_t g = live ? at(t, c) : 0;
      r_s[q * ld + c] = live ? to_float(r[g]) : 0.f;
      k_s[q * ld + c] = live ? to_float(k[g]) : 0.f;
      lm_s[q * ld + c] = live ? logf(fminf(fmaxf(p.w[g], 1e-8f), 1.f)) : 0.f;
    }
    for (int i = tid; i < C * VS; i += kThreads) {
      const int q = i / VS, j = i % VS, t = t0 + q;
      v_s[q * ldv + j] = t < T ? to_float(v[at(t, v0 + j)]) : 0.f;
    }
    __syncthreads();

    // Cumulative logs down each channel, and the bonus diagonal.
    for (int c = tid; c < hs; c += kThreads) {
      float acc = 0.f;
      for (int q = 0; q < C; ++q) {
        const float lw = lm_s[q * ld + c];
        acc += lw;
        ld_s[q * ld + c] = acc;
        lm_s[q * ld + c] = acc - lw;
      }
    }
    for (int q = tid; q < C; q += kThreads) {
      float acc = 0.f;
      for (int c = 0; c < hs; ++c) acc += r_s[q * ld + c] * (u_s[c] * k_s[q * ld + c]);
      b_s[q] = acc;
    }
    __syncthreads();

    // The strictly lower intra-chunk matrix, one (q, d) pair per thread at
    // a time: pair index i = q (q - 1) / 2 + d, 0 <= d < q.
    for (int i = tid; i < n_pairs; i += kThreads) {
      int q = static_cast<int>((1.f + sqrtf(8.f * i + 1.f)) * 0.5f);
      while (q * (q - 1) / 2 > i) --q;
      while ((q + 1) * q / 2 <= i) ++q;
      const int d = i - q * (q - 1) / 2;
      const float* rq = r_s + q * ld;
      const float* mq = lm_s + q * ld;
      const float* kd = k_s + d * ld;
      const float* dd = ld_s + d * ld;
      float acc = 0.f;
      for (int c = 0; c < hs; ++c) acc += rq[c] * kd[c] * __expf(fminf(mq[c] - dd[c], 0.f));
      a_s[q * lda + d] = acc;
    }
    for (int c = tid; c < hs; c += kThreads) dC_s[c] = expf(ld_s[(C - 1) * ld + c]);
    __syncthreads();

    // r * D_{q-1} and k * exp(logD_C - logD), in place.
    for (int i = tid; i < C * hs; i += kThreads) {
      const int q = i / hs, c = i % hs;
      r_s[q * ld + c] *= expf(lm_s[q * ld + c]);
      k_s[q * ld + c] *= expf(ld_s[(C - 1) * ld + c] - ld_s[q * ld + c]);
    }
    __syncthreads();

    for (int i = tid; i < C * VS; i += kThreads) {
      const int q = i / VS, j = i % VS, t = t0 + q;
      float inter = 0.f, intra = 0.f;
      for (int c = 0; c < hs; ++c) inter += r_s[q * ld + c] * S_s[c * ldv + j];
      for (int d = 0; d < q; ++d) intra += a_s[q * lda + d] * v_s[d * ldv + j];
      if (t < T) put(out, at(t, v0 + j), inter + intra + b_s[q] * v_s[q * ldv + j]);
    }
    __syncthreads();

    for (int i = tid; i < hs * VS; i += kThreads) {
      const int c = i / VS, j = i % VS;
      float acc = 0.f;
      for (int d = 0; d < C; ++d) acc += k_s[d * ld + c] * v_s[d * ldv + j];
      S_s[c * ldv + j] = S_s[c * ldv + j] * dC_s[c] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < hs * VS; i += kThreads) {
    const int c = i / VS, j = i % VS;
    p.s_out[s_base + static_cast<size_t>(c) * hs + v0 + j] = S_s[c * ldv + j];
  }
}

template <typename Tin, typename Tout>
int launch(const Params& p, int splits, cudaStream_t stream) {
  static const cudaError_t granted = cudaFuncSetAttribute(
      wkv6_kernel<Tin, Tout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_floats(kMaxHs, kMaxChunk, kMaxHs) * sizeof(float)));
  if (granted != cudaSuccess) return static_cast<int>(granted);
  const size_t smem = smem_floats(p.hs, p.chunk, p.vs) * sizeof(float);
  const dim3 grid(p.B * p.H, splits, 1);
  wkv6_kernel<Tin, Tout><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_dtype (r, k, v) and out_dtype: 0 = float32, 1 = bfloat16; out_dtype 1
// needs in_dtype 1.  r, k, v, w, out (B, T, H, hs), u (H, hs), s0 and s_out
// (B, H, hs, hs), all contiguous; w, u, s0, s_out float32.  1 <= hs <= 64,
// 1 <= chunk <= 64, splits divides hs.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const float* w,
                           const float* u, const float* s0, void* out, float* s_out,
                           int in_dtype, int out_dtype, int B, int T, int H, int hs,
                           int chunk, int splits, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (hs < 1 || hs > kMaxHs || chunk < 1 || chunk > kMaxChunk || splits < 1 || hs % splits ||
      (out_dtype == 1 && in_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = u; p.s0 = s0; p.out = out; p.s_out = s_out;
  p.B = B; p.T = T; p.H = H; p.hs = hs; p.chunk = chunk; p.vs = hs / splits;
  if (in_dtype == 1) {
    return out_dtype == 1 ? launch<__nv_bfloat16, __nv_bfloat16>(p, splits, stream)
                          : launch<__nv_bfloat16, float>(p, splits, stream);
  }
  return launch<float, float>(p, splits, stream);
}
