// Chunked WKV6 recurrence (RWKV6 time-mix, data-dependent decay) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6/kernel.py
// (_wkv6_kernel, called by wkv6_fwd), and with it the XLA chunk scan of
// src/repro/models/ssm.py (_rwkv_chunk under lax.scan in rwkv_time_mix),
// which computes the same function.  Per head, S in R^{hs x hs}:
//
//   out_t = r_t @ (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Within a chunk of C = 64 steps, logD = cumsum(log w), logDm1 = logD - log w,
// and every decay factor is exp of a non-positive difference of cumulative
// logs, never a ratio (with w clamped at 1e-8 a chunk's cumulative log
// reaches about -1180).  Per chunk, from the state S0 that enters it:
//   out[q] = (r[q] * D_{q-1}) S0 + sum_{d<q} A[q,d] v[d] + (r[q] . (u * k[q])) v[q]
//   A[q,d] = sum_c r[q,c] k[d,c] exp(logDm1[q,c] - logD[d,c])
//   S0    <- diag(D_C) S0 + sum_d (k[d] * exp(logD_C - logD[d]))^T v[d]
//
// Design: two kernels, so that only the state is sequential.
//
// wkv6_states: grid (B H, value-column tiles of 32), eight warps.  A block
//   walks its head's chunks in order with its 64 x 32 slice of S in the
//   m16n8 accumulators of four warps (16 key rows each).  Per chunk it
//   stores the state that enters the chunk to a float32 scratch
//   (B, H, n_chunks, hs, hs), then S <- diag(D_C) S + (k * D_C / D)^T v on
//   tensor cores.  The chunk's two 32-step halves go to two sets of four
//   warps: each takes the running logs of its 16 channels over its half
//   (16-row segments joined by warp shuffles) and its half's product,
//   decayed to the half's last step; the upper half's product and decay
//   reach the state's warps through shared memory, so a chunk has two block
//   barriers.  The next chunk's k, w and v load by cp.async into the other
//   stage of a two-stage ring while this one computes.
// wkv6_outputs: grid (B H n_chunks), all independent, four warps, three
//   blocks an SM.  Warp i owns rows 16 i .. 16 i + 15 of the chunk
//   (sub-chunk i): inter part (r * D_{q-1}) S0 on tensor cores; intra part
//   by sub-chunk factorisation: for a key d in an earlier sub-chunk, with
//   ref = logD[16 i - 1], D_{q-1} / D_d = (D_{q-1} / D_ref) (D_ref / D_d),
//   both factors <= 1, so the blocks of A below the diagonal are one
//   tensor-core product (r * D_{q-1} / D_ref) (k * D_ref / D)^T per
//   sub-chunk.  Inside a sub-chunk its last 8 rows take its first 8 keys
//   the same way (ref = logD[16 i + 7]); only the two 8 x 8 blocks on the
//   diagonal keep exact pair decays (56 pairs a sub-chunk against 120),
//   the bonus term on the diagonal.  Then A V on tensor cores, and out is
//   written once.  The state's tile and A share shared memory.
//
// Every tensor-core product is 3xTF32 (mma.sync m16n8k8): each float32
// operand splits into a TF32 high part and a TF32 remainder, and the sum of
// three products keeps float32-order error (plain TF32's 10-bit mantissa
// gives errors of order 1e-2 on a 64-term r S).  A bf16 operand is exact in
// TF32, and then its remainder product is skipped.  Cumulative logs are
// kept in base 2 for the special-function unit's ex2.
//
// Inputs stay in the model's (B, T, H, hs) layout.  A ragged last chunk is
// masked in the kernels (w = 1, r = k = v = 0: the state does not change);
// a head size below 64 is zero-padded to 64 in shared memory.
//
// Bound on an H100: bytes.  The function needs the step recurrence's 5 hs^2
// + 5 hs flops per (token, head), 13.6 GFLOP at B = 8, T = 2048, H = 40,
// hs = 64 (0.083 ms at 3xTF32's 165 TFLOP/s), against about 600 MB of
// inputs and outputs (0.178 ms at 3.35 TB/s).  The pair also writes the
// per-chunk states and reads them back (2 x 168 MB at that shape).  The
// states kernel is bound by the latency of its chunk loop at small batch;
// the outputs kernel by its instructions, its loads overlapping compute only
// across its blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kChunk = 64;     // steps of a chunk
constexpr int kHs = 64;        // head size the tiles are padded to
constexpr int kSub = 16;       // rows of a sub-chunk: one warp's rows in wkv6_outputs
constexpr int kVs = 32;        // value columns of a wkv6_states block
constexpr int kStateThreads = 256;  // eight warps in wkv6_states
constexpr int kOutThreads = 128;    // four in wkv6_outputs

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16(x);
}

// Four consecutive values from shared memory (8- or 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x on the special-function unit (relative error about 2^-22); the
// kernels keep their cumulative logs in base 2 for it.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 3xTF32 operands: x = hi + lo, both TF32.
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  Split s;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(s.hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(s.lo) : "f"(x - __uint_as_float(s.hi)));
  return s;
}
// A value read from bf16 is already a TF32 value: no remainder.
__device__ __forceinline__ Split split(__nv_bfloat16 x) {
  return Split{__float_as_uint(__bfloat162float(x)), 0u};
}
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// d += a b for one m16n8k8 step (a: rows g, g + 8 by columns t, t + 4; b:
// rows t, t + 4 of column g), in 3xTF32; b_exact skips the product with b's
// remainder, which is zero for a bf16 operand.
template <bool b_exact>
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4], const Split (&b)[2]) {
  mma(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  if (!b_exact) mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
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
  float* states;    // (B, H, n_chunks, hs, hs): the state entering each chunk
  int B, T, H, hs, n_chunks;
  bool vec_in, vec_w, vec_s;  // 16-byte rows: cp.async, else plain loads
};

// Rows [0, 64) of a tile of at most kCols columns: row q is
// src[q * stride + (0 .. ncols)], zeros from row `live_rows` on; columns
// past ncols are left as they are.
template <int kThreads, int kCols, typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, size_t stride,
                                          int live_rows, int ncols, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T), kSegs = kCols / kPer;
    for (int i = threadIdx.x; i < kChunk * kSegs; i += kThreads) {
      const int q = i / kSegs, c = i % kSegs * kPer;
      const bool live = q < live_rows;
      if (c < ncols) cp_async16(dst + q * ld + c, live ? src + q * stride + c : src, live);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * kCols; i += kThreads) {
      const int q = i / kCols, c = i % kCols;
      if (c < ncols) dst[q * ld + c] = q < live_rows ? src[q * stride + c] : T{};
    }
  }
}

// Running base-2 logs of w over 16 rows q0 .. q0 + 15 of channel c, in
// place in L (w on entry; rows past live_rows and channels past hs count as
// w = 1); returns the 16 rows' sum.  __log2f's absolute error (about
// 2^-22) is of the order of the float32 rounding of the sums themselves.
__device__ __forceinline__ float cumsum16(float* L, int ld, int c, int q0, int live_rows,
                                          int hs) {
  float run = 0.f;
#pragma unroll
  for (int i0 = 0; i0 < 16; i0 += 8) {
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = L[(q0 + i0 + i) * ld + c];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = q0 + i0 + i;
      run += q < live_rows && c < hs ? __log2f(fminf(fmaxf(x[i], 1e-8f), 1.f)) : 0.f;
      L[q * ld + c] = run;
    }
  }
  return run;
}

template <typename Tin>
struct StatesSmem {
  // Row strides for conflict-free fragment reads.
  static constexpr int kLdK = 72, kLdW = 72, kLdV = 40;
  struct Stage {
    Tin k[kChunk * kLdK];
    float w[kChunk * kLdW];  // w, then running base-2 logs within each 16-row segment
    Tin v[kChunk * kLdV];
  } stage[2];
  float part[4][kVs / 8][4][32];  // the upper half's product, fragment by fragment
  float total[kHs];               // log2 of the upper half's decay, per channel
};

// Eight warps.  Warp w owns channels 16 (w % 4) .. + 15 (the state's rows)
// and the steps of half w / 4 of the chunk: its running logs, and the
// product over those steps.  The lower half's warps keep the state.
template <typename Tin>
__global__ void __launch_bounds__(kStateThreads, 2) wkv6_states(Params p) {
  using Sm = StatesSmem<Tin>;
  using Stage = typename Sm::Stage;
  constexpr bool kExact = sizeof(Tin) == 2;
  constexpr int kN = kVs / 8;  // n-tiles of the slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int hs = p.hs, T = p.T, H = p.H, n_chunks = p.n_chunks;
  const int tiles = (hs + kVs - 1) / kVs;
  const int bh = blockIdx.x / tiles, j0 = blockIdx.x % tiles * kVs;
  const int ncols = min(kVs, hs - j0);
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int cg = warp % 4, half = warp / 4;
  const size_t stride = static_cast<size_t>(H) * hs;
  const size_t head = (static_cast<size_t>(b) * T * H + h) * hs;  // element (b, 0, h, 0)
  const Tin* k = static_cast<const Tin*>(p.k) + head;
  const Tin* v = static_cast<const Tin*>(p.v) + head + j0;
  const float* w = p.w + head;

  if (hs < kHs) {  // padded channels and columns stay zero
    for (int i = threadIdx.x; i < static_cast<int>(sizeof(Sm)) / 4; i += kStateThreads)
      reinterpret_cast<float*>(smem_raw)[i] = 0.f;
    __syncthreads();
  }

  // The state's slice (lower-half warps): rows c0 = 16 cg + g and c1 = c0 + 8,
  // columns j0 + 8 n + 2 t + {0, 1}.
  const int c0 = kSub * cg + g, c1 = c0 + 8;
  const size_t s_base = static_cast<size_t>(bh) * hs * hs;
  float acc[kN][4];
#pragma unroll
  for (int nn = 0; nn < kN; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e < 2 ? c0 : c1, j = j0 + 8 * nn + 2 * t + (e & 1);
      acc[nn][e] = half == 0 && p.s0 && c < hs && j < hs
                       ? p.s0[s_base + static_cast<size_t>(c) * hs + j] : 0.f;
    }

  auto issue = [&](int n) {
    if (n < n_chunks) {
      Stage& s = sm.stage[n & 1];
      // The row stride, opaque to the compiler: per-row addresses are then
      // recomputed for each chunk, not held in registers across the loop.
      size_t st = stride;
      asm volatile("" : "+l"(st));
      const size_t off = static_cast<size_t>(n) * kChunk * st;
      const int live = min(kChunk, T - n * kChunk);
      load_rows<kStateThreads, kHs>(s.k, Sm::kLdK, k + off, st, live, hs, p.vec_in);
      load_rows<kStateThreads, kHs>(s.w, Sm::kLdW, w + off, st, live, hs, p.vec_w);
      load_rows<kStateThreads, kVs>(s.v, Sm::kLdV, v + off, st, live, ncols, p.vec_in);
    }
    cp_async_commit();
  };

  issue(0);
  for (int n = 0; n < n_chunks; ++n) {
    cp_async_wait<0>();
    __syncthreads();  // chunk n landed for every thread; chunk n - 1's stage is free
    issue(n + 1);
    Stage& s = sm.stage[n & 1];
    const int live = min(kChunk, T - n * kChunk);

    // Lane l: channel 16 cg + l % 16, rows 32 half + 16 (l / 16) .. + 15.
    const int q0 = 32 * half;
    const float run = cumsum16(s.w, Sm::kLdW, kSub * cg + (lane & 15), q0 + 16 * (lane >> 4),
                               live, hs);
    __syncwarp();
    // Per fragment row: the half's first and second 16-row sums.
    const float lo0 = __shfl_sync(0xffffffffu, run, g), hi0 = __shfl_sync(0xffffffffu, run, g + 16);
    const float lo1 = __shfl_sync(0xffffffffu, run, g + 8), hi1 = __shfl_sync(0xffffffffu, run, g + 24);

    // Lower half: store the state entering chunk n, then scale it by
    // D[31] = 2^(lo + hi).  Upper half: start its product from zero.
    float* dst = p.states + (static_cast<size_t>(bh) * n_chunks + n) * hs * hs;
    const float d0 = exp2_fast(lo0 + hi0), d1 = exp2_fast(lo1 + hi1);
#pragma unroll
    for (int nn = 0; nn < kN; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e < 2 ? c0 : c1, j = j0 + 8 * nn + 2 * t + (e & 1);
        if (half == 0 && c < hs && j < hs) dst[static_cast<size_t>(c) * hs + j] = acc[nn][e];
        acc[nn][e] = half == 0 ? acc[nn][e] * (e < 2 ? d0 : d1) : 0.f;
      }

    // += this half's product sum_q (k[q] * D_end / D[q])^T v[q], D_end the
    // decay through the half's last row: 2^(lo + hi - run[q]) in its first
    // 16 rows, 2^(hi - run[q]) in its second; every exponent <= 0.  A is
    // (channel, step), B (step, column).
#pragma unroll 1
    for (int kk = 0; kk < 4; ++kk) {
      const float e0 = kk < 2 ? lo0 + hi0 : hi0, e1 = kk < 2 ? lo1 + hi1 : hi1;
      Split a[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int q = q0 + 8 * kk + t + (x >= 2 ? 4 : 0), c = (x & 1) ? c1 : c0;
        const float ex = (x & 1) ? e1 : e0;
        a[x] = split(to_float(s.k[q * Sm::kLdK + c]) * exp2_fast(ex - s.w[q * Sm::kLdW + c]));
      }
#pragma unroll
      for (int nn = 0; nn < kN; ++nn) {
        const int j = 8 * nn + g, q = q0 + 8 * kk + t;
        const Split bv[2] = {split(s.v[q * Sm::kLdV + j]), split(s.v[(q + 4) * Sm::kLdV + j])};
        mma3<kExact>(acc[nn], a, bv);
      }
    }
    if (half == 1) {
#pragma unroll
      for (int nn = 0; nn < kN; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sm.part[cg][nn][e][lane] = acc[nn][e];
      const float sum = run + __shfl_down_sync(0xffffffffu, run, 16);
      if (lane < 16) sm.total[kSub * cg + lane] = sum;
    }
    __syncthreads();
    if (half == 0) {
      // S <- 2^total (D[31] S + lower) + upper: the decay through the upper
      // half is 2^total of its logs.
      const float f0 = exp2_fast(sm.total[c0]), f1 = exp2_fast(sm.total[c1]);
#pragma unroll
      for (int nn = 0; nn < kN; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nn][e] = acc[nn][e] * (e < 2 ? f0 : f1) + sm.part[cg][nn][e][lane];
    }
  }

  if (half == 0) {
#pragma unroll
    for (int nn = 0; nn < kN; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e < 2 ? c0 : c1, j = j0 + 8 * nn + 2 * t + (e & 1);
        if (c < hs && j < hs) p.s_out[s_base + static_cast<size_t>(c) * hs + j] = acc[nn][e];
      }
  }
}

template <typename Tin>
struct OutSmem {
  // Row strides for conflict-free fragment reads: r and k are read as
  // (row g, column t), v and S as (row t, column g).
  static constexpr int kLdRK = sizeof(Tin) == 2 ? 72 : 68, kLdV = 72, kLdL = 68, kLdS = 72,
                       kLdA = 68;
  Tin r[kChunk * kLdRK];
  Tin k[kChunk * kLdRK];
  Tin v[kChunk * kLdV];
  float L[kChunk * kLdL];  // w, then log2 D
  union {
    float S[kHs * kLdS];     // the state entering the chunk, until the inter part is done
    float A[kChunk * kLdA];  // then the intra-chunk matrix, the bonus term on its diagonal
  };
  float u[kHs];
};

// (row, column) of item i of the 8 x 8 blocks on a 16 x 16 block's
// diagonal: items 0..55 walk the strictly lower triangles of the two row by
// row, 56..71 the diagonal.
__device__ __forceinline__ void diagonal_item(int i, int& q, int& d) {
  if (i >= 56) {
    q = d = i - 56;
    return;
  }
  const int base = i < 28 ? 0 : 8;
  q = 1;
  d = i % 28;
  while (d >= q) d -= q++;
  q += base;
  d += base;
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kOutThreads, 3) wkv6_outputs(Params p) {
  using Sm = OutSmem<Tin>;
  constexpr bool kExact = sizeof(Tin) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int hs = p.hs, T = p.T, H = p.H, n_chunks = p.n_chunks;
  const int n = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks;
  const int b = bh / H, h = bh % H, t0 = n * kChunk;
  const int live = min(kChunk, T - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t stride = static_cast<size_t>(H) * hs;
  const size_t first = (static_cast<size_t>(b) * T + t0) * stride + static_cast<size_t>(h) * hs;

  if (hs < kHs) {
    for (int i = threadIdx.x; i < static_cast<int>(sizeof(Sm)) / 4; i += kOutThreads)
      reinterpret_cast<float*>(smem_raw)[i] = 0.f;
    __syncthreads();
  }
  const Tin* r = static_cast<const Tin*>(p.r) + first;
  const Tin* k = static_cast<const Tin*>(p.k) + first;
  const Tin* v = static_cast<const Tin*>(p.v) + first;
  load_rows<kOutThreads, kHs>(sm.r, Sm::kLdRK, r, stride, live, hs, p.vec_in);
  load_rows<kOutThreads, kHs>(sm.k, Sm::kLdRK, k, stride, live, hs, p.vec_in);
  load_rows<kOutThreads, kHs>(sm.L, Sm::kLdL, p.w + first, stride, live, hs, p.vec_w);
  cp_async_commit();
  load_rows<kOutThreads, kHs>(sm.v, Sm::kLdV, v, stride, live, hs, p.vec_in);
  load_rows<kOutThreads, kHs>(sm.S, Sm::kLdS, p.states + (static_cast<size_t>(bh) * n_chunks + n) * hs * hs,
                 hs, hs, hs, p.vec_s);
  cp_async_commit();
  for (int c = threadIdx.x; c < hs; c += kOutThreads) sm.u[c] = p.u[h * hs + c];
  cp_async_wait<1>();
  __syncthreads();
  // log2 D: warp w takes channels 16 w .. + 15 in two passes of 8; lane l
  // channel l % 8 of the pass over rows 16 (l / 8) .. + 15, then adds the
  // earlier segments' sums.
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int c = kSub * warp + 8 * pass + (lane & 7), seg = lane >> 3;
    const float run = cumsum16(sm.L, Sm::kLdL, c, 16 * seg, live, hs);
    const float s0 = __shfl_sync(0xffffffffu, run, lane & 7);
    const float s1 = __shfl_sync(0xffffffffu, run, (lane & 7) + 8);
    const float s2 = __shfl_sync(0xffffffffu, run, (lane & 7) + 16);
    const float off = seg == 0 ? 0.f : seg == 1 ? s0 : seg == 2 ? s0 + s1 : s0 + s1 + s2;
    if (seg > 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) sm.L[(16 * seg + i) * Sm::kLdL + c] += off;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int m0 = kSub * warp;  // this warp's rows: sub-chunk `warp`
  // log2 D_{q-1} (D_{-1} = 1), r and k as float
  auto ldm1 = [&](int q, int c) { return q ? sm.L[(q - 1) * Sm::kLdL + c] : 0.f; };
  auto r_at = [&](int q, int c) { return to_float(sm.r[q * Sm::kLdRK + c]); };
  auto k_at = [&](int q, int c) { return to_float(sm.k[q * Sm::kLdRK + c]); };

  // Inter-chunk part: out = (r * D_{q-1}) S0.
  float o[8][4];
#pragma unroll
  for (int nn = 0; nn < 8; ++nn) o[nn][0] = o[nn][1] = o[nn][2] = o[nn][3] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kHs / 8; ++kk) {
    Split a[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int q = m0 + g + ((x & 1) ? 8 : 0), c = 8 * kk + t + (x >= 2 ? 4 : 0);
      a[x] = split(r_at(q, c) * exp2_fast(ldm1(q, c)));
    }
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const int c = 8 * kk + t, j = 8 * nn + g;
      const Split bs[2] = {split(sm.S[c * Sm::kLdS + j]), split(sm.S[(c + 4) * Sm::kLdS + j])};
      mma3<false>(o[nn], a, bs);
    }
  }
  __syncthreads();  // S is read by every warp; A takes its place

  // Off-diagonal blocks of A (keys d < m0), with ref = log2 D[m0 - 1]:
  // (r * D_{q-1} / D_ref) (k * D_ref / D_d)^T, both factors <= 1.
  if (warp > 0) {
    float a2[6][4];
#pragma unroll
    for (int nn = 0; nn < 6; ++nn) a2[nn][0] = a2[nn][1] = a2[nn][2] = a2[nn][3] = 0.f;
    const float* ref = sm.L + (m0 - 1) * Sm::kLdL;
#pragma unroll 2
    for (int kk = 0; kk < kHs / 8; ++kk) {
      const int ct = 8 * kk + t;
      const float ref_lo = ref[ct], ref_hi = ref[ct + 4];
      Split a[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int q = m0 + g + ((x & 1) ? 8 : 0), c = ct + (x >= 2 ? 4 : 0);
        a[x] = split(r_at(q, c) * exp2_fast(ldm1(q, c) - (x >= 2 ? ref_hi : ref_lo)));
      }
#pragma unroll
      for (int nn = 0; nn < 6; ++nn) {
        if (nn < 2 * warp) {
          const int d = 8 * nn + g;
          const Split bk[2] = {
              split(k_at(d, ct) * exp2_fast(ref_lo - sm.L[d * Sm::kLdL + ct])),
              split(k_at(d, ct + 4) * exp2_fast(ref_hi - sm.L[d * Sm::kLdL + ct + 4]))};
          mma3<false>(a2[nn], a, bk);
        }
      }
    }
#pragma unroll
    for (int nn = 0; nn < 6; ++nn) {
      if (nn < 2 * warp) {
        float* row0 = sm.A + (m0 + g) * Sm::kLdA + 8 * nn + 2 * t;
        float* row1 = row0 + 8 * Sm::kLdA;
        *reinterpret_cast<float2*>(row0) = make_float2(a2[nn][0], a2[nn][1]);
        *reinterpret_cast<float2*>(row1) = make_float2(a2[nn][2], a2[nn][3]);
      }
    }
  }

  // Diagonal block.  Rows 8..15 against keys 0..7 are one more factorised
  // product, with ref = log2 D[m0 + 7], on tensor cores (the fragment's
  // rows 0..7 stay zero); the two 8 x 8 blocks on the diagonal take exact
  // pair decays, item by item over the lanes, the bonus r[q] . (u * k[q]) on
  // the diagonal; zeros above it.
#pragma unroll
  for (int i = 0; i < 8; ++i) sm.A[(m0 + 2 * i + (lane >> 4)) * Sm::kLdA + m0 + (lane & 15)] = 0.f;
  __syncwarp();
  {
    const float* ref = sm.L + (m0 + 7) * Sm::kLdL;
    const int q = m0 + 8 + g, d = m0 + g;
    float a8[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int kk = 0; kk < kHs / 8; ++kk) {
      const int ct = 8 * kk + t;
      const float ref_lo = ref[ct], ref_hi = ref[ct + 4];
      const Split zero{0u, 0u};
      const Split a[4] = {zero, split(r_at(q, ct) * exp2_fast(ldm1(q, ct) - ref_lo)), zero,
                          split(r_at(q, ct + 4) * exp2_fast(ldm1(q, ct + 4) - ref_hi))};
      const Split bk[2] = {split(k_at(d, ct) * exp2_fast(ref_lo - sm.L[d * Sm::kLdL + ct])),
                           split(k_at(d, ct + 4) * exp2_fast(ref_hi - sm.L[d * Sm::kLdL + ct + 4]))};
      mma3<false>(a8, a, bk);
    }
    *reinterpret_cast<float2*>(sm.A + q * Sm::kLdA + m0 + 2 * t) = make_float2(a8[2], a8[3]);
  }
  for (int i = lane; i < 72; i += 32) {
    int ql, dl;
    diagonal_item(i, ql, dl);
    const int q = m0 + ql, d = m0 + dl;
    const Tin* rq = sm.r + q * Sm::kLdRK;
    const Tin* kd = sm.k + d * Sm::kLdRK;
    float acc = 0.f;
    if (ql == dl) {
#pragma unroll 4
      for (int c = 0; c < kHs; c += 4) {
        const float4 x = load4(rq + c), y = load4(kd + c), z = load4(sm.u + c);
        acc += x.x * y.x * z.x + x.y * y.y * z.y + x.z * y.z * z.z + x.w * y.w * z.w;
      }
    } else {
      const float* mq = sm.L + (q - 1) * Sm::kLdL;  // q > d >= 0
      const float* ld = sm.L + d * Sm::kLdL;
#pragma unroll 4
      for (int c = 0; c < kHs; c += 4) {
        const float4 x = load4(rq + c), y = load4(kd + c), m = load4(mq + c), l = load4(ld + c);
        acc += x.x * y.x * exp2_fast(m.x - l.x) + x.y * y.y * exp2_fast(m.y - l.y) +
               x.z * y.z * exp2_fast(m.z - l.z) + x.w * y.w * exp2_fast(m.w - l.w);
      }
    }
    sm.A[q * Sm::kLdA + d] = acc;
  }
  __syncwarp();

  // Intra-chunk part and bonus: out += A V over keys d < m0 + 16.
  for (int kk = 0; kk < 2 * (warp + 1); ++kk) {
    Split a[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int q = m0 + g + ((x & 1) ? 8 : 0), d = 8 * kk + t + (x >= 2 ? 4 : 0);
      a[x] = split(sm.A[q * Sm::kLdA + d]);
    }
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const int d = 8 * kk + t, j = 8 * nn + g;
      const Split bv[2] = {split(sm.v[d * Sm::kLdV + j]), split(sm.v[(d + 4) * Sm::kLdV + j])};
      mma3<kExact>(o[nn], a, bv);
    }
  }

  Tout* out = static_cast<Tout*>(p.out) + first;
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = m0 + g + (e < 2 ? 0 : 8), j = 8 * nn + 2 * t + (e & 1);
      if (q < live && j < hs) put(out, static_cast<size_t>(q) * stride + j, o[nn][e]);
    }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename Tin, typename Tout>
int launch(const Params& p, cudaStream_t stream) {
  static const cudaError_t granted = [] {
    cudaError_t e = cudaFuncSetAttribute(wkv6_states<Tin>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(StatesSmem<Tin>)));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(wkv6_outputs<Tin, Tout>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(sizeof(OutSmem<Tin>)));
  }();
  if (granted != cudaSuccess) return static_cast<int>(granted);
  const int tiles = (p.hs + kVs - 1) / kVs;
  wkv6_states<Tin><<<p.B * p.H * tiles, kStateThreads, sizeof(StatesSmem<Tin>), stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.n_chunks == 0) return static_cast<int>(e);
  wkv6_outputs<Tin, Tout>
      <<<p.B * p.H * p.n_chunks, kOutThreads, sizeof(OutSmem<Tin>), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_dtype (r, k, v) and out_dtype: 0 = float32, 1 = bfloat16; out_dtype 1
// needs in_dtype 1.  r, k, v, w, out (B, T, H, hs), u (H, hs), s0 and s_out
// (B, H, hs, hs), states (B, H, ceil(T / 64), hs, hs), all contiguous; w, u,
// s0, s_out and states float32.  1 <= hs <= 64; `states_chunks` is the
// scratch's chunk count, which must be ceil(T / 64).  Launches wkv6_states,
// then (T > 0) wkv6_outputs, on `stream`.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const float* w,
                           const float* u, const float* s0, void* out, float* s_out,
                           float* states, int states_chunks, int in_dtype, int out_dtype,
                           int B, int T, int H, int hs, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (hs < 1 || hs > kHs || T < 0 || (out_dtype == 1 && in_dtype != 1) ||
      states_chunks != (T + kChunk - 1) / kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = u; p.s0 = s0; p.out = out; p.s_out = s_out;
  p.states = states;
  p.B = B; p.T = T; p.H = H; p.hs = hs; p.n_chunks = (T + kChunk - 1) / kChunk;
  const int per = in_dtype == 1 ? 8 : 4;  // elements in 16 bytes
  p.vec_in = hs % per == 0 && aligned16(r) && aligned16(k) && aligned16(v);
  p.vec_w = hs % 4 == 0 && aligned16(w);
  p.vec_s = hs % 4 == 0 && aligned16(states);
  if (in_dtype == 1) {
    return out_dtype == 1 ? launch<__nv_bfloat16, __nv_bfloat16>(p, stream)
                          : launch<__nv_bfloat16, float>(p, stream);
  }
  return launch<float, float>(p, stream);
}
