// What the flash_attention and decode_attention kernels share, and their
// float32 tile.
//
// Both kernels compute, for the query rows of one KV head, an online-softmax
// attention over that head's keys:
//
//   s = (q . k) * scale, masked to -1e30 where the key is not visible;
//   m, l, acc in float32, rescaled per key tile; out = acc / max(l, 1e-30).
//
// Rows.  Row r of the G * Sq rows of one (batch, kv head) pair is
// (g = r / Sq, qi = r % Sq), query head h = kv_head * G + g, the order of
// the Pallas decode kernel.  A key at position kpos is visible to row r iff
// kpos < key_end and, when causal, kpos <= q_offset + qi.  Flash attention
// uses q_offset = 0 (qpos >= kpos from position 0); decode uses
// q_offset = kv_len - Sq and key_end = min(S_max, kv_len).  A block may
// take only a split of the keys (split-K flash-decoding): then it writes
// its unnormalised acc and (m, l) to float32 partials (m in natural-log
// units), and a combine pass finishes the rows.  Masked probabilities are
// exactly 0 (not exp(0) for a row with every key masked so far), so a row
// with no visible key gives 0, not NaN.
//
// The bfloat16 tile is the Hopper one (attention_hopper.cuh).  The float32
// tile here runs on the CUDA cores and exists to hold the algorithm against
// the plain version at float32 tolerance; no model path on the card runs
// it.  A block takes kRows = 64 query rows, four warps of 16 rows, and
// walks tiles of keys_f32<HD>() keys (64, or 32 at head_dim 256) staged in
// shared memory by cp.async, two stages deep, K and V together; keys past
// the block's last visible key are never loaded, rows and head dims past
// the tensor's edge are zero-filled (cp.async's zero-fill).  Products are
// float32 FMAs on register fragments laid out as the m16n8 accumulator of
// mma.sync.  A block holds (64 + 4 * keys) rows of hd + 4 floats in shared
// memory: 85 KB at head_dim 64, 165 KB at 128, 195 KB at 256 (64-key tiles
// there would need 325 KB).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attention_tile {

constexpr int kRows = 64;   // query rows per float32 block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHD = 256;  // head dims up to 256; row width of the partials
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;     // (B, Sq, n_kv * G, hd)
  const void* k;     // (B, Sk, n_kv, hd)
  const void* v;     // (B, Sk, n_kv, hd)
  void* o;           // (B, Sq, n_kv * G, hd), written when n_splits == 1
  float* part_acc;   // (n_splits, B * n_kv, G * Sq, kMaxHD) when n_splits > 1
  float* part_ml;    // (n_splits, B * n_kv, G * Sq, 2)  when n_splits > 1
  int B, Sq, Sk, n_kv, G, hd;
  int key_end;       // keys [0, key_end) may be visible
  int causal;        // mask kpos <= q_offset + qi
  int q_offset;
  int n_splits;
  int split_keys;    // keys per split, a multiple of both tiles' keys at this hd
  float scale;
};

// The keys a block of rows [r0, r0 + rows) needs, [k_lo, k_hi), and the
// first key not visible to every one of them, full_until.
struct KeyRange {
  int k_lo, k_hi, full_until;
};

__host__ __device__ inline KeyRange key_range(const Params& p, int r0, int rows, int split) {
  const int n_rows = p.G * p.Sq;
  const int r_last = (r0 + rows < n_rows ? r0 + rows : n_rows) - 1;
  const bool spans = r0 / p.Sq != r_last / p.Sq;
  const int max_qi = spans ? p.Sq - 1 : r_last % p.Sq;
  const int min_qi = spans ? 0 : r0 % p.Sq;
  KeyRange kr;
  kr.k_lo = split * p.split_keys;
  kr.k_hi = kr.k_lo + p.split_keys < p.key_end ? kr.k_lo + p.split_keys : p.key_end;
  kr.full_until = p.key_end;
  if (p.causal) {
    const int hi = p.q_offset + max_qi + 1, full = p.q_offset + min_qi + 1;
    kr.k_hi = kr.k_hi < hi ? kr.k_hi : hi;
    kr.full_until = kr.full_until < full ? kr.full_until : full;
  }
  return kr;
}

// Element offset of row r's query (and output) in (B, Sq, Hq, hd).
__device__ __forceinline__ long long row_offset(const Params& p, int b, int kvh, int r) {
  const int g = r / p.Sq, qi = r % p.Sq;
  return ((static_cast<long long>(b) * p.Sq + qi) * (p.n_kv * p.G) + kvh * p.G + g) * p.hd;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
__host__ __device__ constexpr int row_stride() {  // shared-memory row, padded 16 B against bank conflicts
  return HD + 4;
}

template <int HD>
__host__ __device__ constexpr int keys_f32() {  // keys per float32 tile
  return HD == 256 ? 32 : 64;
}

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(kRows + 4 * keys_f32<HD>()) * row_stride<HD>() * sizeof(float);
}
static_assert(smem_bytes<256>() <= 232448, "shared memory of one block on an H100");

// One float32 block: kRows query rows of one (batch, kv head), one split of
// keys.  kSplit compiles in the partial-output path (decode only).
template <int HD, bool kSplit>
__device__ __forceinline__ void attention_block_f32(const Params& p) {
  constexpr int LD = row_stride<HD>();
  constexpr int kKeys = keys_f32<HD>();
  constexpr int CH = 4;          // floats per 16 B chunk
  constexpr int CPR = HD / CH;   // chunks per row
  constexpr int NT = kKeys / 8;  // n8 tiles of S
  constexpr int NO = HD / 8;     // n8 tiles of O

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kRows * LD;     // [2][kKeys][LD]
  float* Vs = Ks + 2 * kKeys * LD;  // [2][kKeys][LD]

  const float* __restrict__ q = static_cast<const float*>(p.q);
  const float* __restrict__ k = static_cast<const float*>(p.k);
  const float* __restrict__ v = static_cast<const float*>(p.v);

  const int n_rows = p.G * p.Sq;
  const int n_row_tiles = (n_rows + kRows - 1) / kRows;
  // Causal blocks with the most keys first: the last row tile is the heaviest.
  const int r0 = (n_row_tiles - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int b = blockIdx.y / p.n_kv;
  const int kvh = blockIdx.y % p.n_kv;
  const int split = blockIdx.z;
  const KeyRange kr = key_range(p, r0, kRows, split);
  const int k_lo = kr.k_lo, k_hi = kr.k_hi;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;  // fragment row
  const int t4 = lane % 4;  // fragment column pair
  const bool warp_live = r0 + warp * 16 < n_rows;

  // Rows of this lane's fragments: a = g4, b = g4 + 8 within the warp's 16.
  const int ra = r0 + warp * 16 + g4;
  const int rb = ra + 8;
  const int lim_a = p.causal ? p.q_offset + ra % p.Sq : 0x7fffffff;
  const int lim_b = p.causal ? p.q_offset + rb % p.Sq : 0x7fffffff;

  const long long kv_row = static_cast<long long>(p.n_kv) * p.hd;  // K/V stride per key
  const float* kbase = k + (static_cast<long long>(b) * p.Sk * p.n_kv + kvh) * p.hd;
  const float* vbase = v + (static_cast<long long>(b) * p.Sk * p.n_kv + kvh) * p.hd;

  // --- start the copies of the Q tile, then K/V tile 0 ------------------
  for (int idx = threadIdx.x; idx < kRows * CPR; idx += kThreads) {
    const int row = idx / CPR, c = idx % CPR;
    const int r = r0 + row;
    const bool ok = r < n_rows && c * CH < p.hd;
    cp_async16(Qs + row * LD + c * CH, ok ? q + row_offset(p, b, kvh, r) + c * CH : q, ok);
  }
  cp_async_commit();

  auto load_kv = [&](int tile, int stage) {
    const int kt = k_lo + tile * kKeys;
    float* ks = Ks + stage * kKeys * LD;
    float* vs = Vs + stage * kKeys * LD;
    for (int idx = threadIdx.x; idx < kKeys * CPR; idx += kThreads) {
      const int row = idx / CPR, c = idx % CPR;
      const int key = kt + row;
      const bool ok = key < k_hi && c * CH < p.hd;
      const long long off = ok ? key * kv_row + c * CH : 0;
      cp_async16(ks + row * LD + c * CH, kbase + off, ok);
      cp_async16(vs + row * LD + c * CH, vbase + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile `it` have landed
    __syncthreads();

    const float* ks = Ks + (it & 1) * kKeys * LD;
    const float* vs = Vs + (it & 1) * kKeys * LD;
    const int kt = k_lo + it * kKeys;

    if (warp_live) {
      // ---- S = Q K^T for this warp's 16 rows x kKeys keys -------------
      float s[NT][4];
      const float* qa = Qs + (warp * 16 + g4) * LD;
      const float* qb = qa + 8 * LD;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* k0 = ks + (j * 8 + t4 * 2) * LD;
        const float* k1 = k0 + LD;
        float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
        for (int d = 0; d < HD; ++d) {
          const float xa = qa[d], xb = qb[d], y0 = k0[d], y1 = k1[d];
          a0 = fmaf(xa, y0, a0);
          a1 = fmaf(xa, y1, a1);
          b0 = fmaf(xb, y0, b0);
          b1 = fmaf(xb, y1, b1);
        }
        s[j][0] = a0; s[j][1] = a1; s[j][2] = b0; s[j][3] = b1;
      }

      // ---- scale, mask, online softmax ---------------------------------
      const bool need_mask = kt + kKeys > kr.full_until;
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[j][c] * p.scale;
          if (need_mask) {
            const int key = kt + j * 8 + t4 * 2 + (c & 1);
            const int lim = c < 2 ? lim_a : lim_b;
            if (key >= p.key_end || key > lim) x = kNegInf;
          }
          s[j][c] = x;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float mn = c < 2 ? mn_a : mn_b;
          s[j][c] = s[j][c] == kNegInf ? 0.f : expf(s[j][c] - mn);
        }
        sum_a += s[j][0] + s[j][1];
        sum_b += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, sh);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, sh);
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= corr_a; o[n][1] *= corr_a;
        o[n][2] *= corr_b; o[n][3] *= corr_b;
      }

      // ---- O += P V ------------------------------------------------------
      const int quad = lane & ~3;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int src = 0; src < 4; ++src) {
            const float pa = __shfl_sync(0xffffffffu, s[j][c], quad | src);
            const float pb = __shfl_sync(0xffffffffu, s[j][2 + c], quad | src);
            const float* vr = vs + (j * 8 + src * 2 + c) * LD + t4 * 2;
#pragma unroll
            for (int n = 0; n < NO; ++n) {
              const float v0 = vr[n * 8], v1 = vr[n * 8 + 1];
              o[n][0] = fmaf(pa, v0, o[n][0]);
              o[n][1] = fmaf(pa, v1, o[n][1]);
              o[n][2] = fmaf(pb, v0, o[n][2]);
              o[n][3] = fmaf(pb, v1, o[n][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  cp_async_wait<0>();

  if (!warp_live) return;
  if constexpr (kSplit) {
    if (p.n_splits > 1) {
      const long long base = (static_cast<long long>(split) * gridDim.y + blockIdx.y) * n_rows;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? rb : ra;
        if (r >= n_rows) continue;
        float* acc = p.part_acc + (base + r) * kMaxHD;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          *reinterpret_cast<float2*>(acc + n * 8 + t4 * 2) =
              make_float2(o[n][2 * half], o[n][2 * half + 1]);
        }
        if (t4 == 0) {
          *reinterpret_cast<float2*>(p.part_ml + (base + r) * 2) =
              make_float2(half ? m_b : m_a, half ? l_b : l_a);
        }
      }
      return;
    }
  }
  float* out = static_cast<float*>(p.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= n_rows) continue;
    const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
    float* dst = out + row_offset(p, b, kvh, r);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + t4 * 2;
      if (d < p.hd) {
        *reinterpret_cast<float2*>(dst + d) =
            make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
      }
    }
  }
}

}  // namespace attention_tile
