// Shared tile machinery of the flash_attention and decode_attention kernels.
//
// Both kernels compute, for the query rows of one KV head, an online-softmax
// attention over that head's keys:
//
//   s = (q . k) * scale, masked to -1e30 where the key is not visible;
//   m, l, acc in float32, rescaled per key tile; out = acc / max(l, 1e-30).
//
// Rows.  A block takes kRows = 64 query rows of one (batch, kv head) pair,
// in the order of the Pallas decode kernel: row r of the G * Sq rows is
// (g = r / Sq, qi = r % Sq), query head h = kv_head * G + g.  Four warps
// own 16 rows each.  A key at position kpos is visible to row r iff
// kpos < key_end and, when causal, kpos <= q_offset + qi.  Flash attention
// uses q_offset = 0 (qpos >= kpos from position 0); decode uses
// q_offset = kv_len - Sq and key_end = min(S_max, kv_len).
//
// Keys.  Tiles of kKeys = 64 keys are staged in shared memory with
// cp.async, two stages deep, K and V together; keys past the block's last
// visible key are never loaded, rows and head dims past the tensor's edge
// are zero-filled.  A block may take only a split of the keys (split-K
// flash-decoding): then it writes its unnormalised acc and (m, l) to
// float32 partials, and a combine pass finishes the rows.
//
// Products.  bfloat16: mma.sync m16n8k16 with float32 accumulation, Q
// fragments held in registers for the whole sweep, K and V fragments by
// ldmatrix (V transposed).  The probabilities p stay float32 into P.V, as
// in the Pallas kernels: p is split into a bfloat16 high part and a
// bfloat16 remainder, and both go through the tensor cores against the
// exact bfloat16 V (16 bits of p's mantissa, not 8).  float32: the same
// tiles and softmax with CUDA-core products in float32, for holding the
// algorithm against the plain version at float32 tolerance.
//
// Masked probabilities are exactly 0 (not exp(0) for a row with every key
// masked so far), so a row with no visible key gives 0, not NaN.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attention_tile {

constexpr int kRows = 64;   // query rows per block
constexpr int kKeys = 64;   // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHD = 128;  // head dims up to 128; row width of the partials
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
  int split_keys;    // keys per split, a multiple of kKeys
  float scale;
};

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

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a (16x16, row) * b (16x8, col), bfloat16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Split (x, y) into a bfloat16 pair and the bfloat16 pair of what it missed.
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float x, float y);
template <>
__device__ __forceinline__ void store_pair<float>(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int HD>
__host__ __device__ constexpr int row_stride() {  // shared-memory row, padded 16 B against bank conflicts
  return HD + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(kRows + 4 * kKeys) * row_stride<T, HD>() * sizeof(T);
}

// One block: kRows query rows of one (batch, kv head), one split of keys.
// kSplit compiles in the partial-output path (decode only).
template <typename T, int HD, bool kSplit>
__device__ __forceinline__ void attention_block(const Params& p) {
  constexpr int LD = row_stride<T, HD>();
  constexpr int CH = 16 / static_cast<int>(sizeof(T));  // elements per 16 B chunk
  constexpr int CPR = HD / CH;                           // chunks per row
  constexpr int NT = kKeys / 8;                          // n8 tiles of S
  constexpr int NO = HD / 8;                             // n8 tiles of O
  constexpr bool kBf16 = sizeof(T) == 2;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kRows * LD;         // [2][kKeys][LD]
  T* Vs = Ks + 2 * kKeys * LD;     // [2][kKeys][LD]

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);

  const int n_rows = p.G * p.Sq;
  const int Hq = p.n_kv * p.G;
  const int n_row_tiles = (n_rows + kRows - 1) / kRows;
  // Causal blocks with the most keys first: the last row tile is the heaviest.
  const int r0 = (n_row_tiles - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int b = blockIdx.y / p.n_kv;
  const int kvh = blockIdx.y % p.n_kv;
  const int split = blockIdx.z;

  // Keys this block needs: [k_lo, k_hi); all rows see keys below full_until.
  const int r_last = min(r0 + kRows, n_rows) - 1;
  const bool spans = r0 / p.Sq != r_last / p.Sq;
  const int max_qi = spans ? p.Sq - 1 : r_last % p.Sq;
  const int min_qi = spans ? 0 : r0 % p.Sq;
  const int k_lo = split * p.split_keys;
  int k_hi = min(k_lo + p.split_keys, p.key_end);
  int full_until = p.key_end;
  if (p.causal) {
    k_hi = min(k_hi, p.q_offset + max_qi + 1);
    full_until = min(full_until, p.q_offset + min_qi + 1);
  }
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
  const T* kbase = k + (static_cast<long long>(b) * p.Sk * p.n_kv + kvh) * p.hd;
  const T* vbase = v + (static_cast<long long>(b) * p.Sk * p.n_kv + kvh) * p.hd;

  auto q_offset_of = [&](int r) -> long long {  // element offset of row r's query
    const int g = r / p.Sq, qi = r % p.Sq;
    return ((static_cast<long long>(b) * p.Sq + qi) * Hq + kvh * p.G + g) * p.hd;
  };

  // --- start the copies of the Q tile, then K/V tile 0 ------------------
  for (int idx = threadIdx.x; idx < kRows * CPR; idx += kThreads) {
    const int row = idx / CPR, c = idx % CPR;
    const int r = r0 + row;
    const bool ok = r < n_rows && c * CH < p.hd;
    cp_async16(Qs + row * LD + c * CH, ok ? q + q_offset_of(r) + c * CH : q, ok);
  }
  cp_async_commit();

  auto load_kv = [&](int tile, int stage) {
    const int kt = k_lo + tile * kKeys;
    T* ks = Ks + stage * kKeys * LD;
    T* vs = Vs + stage * kKeys * LD;
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
  unsigned qf[kBf16 ? HD / 16 : 1][4];  // Q A-fragments (bfloat16 only)

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile `it` have landed
    __syncthreads();

    const T* ks = Ks + (it & 1) * kKeys * LD;
    const T* vs = Vs + (it & 1) * kKeys * LD;
    const int kt = k_lo + it * kKeys;

    if (warp_live) {
      // ---- S = Q K^T for this warp's 16 rows x kKeys keys -------------
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (kBf16) {
        if (it == 0) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldmatrix_x4(qf[kk], Qs + row * LD + kk * 16 + (lane >> 4) * 8);
          }
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            unsigned bf[4];
            const int key = jp * 16 + (lane >> 4) * 8 + (lane & 7);
            ldmatrix_x4(bf, ks + key * LD + kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * jp], qf[kk], bf[0], bf[1]);
            mma_bf16(s[2 * jp + 1], qf[kk], bf[2], bf[3]);
          }
        }
      } else {
        const T* qa = Qs + (warp * 16 + g4) * LD;
        const T* qb = qa + 8 * LD;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const T* k0 = ks + (j * 8 + t4 * 2) * LD;
          const T* k1 = k0 + LD;
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
      }

      // ---- scale, mask, online softmax ---------------------------------
      const bool need_mask = kt + kKeys > full_until;
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
      if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          unsigned ph[4], pl[4];
          split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            unsigned bf[4];
            const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
            ldmatrix_x4_trans(bf, vs + key * LD + np * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * np], ph, bf[0], bf[1]);
            mma_bf16(o[2 * np], pl, bf[0], bf[1]);
            mma_bf16(o[2 * np + 1], ph, bf[2], bf[3]);
            mma_bf16(o[2 * np + 1], pl, bf[2], bf[3]);
          }
        }
      } else {
        const int quad = lane & ~3;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
#pragma unroll
            for (int src = 0; src < 4; ++src) {
              const float pa = __shfl_sync(0xffffffffu, s[j][c], quad | src);
              const float pb = __shfl_sync(0xffffffffu, s[j][2 + c], quad | src);
              const T* vr = vs + (j * 8 + src * 2 + c) * LD + t4 * 2;
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
  T* out = static_cast<T*>(p.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= n_rows) continue;
    const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
    T* dst = out + q_offset_of(r);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + t4 * 2;
      if (d < p.hd) store_pair<T>(dst + d, o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    }
  }
}

}  // namespace attention_tile
