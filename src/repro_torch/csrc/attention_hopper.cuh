// The bfloat16 tile of the flash_attention and decode_attention kernels,
// written for Hopper (sm_90a): K and V stream into shared memory by TMA and
// both products run on wgmma.  The rows, masks, split-K partials and the
// float32 tile are in attention_tile.cuh.
//
// Block.  Three warpgroups, 384 threads: two consumers and one producer.
// Each consumer owns 64 query rows, so a block takes kRows = 128 rows of
// one (batch, kv head); a consumer whose rows all lie past the end (decode:
// G * Sq = 2 rows) exits at once.  The producer gives its registers up
// (setmaxnreg 24) so that the consumers can hold 240 each.
//
// Ring.  One thread of the producer streams K and V tiles of kKeys = 128
// keys into a ring of kStages slots (3 at head_dim 128, 4 at 64), each
// slot with a full and an empty mbarrier.  Each tile is one TMA load of K
// and one of V per 64 head dims (cp.async.bulk.tensor.4d), with 128-byte
// swizzle, from a 4-D tensor map of the model's (B, S, n_kv, hd) layout:
// no transpose, no padding copy.  The maps' S extent is key_end, so slots
// past it (decode: past kv_len) come back as zeros and are never read;
// head dims past hd come back zero too.  Shared memory at head_dim 128:
// Q 32 KB + 3 x (32 + 32) KB of K/V + the barriers + 1 KB of alignment
// slack, 225 KB of the 227 KB a block may have, so one block per SM.
//
// Consumers.  Each loads its 64 Q rows once by cp.async into the same
// swizzled layout (a tile may span query heads, so Q is not one TMA box).
// Per tile: S = Q K^T by wgmma m64n128k16, both operands K-major from
// shared memory; the online softmax on the accumulator registers in log2
// units (scale * log2(e) folded into one multiply, MUFU.EX2), masks only
// on tiles that cross the causal diagonal, key_end or the ragged end; then
// O += P V by wgmma m64nHDk16 with P converted in registers to bfloat16 A
// fragments (the accumulator layout of S is the A-fragment layout) and V
// an MN-major operand read from shared memory.  S of tile i and P V of
// tile i - 1 are issued together, so the softmax of tile i runs while
// P V is on the tensor cores; the two consumers issue their products in
// turns (pingpong, named barriers 3 and 4), so one's softmax also runs
// under the other's products.  Every product is fenced, committed and
// waited on before its registers are touched, and a slot goes back to
// the producer (one arrival per consumer warp) once P V has read it.
//
// Rounding of p.  p goes into P V rounded once to bfloat16, as SDPA and
// FlashAttention do; the sums l are taken over the float32 p.  The plain
// versions keep p float32.  A second P V product on p's bfloat16 remainder
// (the earlier mma.sync tile's numerics, 1.5x the tensor-core work) was
// measured and dropped: 26-39 % more time at the compute-bound shapes and
// no check that needs it (PERF.md, the attention kernels' findings).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention_tile.cuh"

namespace attention_hopper {

using attention_tile::KeyRange;
using attention_tile::kMaxHD;
using attention_tile::kNegInf;
using attention_tile::Params;

constexpr int kConsumers = 2;
constexpr int kRows = 64 * kConsumers;  // query rows per block
constexpr int kKeys = 128;              // keys per K/V tile
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kAtom = 64;               // bfloat16 per 128-byte swizzled row
constexpr int kAtomRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory layout, offsets from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes and TMA and wgmma both assume
// the pattern starts on a 1024-byte boundary).  A Q, K or V tile of R rows
// is HD / 64 column blocks ("atoms") of R rows x 128 bytes, one after the
// other; the 16-byte chunk c of row j sits at chunk c ^ (j % 8).
template <int HD>
struct Layout {
  static constexpr int kAtoms = HD / kAtom;
  static constexpr int kStages = HD == 128 ? 3 : 4;
  static constexpr int kQBytes = 64 * HD * 2;          // one consumer's rows
  static constexpr int kTileBytes = kKeys * HD * 2;    // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kConsumers * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kFull = kV + kStages * kTileBytes;
  static constexpr int kEmpty = kFull + 8 * kStages;
  static constexpr int kBytes = kEmpty + 8 * kStages;
  static constexpr size_t kSmem = kBytes + 1024;  // room to align the base
};
static_assert(Layout<128>::kSmem <= 232448, "shared memory of one block on an H100");

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {  // MUFU.EX2; 0 below 2^-126
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the compiler from moving reads or writes of a register that an
// in-flight wgmma reads or writes across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}
// K-major (Q and K): 8-row groups 1024 bytes apart; the leading offset is
// unused while the 16 k-values of one instruction lie in one 128-byte row.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
// MN-major (V, read as B = V[keys, hd]): 8-key groups 1024 bytes apart,
// 64-wide column blocks of hd one tile of kKeys rows apart.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return smem_desc(addr, kKeys * kAtomRowBytes, 1024);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, float32) = scale_d * D + A (64 x 16) * B (16 x 128), A and B
// bfloat16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 128, float32) += A (64 x 16, bfloat16 fragments in registers) * B (16 x 128,
// bfloat16 in shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16, bfloat16 fragments in registers) * B (16 x 64,
// bfloat16 in shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
    wgmma_rs_n64(d, a, b);
  }
}

// ---- the tile ---------------------------------------------------------------

// One block: kRows query rows of one (batch, kv head), one split of keys.
// kSplit compiles in the partial-output path (decode only).
template <int HD, bool kSplit>
__device__ __forceinline__ void attention_block(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                                const Params& p) {
  using L = Layout<HD>;
  constexpr int kStages = L::kStages;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::kFull, empty = base + L::kEmpty;

  const int n_rows = p.G * p.Sq;
  const int n_row_tiles = (n_rows + kRows - 1) / kRows;
  // Causal blocks with the most keys first: the last row tile is the heaviest.
  const int r0 = (n_row_tiles - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int b = blockIdx.y / p.n_kv;
  const int kvh = blockIdx.y % p.n_kv;
  const int split = blockIdx.z;
  const KeyRange kr = attention_tile::key_range(p, r0, kRows, split);
  const int n_tiles = kr.k_hi > kr.k_lo ? (kr.k_hi - kr.k_lo + kKeys - 1) / kKeys : 0;
  const int n_live = min(kConsumers, (n_rows - r0 + 63) / 64);  // consumers with rows

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * n_live);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full -------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * L::kTileBytes);
        const int kt = kr.k_lo + it * kKeys;
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a) {
          const uint32_t off = s * L::kTileBytes + a * kKeys * kAtomRowBytes;
          tma_load_4d(base + L::kK + off, kmap, bar, a * kAtom, kvh, kt, b);
          tma_load_4d(base + L::kV + off, vmap, bar, a * kAtom, kvh, kt, b);
        }
      }
    }
  } else {
    // ---- consumer: 64 rows, both products and the softmax -------------------
    setmaxnreg_inc<240>();
    if (wg >= n_live) return;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, t4 = lane % 4;
    const int rw0 = r0 + wg * 64;  // this consumer's first row
    unsigned char* qs = smem + L::kQ + wg * L::kQBytes;
    const uint32_t qs_u = smem_u32(qs);

    // Q: 64 rows by cp.async into the swizzled layout, zeros past the edges.
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
    for (int idx = tid; idx < 64 * CPR; idx += 128) {
      const int row = idx / CPR, c = idx % CPR;
      const int r = rw0 + row;
      const bool ok = r < n_rows && c * 8 < p.hd;
      unsigned char* dst = qs + (c / 8) * (64 * kAtomRowBytes) + row * kAtomRowBytes +
                           (((c % 8) ^ (row % 8)) * 16);
      attention_tile::cp_async16(dst, ok ? q + attention_tile::row_offset(p, b, kvh, r) + c * 8 : q,
                                 ok);
    }
    attention_tile::cp_async_commit();
    attention_tile::cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    named_bar_sync(1 + wg, 128);

    // This thread's accumulator rows: a = warp * 16 + lane / 4, b = a + 8.
    const int ra = rw0 + warp * 16 + lane / 4;
    const int rb = ra + 8;
    const int lim_a = p.causal ? p.q_offset + ra % p.Sq : 0x7fffffff;
    const int lim_b = p.causal ? p.q_offset + rb % p.Sq : 0x7fffffff;
    const float scale_log2 = p.scale * kLog2e;

    float o[HD / 2], s[kKeys / 2];
    uint32_t pf[kKeys / 16][4];  // P of the tile whose P V product is next
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf;  // running max, log2 units
    float l_a = 0.f, l_b = 0.f;          // this thread's share of the row sums

    // S = Q K^T, 64 rows x kKeys keys in hd / 16 steps, on the K of slot st.
    auto issue_qk = [&](int st) {
      const uint32_t ks = base + L::kK + st * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
        wgmma_ss_n128(s, desc_k_major(qs_u + (kk / 4) * 64 * kAtomRowBytes + col),
                      desc_k_major(ks + (kk / 4) * kKeys * kAtomRowBytes + col), kk > 0);
      }
    };
    // O += P V in kKeys / 16 steps, on the V of slot st.
    auto issue_pv = [&](int st) {
      const uint32_t vs = base + L::kV + st * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wgmma_rs<HD>(o, pf[kk], desc_mn_major(vs + kk * 16 * kAtomRowBytes));
      }
    };

    // Scale, mask (kMask: a tile crossing the diagonal, key_end or the
    // ragged end) and online softmax of the tile at key kt, in log2 units;
    // leaves p in s and returns the rescale of the earlier rows' sums.
    auto softmax = [&](int kt, auto mask) -> float2 {
      constexpr bool kMask = decltype(mask)::value;
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[4 * j + c] * scale_log2;
          if constexpr (kMask) {
            const int key = kt + j * 8 + t4 * 2 + (c & 1);
            x = key >= p.key_end || key > (c < 2 ? lim_a : lim_b) ? kNegInf : x;
          }
          s[4 * j + c] = x;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float2 corr = make_float2(fast_exp2(m_a - mn_a), fast_exp2(m_b - mn_b));
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const float x = s[i];
        const float e = fast_exp2(x - ((i & 2) ? mn_b : mn_a));
        s[i] = kMask && x == kNegInf ? 0.f : e;  // masked: exactly 0
        if (i & 2) {
          sum_b += s[i];
        } else {
          sum_a += s[i];
        }
      }
      l_a = l_a * corr.x + sum_a;
      l_b = l_b * corr.y + sum_b;
      return corr;
    };
    // O *= corr, then p into bfloat16 A fragments: the accumulator of keys
    // 16kk..16kk+15 is the A fragment of step kk.
    auto rescale_and_pack = [&](float2 corr) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= corr.x;
        o[4 * j + 1] *= corr.x;
        o[4 * j + 2] *= corr.y;
        o[4 * j + 3] *= corr.y;
      }
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pf[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        }
      }
    };
    auto fence_pv = [&]() {
      fence_regs(o);
      fence_regs(pf);
    };

    // The products are issued in turns (pingpong) when both consumers
    // work: each waits on its own named barrier (3 + wg) until the other
    // has issued, so one's softmax runs under the other's products.
    // Consumer 1 opens consumer 0's first turn; consumer 0 takes the last
    // hand-over after its loop, so every arrival is matched.  Every wgmma
    // sits in control flow that is uniform across the block (branches on
    // thread-dependent values around in-flight wgmma make ptxas serialize
    // them).
    const bool pingpong = n_live == kConsumers && n_tiles > 0;
    const int my_turn = 3 + wg, their_turn = 4 - wg;
    if (pingpong && wg == 1) named_bar_arrive(3, 2 * 128);

    // Per tile after the first: S of this tile and P V of the previous one
    // go out together, and the softmax of this tile runs while P V is on
    // the tensor cores.
    auto step = [&](int it, auto mask) {
      const int st = it % kStages, prev = (it - 1) % kStages;
      mbar_wait(full + 8 * st, (it / kStages) & 1);
      if (pingpong) named_bar_sync(my_turn, 2 * 128);
      wgmma_fence();  // s, o and pf were last written by this thread
      issue_qk(st);
      wgmma_commit();
      issue_pv(prev);
      wgmma_commit();
      if (pingpong) named_bar_arrive(their_turn, 2 * 128);
      wgmma_wait<1>();  // S has landed; P V may still run
      fence_regs(s);
      const float2 corr = softmax(kr.k_lo + it * kKeys, mask);
      wgmma_wait<0>();
      fence_pv();
      if (lane == 0) mbar_arrive(empty + 8 * prev);  // this warp is done with the slot
      rescale_and_pack(corr);
    };

    // Tiles [0, n_open) need no mask; the block's rows share full_until.
    const int n_open = min(n_tiles, max(0, (kr.full_until - kr.k_lo) / kKeys));
    if (n_tiles > 0) {
      mbar_wait(full, 0);  // tile 0: S alone, masked whatever it holds
      if (pingpong) named_bar_sync(my_turn, 2 * 128);
      wgmma_fence();
      issue_qk(0);
      wgmma_commit();
      if (pingpong) named_bar_arrive(their_turn, 2 * 128);
      wgmma_wait<0>();
      fence_regs(s);
      rescale_and_pack(softmax(kr.k_lo, std::true_type{}));
      for (int it = 1; it < n_open; ++it) step(it, std::false_type{});
      for (int it = max(1, n_open); it < n_tiles; ++it) step(it, std::true_type{});
      wgmma_fence();  // the last tile's P V; the producer has nothing left to load
      issue_pv((n_tiles - 1) % kStages);
      wgmma_commit();
      wgmma_wait<0>();
      fence_pv();
    }
    if (pingpong && wg == 0) named_bar_sync(my_turn, 2 * 128);  // the last hand-over

#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
    }

    if constexpr (kSplit) {
      if (p.n_splits > 1) {  // unnormalised partials, m in natural-log units
        const long long at = (static_cast<long long>(split) * gridDim.y + blockIdx.y) * n_rows;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? rb : ra;
          if (r >= n_rows) continue;
          float* acc = p.part_acc + (at + r) * kMaxHD;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j) {
            *reinterpret_cast<float2*>(acc + j * 8 + t4 * 2) =
                make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
          }
          if (t4 == 0) {
            *reinterpret_cast<float2*>(p.part_ml + (at + r) * 2) =
                make_float2((half ? m_b : m_a) * kLn2, half ? l_b : l_a);
          }
        }
        return;
      }
    }

    // ---- epilogue: normalise, stage the 64 x hd tile in Q's place, store
    // 16-byte chunks ----------------------------------------------------------
    named_bar_sync(1 + wg, 128);  // every warp's products have read Q
    constexpr int RB = HD * 2;    // staged row bytes; chunk c of row j at c ^ (j % 8)
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
    const int row_a = warp * 16 + lane / 4, row_b = row_a + 8;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(qs + row_a * RB + ((j ^ (row_a % 8)) * 16) + t4 * 4) =
          pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(qs + row_b * RB + ((j ^ (row_b % 8)) * 16) + t4 * 4) =
          pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
    named_bar_sync(1 + wg, 128);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
    for (int idx = tid; idx < 64 * CPR; idx += 128) {
      const int row = idx / CPR, c = idx % CPR;
      const int r = rw0 + row;
      if (r < n_rows && c * 8 < p.hd) {
        *reinterpret_cast<int4*>(out + attention_tile::row_offset(p, b, kvh, r) + c * 8) =
            *reinterpret_cast<const int4*>(qs + row * RB + ((c ^ (row % 8)) * 16));
      }
    }
  }
}

// ---- host side ------------------------------------------------------------

// cuTensorMapEncodeTiled, found through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// The TMA map of one (B, S_alloc = p.Sk, n_kv, hd) bfloat16 K or V tensor as
// the 4-D (hd, n_kv, S, B), its S extent cut to p.key_end, boxes of
// 64 head dims x 1 head x kKeys keys x 1 batch, 128-byte swizzle, zeros
// outside.
inline cudaError_t kv_map(CUtensorMap* map, const void* data, const Params& p) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t row = static_cast<cuuint64_t>(p.hd) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.hd), static_cast<cuuint64_t>(p.n_kv),
                              static_cast<cuuint64_t>(p.key_end > 0 ? p.key_end : 1),
                              static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[3] = {row, row * p.n_kv, row * p.n_kv * p.Sk};
  const cuuint32_t box[4] = {kAtom, 1, kKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(data),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Grants the kernel its shared memory, encodes the K and V maps and
// launches kRows-row blocks over (row tiles, B * n_kv, n_splits).
template <int HD, auto kKernel>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = Layout<HD>::kSmem;
  static const cudaError_t granted = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (granted != cudaSuccess) return static_cast<int>(granted);
  CUtensorMap kmap, vmap;
  cudaError_t err = kv_map(&kmap, p.k, p);
  if (err == cudaSuccess) err = kv_map(&vmap, p.v, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.G * p.Sq + kRows - 1) / kRows, p.B * p.n_kv, p.n_splits);
  kKernel<<<grid, kThreads, smem, stream>>>(kmap, vmap, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attention_hopper
