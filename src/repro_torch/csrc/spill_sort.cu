// The map's stable spill sort: each task row's (key, value) pairs sorted by
// their masked key, written straight into the map's output rows.
//
// Replaces no Pallas kernel: the reference sorts with jnp.argsort and three
// gathers (src/repro/mapreduce/phases.py:129), and until this kernel the
// port did the same with torch ops (a stable cub sort of the masked int32
// keys carrying an int64 index, then keys, values and the valid mask
// gathered through it).  Its plain version is phases.spill_sort_plain.
//
// Contract.  (rows, cols) int32 keys and values and a bool valid mask, each
// with its own row stride.  A slot is live when it is valid and its key is
// not PAD_KEY; the others (dead, or valid and keyed PAD_KEY) form the PAD
// group.  Out, each with its own row stride: the live pairs in ascending
// signed key order, ties in slot order, valid true; then the PAD group in
// slot order with its own key, value and valid.  Every value gets its
// row's entry of an optional (rows,) int32 addend.  That is the stable sort
// of the masked keys, slot for slot.
//
// Design.  An LSD radix sort of the live keys, taken as key ^ 0x80000000
// so that negative keys sort first, in digits of kBits bits:
//   1. hist: each (row, tile) block counts its live slots and every digit's
//      histogram of its live keys (shared memory; a digit on which a warp's
//      live keys agree is added once) and adds them to the row's;
//   2. plan: one block a row turns the histograms into each digit's bin
//      offsets, the tiles' live counts into their prefix, and marks a digit
//      whose live keys all fall in one bin as trivial.  The row's passes are
//      its non-trivial digits in order (with none, the last digit, which
//      then only compacts): the first reads the input, the last writes the
//      output rows, and those between alternate between one scratch buffer
//      of (key, value) pairs and the output rows, so that the last reads
//      the scratch.  The number of non-trivial digits is added to a device
//      counter;
//   3. one scatter launch a digit: blocks of a row whose pass it is not
//      return at once.  A block takes its tile through a ticket, ranks its
//      digits stably (per-warp counts, lanes of one bin matched by ballots),
//      and learns each bin's offset from the tiles before it by a decoupled
//      look-back (a status word a (tile, bin): the tile's count, then the
//      inclusive prefix).  Its pairs leave through shared memory in sorted
//      order, so that each bin's run is stored in consecutive slots.  The
//      first pass of a row also writes the PAD group to [live, cols) of the
//      output, from the tiles' live prefix; later passes read and write only
//      the live prefix, and the last writes its valid flags in slot order.
// The host reads nothing: launches are the same for every input.
//
// Bound on an H100.  The least traffic is one read and one write of each
// pair's 9 bytes (key, value, valid).  This design reads 5 B a slot in the
// histogram pass, 9 B in the first pass (8 B in a row with no dead slot),
// and 8 B a live pair in every later pass; it writes 8 B a live pair a
// pass, 9 B in the last, and 9 B a dead slot once.  WordCount's keys (under
// 2^21) vary in three 8-bit digits, about 54 B a pair, and Exim's (under
// 2^25) in four.  The passes do not reach the bytes' time: like cub's
// onesweep on the same card, they are held by the rate at which a block
// ranks its digits (about 1e11 pairs a second), so the design saves passes
// and bytes a pair, and keeps four blocks an SM.

#include <cuda_runtime.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <type_traits>

namespace {

constexpr int kPadKey = 0x7fffffff;
constexpr int kBits = 8;  // the radix digit (11 bits measured twice as slow a call)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // slots a block takes
constexpr int kScatterBlocks = 4;          // scatter blocks an SM holds at least
static_assert(kItems <= 32 && kItems % 4 == 0,
              "a thread's valid flags fill one word; its histogram loads go four at a time");
constexpr unsigned kAll = 0xffffffffu;

// Look-back status word: a flag in the top two bits, a count below.
constexpr unsigned kAggregate = 1u << 30;  // the tile's own count
constexpr unsigned kInclusive = 2u << 30;  // the count of the tiles up to it
constexpr unsigned kCountMask = (1u << 30) - 1;

// Pass plan word: where a row's pass reads, and where it writes.
constexpr int kFromInput = 0, kFromPairs = 1, kFromOut = 2;
constexpr int kToPairs = 1, kToOut = 2, kToFinal = 3;

template <int BITS>
struct Radix {
  static constexpr int kBins = 1 << BITS;
  static constexpr int kDigits = (32 + BITS - 1) / BITS;
  static constexpr int kDead = kBins;      // the PAD group's rank bin
  static constexpr int kNone = kBins + 1;  // slots past the data
  static constexpr int kRankBins = kBins + 2;
  static constexpr int kMatchBits = BITS + 1;
  static constexpr int kBinsPerThread = kBins / kThreads;  // blocked bins
  // The scatter's shared memory: tile_start and gbase (kBins + 1 ints
  // each), then the per-warp rank counts, which the exchange later covers.
  static constexpr int kHeadBytes = (2 * (kBins + 1) * 4 + 15) / 16 * 16;
  static constexpr int kRankBytes = kWarps * kRankBins * 4;
  static constexpr int kExchangeBytes = kTile * 9;
  static constexpr int kScatterSmem =
      kHeadBytes + (kRankBytes > kExchangeBytes ? kRankBytes : kExchangeBytes);
  static_assert(kBins % kThreads == 0, "bins must split evenly over the threads");

  __device__ __forceinline__ static int digit(int key, int d) {
    return static_cast<int>(((static_cast<unsigned>(key) ^ 0x80000000u) >> (d * BITS)) &
                            (kBins - 1));
  }
};

struct Args {
  const int* keys;
  long long ld_k;
  const int* vals;
  long long ld_v;
  const unsigned char* valid;
  long long ld_p;
  int rows, cols, tiles;
  const int* addend;  // (rows,) or null
  int* out_k;
  long long ld_ok;
  int* out_v;
  long long ld_ov;
  unsigned char* out_p;
  long long ld_op;
  int* hist;          // (rows, digits, bins): counts, then exclusive offsets
  int* live_before;   // (rows, tiles): live slots a tile, then their prefix
  int* row_live;      // (rows,)
  int* info;          // (rows, digits): pass plan words, -1 for none
  int* tickets;       // (rows, digits)
  unsigned* status;   // (rows, digits, tiles, bins)
  int2* pairs;        // (rows, cols): the live (key, value) pairs between passes
  int* passes;        // the non-trivial digit passes, summed; or null
};

// Lanes of the warp whose bin equals this lane's, from one ballot a bit.
template <int NBITS>
__device__ __forceinline__ unsigned match_bins(int bin) {
  unsigned peers = kAll;
#pragma unroll
  for (int i = 0; i < NBITS; ++i) {
    const bool bit = (bin >> i) & 1;
    const unsigned m = __ballot_sync(kAll, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// ---- 1. histograms ------------------------------------------------------

template <int BITS>
__global__ void __launch_bounds__(kThreads) spill_hist(Args a) {
  using T = Radix<BITS>;
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ int h[T::kDigits * T::kBins];
  __shared__ typename Reduce::TempStorage red;
  const int row = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < T::kDigits * T::kBins; i += kThreads) {
    h[i] = 0;
    const int d = i / T::kBins, b = i % T::kBins;
    a.status[((static_cast<long long>(row) * T::kDigits + d) * a.tiles + tile) * T::kBins + b] =
        0u;
  }
  __syncthreads();
  const int tile0 = tile * kTile;
  const int n = min(kTile, a.cols - tile0);
  const int* rk = a.keys + row * a.ld_k + tile0;
  const unsigned char* rp = a.valid + row * a.ld_p + tile0;
  // Order does not matter to a histogram: where the row allows, a thread
  // loads four neighbouring keys and flags at once.
  int k[kItems];
  bool live[kItems];
  if (n == kTile && !(reinterpret_cast<unsigned long long>(rk) & 15) &&
      !(reinterpret_cast<unsigned long long>(rp) & 3)) {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 k4 = reinterpret_cast<const int4*>(rk)[q * kThreads + tid];
      const unsigned p4 = reinterpret_cast<const unsigned*>(rp)[q * kThreads + tid];
      k[4 * q] = k4.x;
      k[4 * q + 1] = k4.y;
      k[4 * q + 2] = k4.z;
      k[4 * q + 3] = k4.w;
#pragma unroll
      for (int c = 0; c < 4; ++c) live[4 * q + c] = (p4 >> (8 * c)) & 0xff;
    }
  } else if (n == kTile) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) k[j] = rk[j * kThreads + tid];
#pragma unroll
    for (int j = 0; j < kItems; ++j) live[j] = rp[j * kThreads + tid] != 0;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = j * kThreads + tid;
      k[j] = i < n ? rk[i] : kPadKey;
      live[j] = i < n && rp[i] != 0;
    }
  }
  // A digit on which the warp's live keys agree is counted once, by lane 0.
  int count = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    live[j] = live[j] && k[j] != kPadKey;
    count += live[j];
    const unsigned lm = __ballot_sync(kAll, live[j]);
    if (!lm) continue;
    const unsigned u = static_cast<unsigned>(k[j]) ^ 0x80000000u;
    const unsigned ones = __reduce_and_sync(kAll, live[j] ? u : kAll);
    const unsigned vary = ones ^ __reduce_or_sync(kAll, live[j] ? u : 0u);
#pragma unroll
    for (int d = 0; d < T::kDigits; ++d) {
      if (!((vary >> (d * BITS)) & (T::kBins - 1))) {
        if (lane == 0) atomicAdd(&h[d * T::kBins + ((ones >> (d * BITS)) & (T::kBins - 1))],
                                 __popc(lm));
      } else if (live[j]) {
        atomicAdd(&h[d * T::kBins + T::digit(k[j], d)], 1);
      }
    }
  }
  const int total = Reduce(red).Sum(count);
  if (tid == 0) a.live_before[static_cast<long long>(row) * a.tiles + tile] = total;
  __syncthreads();
  int* rh = a.hist + static_cast<long long>(row) * T::kDigits * T::kBins;
  for (int i = tid; i < T::kDigits * T::kBins; i += kThreads) {
    if (h[i]) atomicAdd(rh + i, h[i]);
  }
}

// ---- 2. the plan --------------------------------------------------------

template <int BITS>
__global__ void __launch_bounds__(kThreads) spill_plan(Args a) {
  using T = Radix<BITS>;
  using Scan = cub::BlockScan<int, kThreads>;
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ union {
    typename Scan::TempStorage scan;
    typename Reduce::TempStorage reduce;
  } tmp;
  __shared__ int nonzero[T::kDigits];
  __shared__ int live_n;
  const int row = blockIdx.x, tid = threadIdx.x;
  for (int d = 0; d < T::kDigits; ++d) {
    int* h = a.hist + (static_cast<long long>(row) * T::kDigits + d) * T::kBins;
    int c[T::kBinsPerThread];
    int nz = 0;
#pragma unroll
    for (int i = 0; i < T::kBinsPerThread; ++i) {
      c[i] = h[tid * T::kBinsPerThread + i];
      nz += c[i] != 0;
    }
    const int z = Reduce(tmp.reduce).Sum(nz);
    __syncthreads();
    int total;
    Scan(tmp.scan).ExclusiveSum(c, c, total);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < T::kBinsPerThread; ++i) h[tid * T::kBinsPerThread + i] = c[i];
    if (tid == 0) {
      nonzero[d] = z;
      if (d == 0) live_n = total;
    }
  }
  __syncthreads();
  if (tid == 0) {
    bool act[T::kDigits];
    int nontrivial = 0;
    for (int d = 0; d < T::kDigits; ++d) {
      act[d] = nonzero[d] > 1;
      nontrivial += act[d];
    }
    if (!nontrivial) act[T::kDigits - 1] = true;  // a compaction only
    const int n_act = max(nontrivial, 1);
    int idx = 0, src = kFromInput;
    for (int d = 0; d < T::kDigits; ++d) {
      int word = -1;
      if (act[d]) {
        const int left = n_act - 1 - idx++;
        const int dst = left == 0 ? kToFinal : (left % 2 ? kToPairs : kToOut);
        word = src | (dst << 2);
        src = dst == kToPairs ? kFromPairs : kFromOut;
      }
      a.info[row * T::kDigits + d] = word;
      a.tickets[row * T::kDigits + d] = 0;
    }
    a.row_live[row] = live_n;
    if (a.passes) atomicAdd(a.passes, nontrivial);
  }
  int* lb = a.live_before + static_cast<long long>(row) * a.tiles;
  int carry = 0;
  for (int base = 0; base < a.tiles; base += kThreads) {
    const int t = base + tid;
    const int x = t < a.tiles ? lb[t] : 0;
    int excl, total;
    Scan(tmp.scan).ExclusiveSum(x, excl, total);
    if (t < a.tiles) lb[t] = carry + excl;
    carry += total;
    __syncthreads();
  }
}

// ---- 3. the scatter passes ----------------------------------------------

__device__ __forceinline__ unsigned wait_word(const unsigned* p) {
  unsigned w;
  do {
    w = *reinterpret_cast<const volatile unsigned*>(p);
  } while (!(w >> 30));
  return w;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads, kScatterBlocks) spill_scatter(Args a, int d) {
  using T = Radix<BITS>;
  using BinScan = cub::BlockScan<int, kThreads>;
  constexpr int kB = T::kBinsPerThread;
  __shared__ typename BinScan::TempStorage scan_tmp;
  __shared__ int s_tile;
  extern __shared__ __align__(16) unsigned char smem[];
  int* tile_start = reinterpret_cast<int*>(smem);  // kBins + 1: the bin's first sorted slot
  int* gbase = tile_start + T::kBins + 1;           // kBins + 1: output slot minus sorted slot
  unsigned char* region = smem + T::kHeadBytes;
  int* cnt = reinterpret_cast<int*>(region);  // (warps, rank bins)
  int* sk = reinterpret_cast<int*>(region);  // the exchange, over cnt once ranked
  int* sv = sk + kTile;
  unsigned char* sp = reinterpret_cast<unsigned char*>(sv + kTile);

  const int row = blockIdx.y;
  const int info = a.info[row * T::kDigits + d];
  if (info < 0) return;  // not this row's pass
  const int src = info & 3, dst = info >> 2;
  const bool from_input = src == kFromInput;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(a.tickets + row * T::kDigits + d, 1);
  for (int i = tid; i < kWarps * T::kRankBins; i += kThreads) cnt[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int live_n = a.row_live[row];
  const int tile0 = tile * kTile;
  const int n_src = from_input ? a.cols : live_n;
  if (tile0 >= n_src) return;
  const int n = min(kTile, n_src - tile0);

  // Warp w takes slots [w * 32 kItems, (w + 1) * 32 kItems) of the tile,
  // item j of lane l being slot w * 32 kItems + 32 j + l: loads coalesce,
  // and (warp, item, lane) is slot order.
  const int w0 = warp * 32 * kItems + lane;
  int key[kItems], val[kItems], bin[kItems];
  unsigned pv = kAll;  // bit j: item j's valid (every item past the input)
  const bool full = n == kTile;
  if (src == kFromPairs) {
    const int2* rp = a.pairs + static_cast<long long>(row) * a.cols + tile0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = w0 + 32 * j;
      const int2 x = full || i < n ? rp[i] : make_int2(0, 0);
      key[j] = x.x;
      val[j] = x.y;
    }
  } else {
    const int* rk = from_input ? a.keys + row * a.ld_k + tile0 : a.out_k + row * a.ld_ok + tile0;
    const int* rv = from_input ? a.vals + row * a.ld_v + tile0 : a.out_v + row * a.ld_ov + tile0;
    if (full) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        key[j] = rk[w0 + 32 * j];
        val[j] = rv[w0 + 32 * j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = w0 + 32 * j;
        key[j] = i < n ? rk[i] : 0;
        val[j] = i < n ? rv[i] : 0;
      }
    }
  }
  if (from_input && live_n < a.cols) {  // a row with no dead slot reads no flags
    const unsigned char* rp = a.valid + row * a.ld_p + tile0;
    pv = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = w0 + 32 * j;
      pv |= (i < n && rp[i]) ? 1u << j : 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = (pv >> j & 1) && key[j] != kPadKey;
    bin[j] = w0 + 32 * j >= n ? T::kNone : (live ? T::digit(key[j], d) : T::kDead);
  }

  // Rank within the warp: the lanes of one bin take consecutive slots after
  // the warp's earlier items of that bin.  A tile whose slots are all live
  // matches on the digit's bits alone, one ballot fewer an item.
  // The first lane of a bin adds the bin's lanes to the warp's count; the
  // leaders of one item hold distinct bins, and atomics order the items.
  int* wc = cnt + warp * T::kRankBins;
  const unsigned lower = (1u << lane) - 1;
  int pos[kItems];
  bool mine_live = true;
#pragma unroll
  for (int j = 0; j < kItems; ++j) mine_live &= bin[j] < T::kBins;
  const auto rank = [&](auto match_bits) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned peers = match_bins<decltype(match_bits)::value>(bin[j]);
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (lane == leader) before = atomicAdd(wc + bin[j], __popc(peers));
      pos[j] = __shfl_sync(kAll, before, leader) + __popc(peers & lower);
    }
  };
  if (__syncthreads_and(mine_live)) {
    rank(std::integral_constant<int, BITS>());
  } else {
    rank(std::integral_constant<int, T::kMatchBits>());
  }
  __syncthreads();

  // Each bin's count in the tile, and the warps' offsets within it.
  int agg[kB], start[kB];
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    const int b = tid * kB + i;
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = cnt[w * T::kRankBins + b];
      cnt[w * T::kRankBins + b] = run;
      run += x;
    }
    agg[i] = start[i] = run;
  }
  if (tid == kThreads - 1) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = cnt[w * T::kRankBins + T::kDead];
      cnt[w * T::kRankBins + T::kDead] = run;
      run += x;
    }
  }
  int tile_live;
  BinScan(scan_tmp).ExclusiveSum(start, start, tile_live);
#pragma unroll
  for (int i = 0; i < kB; ++i) tile_start[tid * kB + i] = start[i];
  if (tid == 0) tile_start[T::kDead] = tile_live;

  // Decoupled look-back along the row: each bin's count in the tiles before.
  unsigned* st = a.status + (static_cast<long long>(row) * T::kDigits + d) * a.tiles * T::kBins;
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    const int b = tid * kB + i;
    atomicExch(st + static_cast<long long>(tile) * T::kBins + b,
               (tile == 0 ? kInclusive : kAggregate) | static_cast<unsigned>(agg[i]));
  }
  const int* offsets = a.hist + (static_cast<long long>(row) * T::kDigits + d) * T::kBins;
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    const int b = tid * kB + i;
    unsigned before = 0;
    if (tile > 0) {
      for (int p = tile - 1;; --p) {
        const unsigned w = wait_word(st + static_cast<long long>(p) * T::kBins + b);
        before += w & kCountMask;
        if (w & kInclusive) break;
      }
      atomicExch(st + static_cast<long long>(tile) * T::kBins + b,
                 kInclusive | (before + static_cast<unsigned>(agg[i])));
    }
    gbase[b] = offsets[b] + static_cast<int>(before) - start[i];
  }
  if (tid == 0) {
    const int dead_before = tile0 - a.live_before[static_cast<long long>(row) * a.tiles + tile];
    gbase[T::kDead] = live_n + dead_before - tile_live;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (bin[j] != T::kNone) pos[j] += tile_start[bin[j]] + cnt[warp * T::kRankBins + bin[j]];
  }
  __syncthreads();  // the exchange lies over the counts

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (bin[j] == T::kNone) continue;
    sk[pos[j]] = key[j];
    sv[pos[j]] = val[j];
    sp[pos[j]] = pv >> j & 1;
  }
  __syncthreads();

  // Out in sorted order, so that each bin's run of the tile is stored in
  // consecutive slots.
  const int add = a.addend ? a.addend[row] : 0;
  int* ok = a.out_k + row * a.ld_ok;
  int* ov = a.out_v + row * a.ld_ov;
  unsigned char* op = a.out_p + row * a.ld_op;
  int2* pairs = a.pairs + static_cast<long long>(row) * a.cols;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + tid;
    if (i >= n) continue;
    const int k = sk[i], v = sv[i];
    if (i < tile_live) {
      const int o = gbase[T::digit(k, d)] + i;
      if (dst == kToPairs) {
        pairs[o] = make_int2(k, v);
      } else {
        ok[o] = k;
        ov[o] = dst == kToFinal ? v + add : v;
      }
    } else {  // the PAD group, first pass only: its final place
      const int o = gbase[T::kDead] + i;
      ok[o] = k;
      ov[o] = v + add;
      op[o] = sp[i];
    }
  }
  if (dst == kToFinal) {  // the live prefix's flags, this tile's share of it in slot order
    const long long first =
        from_input ? a.live_before[static_cast<long long>(row) * a.tiles + tile] : tile0;
    for (int i = tid; i < tile_live; i += kThreads) op[first + i] = 1;
  }
}

// ---- host side ----------------------------------------------------------

struct Layout {
  int tiles;
  long long hist_at, live_at, row_live_at, info_at, tickets_at, status_at, pairs_at, bytes;
};

long long align256(long long x) { return (x + 255) / 256 * 256; }

Layout make_layout(int rows, int cols, int bins, int digits) {
  Layout l{};
  l.tiles = (cols + kTile - 1) / kTile;
  long long at = 0;
  l.hist_at = at;
  at = align256(at + static_cast<long long>(rows) * digits * bins * 4);
  l.live_at = at;
  at = align256(at + static_cast<long long>(rows) * l.tiles * 4);
  l.row_live_at = at;
  at = align256(at + rows * 4LL);
  l.info_at = at;
  at = align256(at + rows * digits * 4LL);
  l.tickets_at = at;
  at = align256(at + rows * digits * 4LL);
  l.status_at = at;
  at = align256(at + static_cast<long long>(rows) * digits * l.tiles * bins * 4);
  l.pairs_at = at;
  at = align256(at + static_cast<long long>(rows) * cols * 8);
  l.bytes = at;
  return l;
}

template <int BITS>
Layout layout_for(int rows, int cols) {
  return make_layout(rows, cols, Radix<BITS>::kBins, Radix<BITS>::kDigits);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

template <int BITS>
int launch(Args a, void* scratch, cudaStream_t stream) {
  using T = Radix<BITS>;
  const Layout l = layout_for<BITS>(a.rows, a.cols);
  char* s = static_cast<char*>(scratch);
  a.tiles = l.tiles;
  a.hist = reinterpret_cast<int*>(s + l.hist_at);
  a.live_before = reinterpret_cast<int*>(s + l.live_at);
  a.row_live = reinterpret_cast<int*>(s + l.row_live_at);
  a.info = reinterpret_cast<int*>(s + l.info_at);
  a.tickets = reinterpret_cast<int*>(s + l.tickets_at);
  a.status = reinterpret_cast<unsigned*>(s + l.status_at);
  a.pairs = reinterpret_cast<int2*>(s + l.pairs_at);
  if (int e = static_cast<int>(cudaMemsetAsync(
          a.hist, 0, static_cast<size_t>(a.rows) * T::kDigits * T::kBins * 4, stream))) {
    return e;
  }
  const dim3 grid(l.tiles, a.rows);
  spill_hist<BITS><<<grid, kThreads, 0, stream>>>(a);
  if (int e = last_error()) return e;
  spill_plan<BITS><<<a.rows, kThreads, 0, stream>>>(a);
  if (int e = last_error()) return e;
  constexpr int smem = T::kScatterSmem;
  if (int e = static_cast<int>(cudaFuncSetAttribute(
          spill_scatter<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))) {
    return e;
  }
  for (int d = 0; d < T::kDigits; ++d) {
    spill_scatter<BITS><<<grid, kThreads, smem, stream>>>(a, d);
    if (int e = last_error()) return e;
  }
  return 0;
}

}  // namespace

// Scratch bytes a call on (rows, cols) needs.
extern "C" long long spill_sort_scratch(int rows, int cols) {
  return layout_for<kBits>(rows, cols).bytes;
}

// The spill sort of `rows` rows of `cols` slots into the output rows.
// ld_*: row strides in elements.  addend and passes may be null.
extern "C" int spill_sort_launch(const int* keys, long long ld_k, const int* vals,
                                 long long ld_v, const unsigned char* valid, long long ld_p,
                                 int rows, int cols, const int* addend, int* out_k,
                                 long long ld_ok, int* out_v, long long ld_ov,
                                 unsigned char* out_p, long long ld_op, void* scratch,
                                 int* passes, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.keys = keys;
  a.ld_k = ld_k;
  a.vals = vals;
  a.ld_v = ld_v;
  a.valid = valid;
  a.ld_p = ld_p;
  a.rows = rows;
  a.cols = cols;
  a.addend = addend;
  a.out_k = out_k;
  a.ld_ok = ld_ok;
  a.out_v = out_v;
  a.ld_ov = ld_ov;
  a.out_p = out_p;
  a.ld_op = ld_op;
  a.passes = passes;
  return launch<kBits>(a, scratch, stream);
}
