// The lexsort shuffle of the engine as a split of sorted task rows and a
// merge of their runs.
//
// Replaces no Pallas kernel: the reference shuffles with jnp.lexsort, and
// until this kernel the port did the same with torch ops (one stable int64
// sort of the packed (reducer, key) over every pair, three gathers through
// int64 indices, and a capacity-bounded scatter, backends.LexsortShuffle).
// Its plain version, kernels/shuffle_merge/ref.py, is that code.
//
// Contract.  (N, C) int32 keys and values and a bool valid mask, each with
// its own row stride, where each row's valid pairs are non-decreasing in
// key (the map's stable spill sort and the combine leave them so).  Out:
// (out_rows, cap) partitions; partition r < R holds the valid pairs whose
// reducer is r, in ascending key order, ties by row and then by column,
// cut at `cap` (the cut pairs counted in `dropped`), then (PAD_KEY, 0).
// Rows r >= R are all (PAD_KEY, 0).  The reducer is the uint32 Knuth hash
// mod R, as phases.hash_to_reducer computes it in int64.
//
// Design.  The order asked for is a stable split of every row by reducer
// followed by a merge, for each reducer, of the N sorted runs the rows give
// it: Hadoop's own shuffle (map-side spill sort, reduce-side merge of
// sorted segments).  Nothing is sorted by key again.
//   split stage (shuffle_split_launch):
//     1. count: each (row, tile) block hashes its keys and counts its
//        valid pairs by reducer in shared memory;
//     2. scan: the counts, laid out reducer-major, then row, then tile, are
//        scanned exclusively (reduce, top, down-sweep), which gives every
//        (reducer, row, tile) its offset in a staging buffer where each
//        reducer's runs lie one after another in row order;
//     3. plan: one block reads each run's bounds, the pairs cut past `cap`
//        (dropped = sum over r of max(0, n_r - cap)), and for each merge
//        round the exclusive prefix of its merges' output tiles;
//     4. split: each (row, tile) block sorts its pairs stably by reducer
//        (cub block radix sort over ceil(log2(R + 1)) bits, the invalid
//        pairs in bucket R) and writes each reducer's pairs to its run.
//   merge stage (shuffle_merge_launch):
//     5. ceil(log2 N) rounds of merge-path merges of neighbouring runs
//        (pairs of row groups, every reducer in one launch); equal keys
//        are taken from the left (lower-row) run.  A partition pass finds
//        where each 1024-output tile starts in both inputs (one binary
//        search a tile; a tile ends where the next starts), then a block
//        merges its tile in shared memory.  The last round writes the
//        partitions, up to `cap`;
//     6. fill: the partitions' tails (PAD_KEY, 0).
//   With N = 1 the split writes the partitions itself and no round runs.
// Grids are sized from N, C, R and cap alone (blocks past the plan's tile
// count return at once), so the host reads nothing back.
//
// Bound on an H100: memory.  The least traffic is reading keys, values and
// the mask once (9 B a pair) and writing both (out_rows, cap) partitions
// once: at 2^28 pairs, R = 7 and capacity factor 4, 2.42 + 8.59 GB, 3.3 ms
// at 3.35 TB/s.  This design moves about 30 GB there: the count (5 B a
// pair), the split (9 B read, 8 B written), four rounds of 16 B a pair
// (pairs staged as int2, so one load moves a key and its value), and the
// fill.  Staging, loads and stores are coalesced, a merge block's loads
// all issued before its first use; the per-pair arithmetic (hash, radix
// ranks, merge-path compares) mostly hides under the traffic.  Measured at
// that shape: 13.6 ms, against the plain version's 92.0.

#include <cuda_runtime.h>

#include <cub/block/block_load.cuh>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cub/block/block_store.cuh>

namespace {

constexpr int kPadKey = 0x7fffffff;
constexpr unsigned kKnuth = 2654435761u;
constexpr int kMaxBuckets = 1024;  // R <= kMaxBuckets - 1 (bucket R: invalid)

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // slots a count / split block takes

// A merge block writes 1024 outputs.  Measured on an H100 at (16, 2^24),
// R = 7: 4 items a thread take the four rounds' merges 6.1 ms and their
// partition passes 1.2; 8 items 7.4 and 0.6; 16 items 11.6 and 0.3.
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 4;
constexpr int kMergeTile = kMergeThreads * kMergeItems;

constexpr int kFillChunk = 4 * kTile;  // slots a fill block writes in each partition

constexpr int kPlanThreads = 256;
constexpr int kMaxRounds = 16;  // N <= 65535 rows

using LoadI = cub::BlockLoad<int, kThreads, kItems, cub::BLOCK_LOAD_WARP_TRANSPOSE>;
using LoadB = cub::BlockLoad<unsigned char, kThreads, kItems, cub::BLOCK_LOAD_WARP_TRANSPOSE>;
using StoreI = cub::BlockStore<int, kThreads, kItems, cub::BLOCK_STORE_WARP_TRANSPOSE>;
using IntScan = cub::BlockScan<int, kThreads>;
using IntReduce = cub::BlockReduce<int, kThreads>;
using BucketSort = cub::BlockRadixSort<unsigned, kThreads, kItems, int2>;
using PlanScan = cub::BlockScan<int, kPlanThreads>;

__device__ __forceinline__ int reducer_of(int key, unsigned R) {
  unsigned h = static_cast<unsigned>(key) * kKnuth;
  h ^= h >> 16;
  return static_cast<int>(h % R);
}

// Where the scratch's parts lie, and the rounds' sizes; the host and the
// wrapper's size query share it.
struct Layout {
  int rows, cols, R, tiles, rounds;
  long long counts;  // R * rows * tiles
  long long chunks;  // scan chunks of kTile counts
  long long offsets_at, partial_at, bounds_at, plans_at, splits_at, ends_at, stage_at[2], bytes;
  long long plan_base[kMaxRounds];
  long long upper;  // a bound on any round's merge tiles (its grid)
  int merges[kMaxRounds];
};

long long align256(long long x) { return (x + 255) / 256 * 256; }

Layout make_layout(int rows, int cols, int R) {
  Layout l{};
  l.rows = rows;
  l.cols = cols;
  l.R = R;
  l.tiles = (cols + kTile - 1) / kTile;
  while ((1 << l.rounds) < rows) ++l.rounds;
  l.counts = static_cast<long long>(R) * rows * l.tiles;
  l.chunks = (l.counts + kTile - 1) / kTile;
  long long plan_ints = 0;
  for (int s = 0; s < l.rounds; ++s) {
    const int w = 1 << s;
    l.merges[s] = R * ((rows + 2 * w - 1) / (2 * w));
    l.plan_base[s] = plan_ints;
    plan_ints += l.merges[s] + 1;
  }
  const long long pairs = static_cast<long long>(rows) * cols;
  l.upper = (pairs + kMergeTile - 1) / kMergeTile + (l.rounds ? l.merges[0] : 0);
  long long at = 0;
  l.offsets_at = at;
  at = align256(at + (l.counts + 1) * 4);
  l.partial_at = at;
  at = align256(at + (l.chunks + 1) * 4);
  l.bounds_at = at;
  at = align256(at + static_cast<long long>(R) * (rows + 1) * 4);
  l.plans_at = at;
  at = align256(at + (plan_ints + 1) * 4);
  l.splits_at = at;
  at = align256(at + (l.rounds ? l.upper : 0) * 8);
  l.ends_at = at;
  at = align256(at + (l.rounds ? l.merges[0] : 0) * 4);
  for (int b = 0; b < 2; ++b) {
    l.stage_at[b] = at;
    if (l.rounds > b) at = align256(at + pairs * 8);
  }
  l.bytes = at;
  return l;
}

// ---- split stage ------------------------------------------------------

// counts[(r * rows + row) * tiles + tile] = valid pairs of reducer r there.
__global__ void __launch_bounds__(kThreads)
shuffle_count(const int* __restrict__ keys, long long ld_k,
              const unsigned char* __restrict__ valid, long long ld_p, int cols, int R,
              int rows, int tiles, int* __restrict__ counts) {
  __shared__ int hist[kMaxBuckets];
  for (int i = threadIdx.x; i < R; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int row = blockIdx.y, tile = blockIdx.x;
  const int tile0 = tile * kTile;
  const int* rk = keys + row * ld_k + tile0;
  const unsigned char* rp = valid + row * ld_p + tile0;
  const int n = min(kTile, cols - tile0);
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;  // striped: coalesced, order-free
    const bool live = i < n && rp[i] != 0;
    const int b = live ? reducer_of(rk[i], R) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (live && lane == __ffs(peers) - 1) atomicAdd(&hist[b], __popc(peers));
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kThreads) {
    counts[(static_cast<long long>(r) * rows + row) * tiles + tile] = hist[r];
  }
}

// partial[g] = the sum of counts' chunk g.
__global__ void __launch_bounds__(kThreads)
shuffle_scan_reduce(const int* __restrict__ counts, long long n, int* __restrict__ partial) {
  __shared__ IntReduce::TempStorage tmp;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    if (i < n) sum += counts[i];
  }
  const int total = IntReduce(tmp).Sum(sum);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// One block: partial becomes its exclusive prefix sum; *total_out the sum.
__global__ void __launch_bounds__(kThreads)
shuffle_scan_top(int* __restrict__ partial, long long chunks, int* __restrict__ total_out) {
  __shared__ IntScan::TempStorage tmp;
  int carry = 0;
  for (long long base = 0; base < chunks; base += kThreads) {
    const long long i = base + threadIdx.x;
    const int x = i < chunks ? partial[i] : 0;
    int excl, total;
    IntScan(tmp).ExclusiveSum(x, excl, total);
    if (i < chunks) partial[i] = carry + excl;
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total_out = carry;
}

// In place: counts' chunk g becomes its exclusive prefix sum plus partial[g].
__global__ void __launch_bounds__(kThreads)
shuffle_scan_down(int* __restrict__ counts, long long n, const int* __restrict__ partial) {
  __shared__ union {
    LoadI::TempStorage load;
    IntScan::TempStorage scan;
    StoreI::TempStorage store;
  } tmp;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int valid = static_cast<int>(min(static_cast<long long>(kTile), n - base));
  int x[kItems];
  LoadI(tmp.load).Load(counts + base, x, valid, 0);
  __syncthreads();
  IntScan(tmp.scan).ExclusiveSum(x, x);
  __syncthreads();
  const int carry = partial[blockIdx.x];
#pragma unroll
  for (int j = 0; j < kItems; ++j) x[j] += carry;
  StoreI(tmp.store).Store(counts + base, x, valid);
}

// One block.  bounds[r * (rows + 1) + k]: where reducer r's run of row k
// starts in the staging order (k = rows: where the reducer ends); dropped;
// and for each round s, plans + plan_base[s] holds the exclusive prefix of
// its merges' output tiles and, last, their total.
__global__ void __launch_bounds__(kPlanThreads)
shuffle_plan(const int* __restrict__ offsets, int* __restrict__ bounds, int* __restrict__ plans,
             int* __restrict__ dropped, int rows, int R, int tiles, int rounds, int cap) {
  __shared__ PlanScan::TempStorage tmp;
  const int stride = rows + 1;
  for (int idx = threadIdx.x; idx < R * stride; idx += kPlanThreads) {
    const int r = idx / stride, k = idx % stride;
    bounds[idx] = offsets[(static_cast<long long>(r) * rows + k) * tiles];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long cut = 0;
    for (int r = 0; r < R; ++r) {
      const int n = bounds[r * stride + rows] - bounds[r * stride];
      cut += n > cap ? n - cap : 0;
    }
    *dropped = static_cast<int>(cut);
  }
  int* plan = plans;
  for (int s = 0; s < rounds; ++s) {
    const int w = 1 << s;
    const int per_r = (rows + 2 * w - 1) / (2 * w);
    const int merges = R * per_r;
    const bool last = s == rounds - 1;
    int carry = 0;
    for (int base = 0; base < merges; base += kPlanThreads) {
      const int m = base + threadIdx.x;
      int n_tiles = 0;
      if (m < merges) {
        const int r = m / per_r, row0 = (m % per_r) * 2 * w;
        const int* b = bounds + r * stride;
        int len = b[min(row0 + 2 * w, rows)] - b[row0];
        if (last) len = min(len, cap);
        n_tiles = (len + kMergeTile - 1) / kMergeTile;
      }
      int excl, total;
      PlanScan(tmp).ExclusiveSum(n_tiles, excl, total);
      if (m < merges) plan[m] = carry + excl;
      carry += total;
      __syncthreads();
    }
    if (threadIdx.x == 0) plan[merges] = carry;
    plan += merges + 1;
  }
}

// Each (row, tile) block: its valid pairs, stably sorted by reducer, into
// their runs: the staging buffer, or with one row the partitions.
__global__ void __launch_bounds__(kThreads)
shuffle_split(const int* __restrict__ keys, long long ld_k, const int* __restrict__ vals,
              long long ld_v, const unsigned char* __restrict__ valid, long long ld_p,
              int cols, int R, int rows, int tiles, const int* __restrict__ offsets,
              const int* __restrict__ bounds, int direct, int cap, int2* __restrict__ stage,
              int* __restrict__ part_k, int* __restrict__ part_v) {
  __shared__ union {
    IntScan::TempStorage scan;
    LoadI::TempStorage load_i;
    LoadB::TempStorage load_b;
    BucketSort::TempStorage sort;
  } tmp;
  __shared__ int first[kMaxBuckets];  // the bucket's first sorted slot in the tile
  __shared__ int dest[kMaxBuckets];   // where that slot goes

  const int row = blockIdx.y, tile = blockIdx.x;
  int carry = 0;
  for (int base = 0; base < R; base += kThreads) {
    const int r = base + threadIdx.x;
    int count = 0, at = 0;
    if (r < R) {
      const long long idx = (static_cast<long long>(r) * rows + row) * tiles + tile;
      at = offsets[idx];
      count = offsets[idx + 1] - at;
      if (direct) at -= bounds[r * (rows + 1)];
    }
    int excl, total;
    IntScan(tmp.scan).ExclusiveSum(count, excl, total);
    if (r < R) {
      first[r] = carry + excl;
      dest[r] = at;
    }
    carry += total;
    __syncthreads();
  }

  const int tile0 = tile * kTile;
  const int n = min(kTile, cols - tile0);
  int k[kItems], v[kItems];
  unsigned char p[kItems];
  LoadI(tmp.load_i).Load(keys + row * ld_k + tile0, k, n, 0);
  __syncthreads();
  LoadI(tmp.load_i).Load(vals + row * ld_v + tile0, v, n, 0);
  __syncthreads();
  LoadB(tmp.load_b).Load(valid + row * ld_p + tile0, p, n, 0);
  __syncthreads();

  unsigned bucket[kItems];
  int2 pair[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    bucket[j] = p[j] ? static_cast<unsigned>(reducer_of(k[j], R)) : static_cast<unsigned>(R);
    pair[j] = make_int2(k[j], v[j]);
  }
  const int bits = 32 - __clz(R);  // buckets 0..R
  BucketSort(tmp.sort).SortBlockedToStriped(bucket, pair, 0, bits);

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int b = static_cast<int>(bucket[j]);
    if (b >= R) continue;
    const int slot = j * kThreads + threadIdx.x;  // striped: the sorted position
    const int at = dest[b] + slot - first[b];
    if (!direct) {
      stage[at] = pair[j];
    } else if (at < cap) {
      const long long o = static_cast<long long>(b) * cap + at;
      part_k[o] = pair[j].x;
      part_v[o] = pair[j].y;
    }
  }
}

// ---- merge stage ------------------------------------------------------

// Merge m of a round (reducer r, row groups [row0, row0 + w) and
// [row0 + w, row0 + 2w)): A = [a, mid), B = [mid, end) of the input.
struct Merge {
  int r, a, mid, end, len;
};

__device__ __forceinline__ Merge merge_of(const int* bounds, int rows, int w, int per_r,
                                          int m, bool last, int cap) {
  Merge g;
  g.r = m / per_r;
  const int row0 = (m % per_r) * 2 * w;
  const int* b = bounds + g.r * (rows + 1);
  g.a = b[row0];
  g.mid = b[min(row0 + w, rows)];
  g.end = b[min(row0 + 2 * w, rows)];
  g.len = last ? min(g.end - g.a, cap) : g.end - g.a;
  return g;
}

// The number of A's elements among the first `diag` outputs of the stable
// merge of sorted A and B that takes A's element first on equal keys.
template <typename KeyA, typename KeyB>
__device__ __forceinline__ int merge_path(KeyA a, int la, KeyB b, int lb, int diag) {
  int lo = max(0, diag - lb), hi = min(diag, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a(mid) <= b(diag - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One thread an output tile of the round: {its merge, A's elements before
// the tile}; the thread of a merge's last tile also writes A's elements
// before the merge's end (a tile's end is the next tile's start).
__global__ void __launch_bounds__(kThreads)
shuffle_merge_partition(const int2* __restrict__ in, const int* __restrict__ bounds,
                        const int* __restrict__ plan, int2* __restrict__ splits,
                        int* __restrict__ ends, int rows, int R, int w, int last, int cap) {
  const int per_r = (rows + 2 * w - 1) / (2 * w);
  const int merges = R * per_r;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= plan[merges]) return;
  int lo = 0, hi = merges;  // the last merge whose first tile is <= t
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (plan[mid] <= t) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const Merge g = merge_of(bounds, rows, w, per_r, lo, last, cap);
  const int2* A = in + g.a;
  const int2* B = in + g.mid;
  auto ka = [A](int i) { return A[i].x; };
  auto kb = [B](int i) { return B[i].x; };
  const int la = g.mid - g.a, lb = g.end - g.mid;
  splits[t] = make_int2(lo, merge_path(ka, la, kb, lb, (t - plan[lo]) * kMergeTile));
  if (t + 1 == plan[lo + 1]) ends[lo] = merge_path(ka, la, kb, lb, g.len);
}

__global__ void __launch_bounds__(kMergeThreads)
shuffle_merge_round(const int2* __restrict__ in, int2* __restrict__ out,
                    int* __restrict__ part_k, int* __restrict__ part_v,
                    const int* __restrict__ bounds, const int* __restrict__ plan,
                    const int2* __restrict__ splits, const int* __restrict__ ends, int rows,
                    int R, int w, int last, int cap) {
  __shared__ int2 buf[kMergeTile];
  const int per_r = (rows + 2 * w - 1) / (2 * w);
  const int t = blockIdx.x;
  if (t >= plan[R * per_r]) return;
  const int2 sp = splits[t];
  const Merge g = merge_of(bounds, rows, w, per_r, sp.x, last, cap);
  const int o0 = (t - plan[sp.x]) * kMergeTile, n = min(kMergeTile, g.len - o0);
  const int a_end = t + 1 == plan[sp.x + 1] ? ends[sp.x] : splits[t + 1].y;
  const int la = a_end - sp.y, lb = n - la;
  const int2* A = in + g.a + sp.y;
  const int2* B = in + g.mid + (o0 - sp.y);
  int2 x[kMergeItems];
#pragma unroll
  for (int j = 0; j < kMergeItems; ++j) {  // all loads in flight at once
    const int i = j * kMergeThreads + threadIdx.x;
    if (i < n) x[j] = i < la ? A[i] : B[i - la];
  }
#pragma unroll
  for (int j = 0; j < kMergeItems; ++j) {
    const int i = j * kMergeThreads + threadIdx.x;
    if (i < n) buf[i] = x[j];
  }
  __syncthreads();

  const int diag = min(static_cast<int>(threadIdx.x) * kMergeItems, n);
  const int2* sb = buf;
  auto ka = [sb](int i) { return sb[i].x; };
  auto kb = [sb, la](int i) { return sb[la + i].x; };
  int ai = merge_path(ka, la, kb, lb, diag);
  int bi = diag - ai;
#pragma unroll
  for (int j = 0; j < kMergeItems; ++j) {
    if (diag + j < n) {
      const bool take_a = ai < la && (bi >= lb || buf[ai].x <= buf[la + bi].x);
      x[j] = take_a ? buf[ai++] : buf[la + bi++];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMergeItems; ++j) {
    if (diag + j < n) buf[diag + j] = x[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMergeItems; ++j) {
    const int i = j * kMergeThreads + threadIdx.x;
    if (i < n) x[j] = buf[i];
  }
  if (last) {
    const long long o = static_cast<long long>(g.r) * cap + o0;
#pragma unroll
    for (int j = 0; j < kMergeItems; ++j) {
      const int i = j * kMergeThreads + threadIdx.x;
      if (i < n) {
        part_k[o + i] = x[j].x;
        part_v[o + i] = x[j].y;
      }
    }
  } else {
    int2* dst = out + g.a + o0;
#pragma unroll
    for (int j = 0; j < kMergeItems; ++j) {
      const int i = j * kMergeThreads + threadIdx.x;
      if (i < n) dst[i] = x[j];
    }
  }
}

// x into p[lo, hi) by the block: 16-byte stores between scalar edges.
__device__ __forceinline__ void fill_span(int* p, long long lo, long long hi, int x) {
  if (lo >= hi) return;
  const int mis = static_cast<int>((reinterpret_cast<unsigned long long>(p + lo) >> 2) & 3);
  const long long a = min(hi, lo + ((4 - mis) & 3));  // first 16-byte-aligned slot
  const long long n4 = (hi - a) >> 2;
  if (threadIdx.x < a - lo) p[lo + threadIdx.x] = x;
  int4* q = reinterpret_cast<int4*>(p + a);
  const int4 x4 = make_int4(x, x, x, x);
  for (long long i = threadIdx.x; i < n4; i += kThreads) q[i] = x4;
  const long long b = a + 4 * n4;
  if (threadIdx.x < hi - b) p[b + threadIdx.x] = x;
}

// (PAD_KEY, 0) from each partition's live end (all of rows >= R) to cap.
__global__ void __launch_bounds__(kThreads)
shuffle_fill(int* __restrict__ part_k, int* __restrict__ part_v, const int* __restrict__ bounds,
             int rows, int R, int cap) {
  const int r = blockIdx.y;
  int live = 0;
  if (r < R) {
    const int* b = bounds + r * (rows + 1);
    live = min(b[rows] - b[0], cap);
  }
  const long long chunk0 = static_cast<long long>(blockIdx.x) * kFillChunk;
  const long long lo = max(chunk0, static_cast<long long>(live));
  const long long hi = min(chunk0 + kFillChunk, static_cast<long long>(cap));
  const long long o = static_cast<long long>(r) * cap;
  fill_span(part_k + o, lo, hi, kPadKey);
  fill_span(part_v + o, lo, hi, 0);
}

template <typename T>
T* carve(void* scratch, long long offset) {
  return reinterpret_cast<T*>(static_cast<char*>(scratch) + offset);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Scratch bytes the two stages need for (rows, cols) pairs over R reducers.
extern "C" long long shuffle_merge_scratch(int rows, int cols, int R) {
  return make_layout(rows, cols, R).bytes;
}

extern "C" int shuffle_merge_max_reducers() { return kMaxBuckets - 1; }

// Stage 1: count, scan, plan, split.  ld_*: row strides in elements.
extern "C" int shuffle_split_launch(const int* keys, long long ld_k, const int* vals,
                                    long long ld_v, const unsigned char* valid, long long ld_p,
                                    int rows, int cols, int R, int cap, int out_rows,
                                    void* scratch, int* part_k, int* part_v, int* dropped,
                                    cudaStream_t stream) {
  (void)out_rows;
  if (rows <= 0 || cols <= 0 || R <= 0 || R >= kMaxBuckets || cap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout l = make_layout(rows, cols, R);
  int* offsets = carve<int>(scratch, l.offsets_at);
  int* partial = carve<int>(scratch, l.partial_at);
  int* bounds = carve<int>(scratch, l.bounds_at);
  const dim3 grid(l.tiles, rows);
  shuffle_count<<<grid, kThreads, 0, stream>>>(keys, ld_k, valid, ld_p, cols, R, rows, l.tiles,
                                               offsets);
  if (int e = last_error()) return e;
  shuffle_scan_reduce<<<l.chunks, kThreads, 0, stream>>>(offsets, l.counts, partial);
  if (int e = last_error()) return e;
  shuffle_scan_top<<<1, kThreads, 0, stream>>>(partial, l.chunks, offsets + l.counts);
  if (int e = last_error()) return e;
  shuffle_scan_down<<<l.chunks, kThreads, 0, stream>>>(offsets, l.counts, partial);
  if (int e = last_error()) return e;
  shuffle_plan<<<1, kPlanThreads, 0, stream>>>(offsets, bounds, carve<int>(scratch, l.plans_at),
                                               dropped, rows, R, l.tiles, l.rounds, cap);
  if (int e = last_error()) return e;
  shuffle_split<<<grid, kThreads, 0, stream>>>(
      keys, ld_k, vals, ld_v, valid, ld_p, cols, R, rows, l.tiles, offsets, bounds,
      l.rounds == 0, cap, carve<int2>(scratch, l.stage_at[0]), part_k, part_v);
  return last_error();
}

// Stage 2: the merge rounds into the partitions, then their tails.
extern "C" int shuffle_merge_launch(const int* keys, long long ld_k, const int* vals,
                                    long long ld_v, const unsigned char* valid, long long ld_p,
                                    int rows, int cols, int R, int cap, int out_rows,
                                    void* scratch, int* part_k, int* part_v, int* dropped,
                                    cudaStream_t stream) {
  (void)keys, (void)ld_k, (void)vals, (void)ld_v, (void)valid, (void)ld_p, (void)dropped;
  if (rows <= 0 || cols <= 0 || R <= 0 || R >= kMaxBuckets || cap <= 0 || out_rows < R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout l = make_layout(rows, cols, R);
  const int* bounds = carve<int>(scratch, l.bounds_at);
  int2* splits = carve<int2>(scratch, l.splits_at);
  int* ends = carve<int>(scratch, l.ends_at);
  for (int s = 0; s < l.rounds; ++s) {
    const int* plan = carve<int>(scratch, l.plans_at) + l.plan_base[s];
    const int2* in = carve<int2>(scratch, l.stage_at[s % 2]);
    int2* out = carve<int2>(scratch, l.stage_at[(s + 1) % 2]);
    const int last = s == l.rounds - 1;
    const int w = 1 << s;
    shuffle_merge_partition<<<(l.upper + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        in, bounds, plan, splits, ends, rows, R, w, last, cap);
    if (int e = last_error()) return e;
    shuffle_merge_round<<<l.upper, kMergeThreads, 0, stream>>>(
        in, last ? nullptr : out, part_k, part_v, bounds, plan, splits, ends, rows, R, w, last,
        cap);
    if (int e = last_error()) return e;
  }
  const dim3 fill_grid((static_cast<long long>(cap) + kFillChunk - 1) / kFillChunk, out_rows);
  shuffle_fill<<<fill_grid, kThreads, 0, stream>>>(part_k, part_v, bounds, rows, R, cap);
  return last_error();
}
