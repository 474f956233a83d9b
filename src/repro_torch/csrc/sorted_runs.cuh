// Shared tile machinery of the segment_reduce and local_reduce kernels.
//
// Both kernels aggregate equal-key runs of key-sorted int32 rows whose
// dead slots hold PAD_KEY (int32 max) at the tail.  A row can be one slot
// wide or 53.7 M slots wide (one reduce task at 2^26 tokens and R = 5), so
// the grid tiles ALONG the row: block (x, y) takes tile x of row y, one
// kTile-slot tile per block, kItems consecutive slots per thread.
//
// Within a tile, each slot is classified (head of a run, last slot of its
// run inside the tile) and a block-wide segmented inclusive scan gives
// every run's partial sum at its last in-tile slot.  Each kernel finishes
// the runs that cross a tile edge its own way, exactly and independently
// of block scheduling (local_reduce with integer atomics, segment_reduce
// by reading the later tiles' published partial sums).

#pragma once

#include <cuda_runtime.h>

#include <cub/block/block_load.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cub/block/block_store.cuh>

namespace sorted_runs {

constexpr int kPadKey = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;

using Load = cub::BlockLoad<int, kThreads, kItems, cub::BLOCK_LOAD_WARP_TRANSPOSE>;
using Store = cub::BlockStore<int, kThreads, kItems, cub::BLOCK_STORE_WARP_TRANSPOSE>;
using IntScan = cub::BlockScan<int, kThreads>;
using IntReduce = cub::BlockReduce<int, kThreads>;

// Scan element of the segmented sum: `head` marks a run's first slot,
// `sum` is the running sum (unsigned, so int32 wrap-around is defined),
// `tag` identifies the run's head inside the tile, or is -1 for a run that
// began in an earlier tile.
struct Seg {
  int head;
  unsigned sum;
  int tag;
};

struct SegOp {
  __device__ __forceinline__ Seg operator()(const Seg& a, const Seg& b) const {
    return b.head ? b : Seg{a.head, a.sum + b.sum, a.tag};
  }
};

using SegScan = cub::BlockScan<Seg, kThreads>;

// Each thread's first and last key, for the neighbours across thread edges.
struct Edges {
  int first[kThreads];
  int last[kThreads];
};

// Per-slot flags of one tile.
//   head[j]  — a run starts here: a live slot that is the row's first or
//              whose key differs from its predecessor;
//   flush[j] — the run's last slot inside this tile (the next key differs,
//              or this is the tile's last slot);
//   whole[j] — with flush: the run also ends here (the next key differs),
//              so a run whose head is in the tile lies wholly inside it.
// `row` points at the row's first slot (for the keys across the tile edge).
__device__ __forceinline__ void classify(const int (&k)[kItems], const int* row,
                                         int tile0, int n_cols, Edges& edges,
                                         bool (&head)[kItems], bool (&flush)[kItems],
                                         bool (&whole)[kItems]) {
  const int t = threadIdx.x;
  edges.first[t] = k[0];
  edges.last[t] = k[kItems - 1];
  __syncthreads();
  const int prev = t > 0 ? edges.last[t - 1] : (tile0 > 0 ? row[tile0 - 1] : kPadKey);
  const int succ = tile0 + kTile;  // first slot of the next tile
  const int next = t < kThreads - 1 ? edges.first[t + 1]
                                    : (succ < n_cols ? row[succ] : kPadKey);
  const bool last_thread = t == kThreads - 1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int key = k[j];
    const bool live = key != kPadKey;
    const int p = j == 0 ? prev : k[j - 1];
    const int nx = j == kItems - 1 ? next : k[j + 1];
    const bool row_start = tile0 + t * kItems + j == 0;
    head[j] = live && (row_start || key != p);
    whole[j] = live && key != nx;
    flush[j] = whole[j] || (live && last_thread && j == kItems - 1);
  }
}

}  // namespace sorted_runs
