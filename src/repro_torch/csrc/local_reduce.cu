// Local reduce (map-side combine) for the combine barrier of the engine.
//
// Replaces the Pallas TPU kernel src/repro/kernels/local_reduce/kernel.py
// (_local_reduce_kernel, called by local_reduce_fwd): for each (N, C) row
// of key-sorted, PAD_KEY-tailed int32 keys, run i's key and sum go to slot
// i, in ascending key order, with a (PAD_KEY, 0) tail.
//
// Design.  The TPU kernel indexes a C x C one-hot by segment id; here the
// compaction is a stream compaction over the row, tiled along it like
// segment_reduce (grid (ceil(C / kTile), N)), in three launches:
//   1. count the run heads of every tile;
//   2. exclusive-scan each row's tile counts, one block per row, giving
//      each tile the slot of its first head;
//   3. write ck[slot] = key at every head (slot = tile offset + the head's
//      rank in the tile) and each run's partial sum into cv[slot]: a plain
//      store when the run lies wholly in the tile, else an atomicAdd.  A
//      run that began in an earlier tile owns slot (tile offset - 1).
// The wrapper fills ck with PAD_KEY and cv with 0 and allocates the
// (N, tiles) count scratch; the kernels allocate nothing.  Sums are int32.
//
// Bound on an H100: memory.  Reading keys and values (8 B per slot) and
// writing ck and cv (8 B) is 16 B per slot at 3.35 TB/s.  Pass 1 reads the
// keys a second time (4 B more per slot); passes 1 and 2 touch
// N * tiles counters, 1/4096 of the row.

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

__global__ void __launch_bounds__(kThreads)
local_reduce_count(const int* __restrict__ keys, int* __restrict__ counts, int n_cols,
                   int n_tiles) {
  __shared__ union {
    Load::TempStorage load;
    IntReduce::TempStorage reduce;
  } tmp;
  __shared__ Edges edges;

  const int* rk = keys + static_cast<long long>(blockIdx.y) * n_cols;
  const int tile0 = blockIdx.x * kTile;
  int k[kItems];
  Load(tmp.load).Load(rk + tile0, k, min(kTile, n_cols - tile0), kPadKey);
  __syncthreads();

  bool head[kItems], flush[kItems], whole[kItems];
  classify(k, rk, tile0, n_cols, edges, head, flush, whole);
  int count = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) count += head[j] ? 1 : 0;
  const int total = IntReduce(tmp.reduce).Sum(count);
  if (threadIdx.x == 0) {
    counts[static_cast<long long>(blockIdx.y) * n_tiles + blockIdx.x] = total;
  }
}

// In place: counts[row, :] becomes its exclusive prefix sum.
__global__ void __launch_bounds__(kThreads)
local_reduce_offsets(int* __restrict__ counts, int n_tiles) {
  __shared__ IntScan::TempStorage tmp;
  int* c = counts + static_cast<long long>(blockIdx.x) * n_tiles;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += kThreads) {
    const int i = base + threadIdx.x;
    const int x = i < n_tiles ? c[i] : 0;
    int excl, total;
    IntScan(tmp).ExclusiveSum(x, excl, total);
    if (i < n_tiles) c[i] = carry + excl;
    carry += total;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
local_reduce_write(const int* __restrict__ keys, const int* __restrict__ vals,
                   const int* __restrict__ offsets, int* __restrict__ ck,
                   int* __restrict__ cv, int n_cols, int n_tiles) {
  __shared__ union {
    Load::TempStorage load;
    IntScan::TempStorage rank;
    SegScan::TempStorage scan;
  } tmp;
  __shared__ Edges edges;

  const long long row_off = static_cast<long long>(blockIdx.y) * n_cols;
  const int* rk = keys + row_off;
  const int* rv = vals + row_off;
  const int tile0 = blockIdx.x * kTile;
  const int n = min(kTile, n_cols - tile0);

  int k[kItems], v[kItems];
  Load(tmp.load).Load(rk + tile0, k, n, kPadKey);
  __syncthreads();
  Load(tmp.load).Load(rv + tile0, v, n, 0);
  __syncthreads();

  bool head[kItems], flush[kItems], whole[kItems];
  classify(k, rk, tile0, n_cols, edges, head, flush, whole);

  int is_head[kItems], rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) is_head[j] = head[j] ? 1 : 0;
  IntScan(tmp.rank).ExclusiveSum(is_head, rank);
  __syncthreads();

  Seg in[kItems], out[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = k[j] != kPadKey;
    in[j] = Seg{is_head[j], live ? static_cast<unsigned>(v[j]) : 0u,
                head[j] ? rank[j] : -1};
  }
  SegScan(tmp.scan).InclusiveScan(in, out, SegOp());

  const int base = offsets[static_cast<long long>(blockIdx.y) * n_tiles + blockIdx.x];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (head[j]) ck[row_off + base + rank[j]] = k[j];
    if (flush[j]) {
      const int sum = static_cast<int>(out[j].sum);
      const int slot = out[j].tag >= 0 ? base + out[j].tag : base - 1;
      if (out[j].tag >= 0 && whole[j]) {
        cv[row_off + slot] = sum;
      } else {
        atomicAdd(cv + row_off + slot, sum);
      }
    }
  }
}

}  // namespace

extern "C" int local_reduce_tiles(int n_cols) { return (n_cols + kTile - 1) / kTile; }

// counts: N * local_reduce_tiles(n_cols) int32 scratch.
extern "C" int local_reduce_launch(const int* keys, const int* vals, int* ck, int* cv,
                                   int* counts, int n_rows, int n_cols,
                                   cudaStream_t stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  const int n_tiles = local_reduce_tiles(n_cols);
  const dim3 grid(n_tiles, n_rows);
  local_reduce_count<<<grid, kThreads, 0, stream>>>(keys, counts, n_cols, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  local_reduce_offsets<<<n_rows, kThreads, 0, stream>>>(counts, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  local_reduce_write<<<grid, kThreads, 0, stream>>>(keys, vals, counts, ck, cv, n_cols,
                                                    n_tiles);
  return static_cast<int>(cudaGetLastError());
}
