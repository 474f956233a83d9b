// Sorted segment reduce for the reduce tasks of the MapReduce engine.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_reduce/kernel.py
// (_segment_reduce_kernel, called by segment_reduce_fwd): for each (N, C)
// row of key-sorted, PAD_KEY-tailed int32 keys, the sum of each equal-key
// run at the run's first slot, (PAD_KEY, 0) elsewhere.  Each run's sum
// also gets its row's entry of an optional (N,) int32 addend (a reduce
// task's startup value).  The outputs are given by the caller: a reduce
// wave writes straight into its rows of the (R, C) reduce outputs.
//
// Design.  The TPU kernel builds a C x C one-hot matrix to feed the MXU;
// that is O(C^2) work and memory and is not carried over.  On the main
// path a reduce wave is a few rows of about 4n/R slots (153 M at 2^28
// tokens and R = 7), so the grid tiles along the rows: one kTile-slot
// tile a block, kItems consecutive slots a thread.  Each block classifies
// its tile's slots, runs a block-wide segmented scan and writes every slot
// of its tile exactly once, out_v staged in shared memory so that both
// outputs leave in coalesced lines.  Nothing is zeroed beforehand.
//
// A run that crosses tile edges is summed at its head by the head's tile:
// every tile publishes the partial sum of its leading run (the run its
// first slot belongs to) and whether that run goes on past the tile's
// end, and the head's tile reads the tiles after it until the run ends.
// Tiles are taken in reverse order through a ticket counter, so every tile
// a block waits for was taken before it and publishes without waiting:
// the wait always ends.  Sums accumulate in 32-bit unsigned arithmetic, so
// int32 sums wrap as the plain version's do and are exact at every size
// (the Pallas kernel's float32 MXU sum is exact only below 2^24).
//
// A tile whose first key is PAD_KEY is all PAD (rows are sorted): it
// writes (PAD_KEY, 0) without reading its operands.
//
// Bound on an H100: memory.  It reads 8 B a live slot (key, value) and
// writes 8 B a slot (out_k, out_v), at 3.35 TB/s.

#include <algorithm>
#include <climits>

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

// A tile's status word: kPublished once written, kContinues when its
// leading run goes on into the next tile, the run's partial sum in the low
// 32 bits.
constexpr unsigned long long kPublished = 1ull << 63;
constexpr unsigned long long kContinues = 1ull << 32;

__device__ __forceinline__ void publish(unsigned long long* status, unsigned sum,
                                        bool continues) {
  atomicExch(status, kPublished | (continues ? kContinues : 0ull) | sum);
}

__device__ __forceinline__ unsigned long long wait_for(const unsigned long long* status) {
  unsigned long long word;
  do {
    word = *reinterpret_cast<const volatile unsigned long long*>(status);
  } while (!(word & kPublished));
  return word;
}

// The sum of the runs that carry a run across tile edges: the leading-run
// partials of tiles first, first + 1, ... up to and including the first
// tile where the run ends (never past `last`, the row's last tile).  Run
// by one warp, 32 tiles a round after a first round of one tile (most runs
// end in the next tile).
__device__ unsigned carried_sum(const unsigned long long* status, long long first,
                                long long last) {
  const int lane = threadIdx.x & 31;
  unsigned acc = 0;
  int width = 1;
  for (long long base = first;; base += width, width = 32) {
    const long long t = base + lane;
    unsigned long long word = kPublished;  // past the row: ends, adds 0
    if (lane < width && t <= last) word = wait_for(status + t);
    const bool ends = lane < width && !(word & kContinues);
    const unsigned ended = __ballot_sync(0xffffffffu, ends);
    const int upto = ended ? __ffs(ended) - 1 : width - 1;
    acc += __reduce_add_sync(0xffffffffu,
                             lane <= upto ? static_cast<unsigned>(word) : 0u);
    if (ended) return acc;
  }
}

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                      int* __restrict__ out_k, int* __restrict__ out_v,
                      const int* __restrict__ addend, int n_cols, int tiles_per_row,
                      unsigned long long* __restrict__ status, unsigned* __restrict__ ticket) {
  __shared__ union {
    Load::TempStorage load;
    Store::TempStorage store;
    SegScan::TempStorage scan;
    int vals[kTile];
  } tmp;
  __shared__ Edges edges;
  __shared__ long long s_tile;
  __shared__ int s_first_key;
  __shared__ int s_cross_at;        // head slot of the run crossing out, or -1
  __shared__ unsigned s_cross_sum;  // that run's sum inside this tile

  if (threadIdx.x == 0) {
    s_tile = static_cast<long long>(gridDim.x) - 1 - atomicAdd(ticket, 1u);
  }
  __syncthreads();
  const long long tile = s_tile;
  const long long row = tile / tiles_per_row;
  const int tile0 = static_cast<int>(tile - row * tiles_per_row) * kTile;
  const int n = min(kTile, n_cols - tile0);
  const long long row_off = row * n_cols;
  const int* rk = keys + row_off;
  const int* rv = vals + row_off;
  int* ok_row = out_k + row_off + tile0;
  int* ov_row = out_v + row_off + tile0;

  if (threadIdx.x == 0) {
    s_first_key = rk[tile0];
    s_cross_at = -1;
  }
  __syncthreads();
  if (s_first_key == kPadKey) {
    // All PAD: no run starts, none crosses in.
    if (threadIdx.x == 0) publish(status + tile, 0u, false);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      ok_row[i] = kPadKey;
      ov_row[i] = 0;
    }
    return;
  }

  int k[kItems], v[kItems];
  Load(tmp.load).Load(rk + tile0, k, n, kPadKey);
  __syncthreads();
  Load(tmp.load).Load(rv + tile0, v, n, 0);
  __syncthreads();

  bool head[kItems], flush[kItems], whole[kItems];
  classify(k, rk, tile0, n_cols, edges, head, flush, whole);

  Seg in[kItems], out[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = k[j] != kPadKey;
    in[j] = Seg{head[j] ? 1 : 0, live ? static_cast<unsigned>(v[j]) : 0u,
                head[j] ? static_cast<int>(threadIdx.x) * kItems + j : -1};
  }
  SegScan(tmp.scan).InclusiveScan(in, out, SegOp());
  __syncthreads();

  for (int i = threadIdx.x; i < kTile; i += kThreads) tmp.vals[i] = 0;
  __syncthreads();

  const unsigned add = addend ? static_cast<unsigned>(addend[row]) : 0u;
  if (threadIdx.x == 0 && head[0]) publish(status + tile, 0u, false);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (!flush[j]) continue;
    if (out[j].tag < 0) {
      // The leading run, begun in an earlier tile: its head's tile reads it.
      publish(status + tile, out[j].sum, !whole[j]);
    } else if (whole[j]) {
      tmp.vals[out[j].tag] = static_cast<int>(out[j].sum + add);
    } else {
      // A run from a head here into the next tile (only the last slot).
      s_cross_at = out[j].tag;
      s_cross_sum = out[j].sum;
    }
  }
  __syncthreads();

  if (s_cross_at >= 0 && threadIdx.x < 32) {
    const unsigned rest = carried_sum(status, tile + 1, (row + 1) * tiles_per_row - 1);
    if (threadIdx.x == 0) tmp.vals[s_cross_at] = static_cast<int>(s_cross_sum + rest + add);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += kThreads) ov_row[i] = tmp.vals[i];
  __syncthreads();

  int okeys[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) okeys[j] = head[j] ? k[j] : kPadKey;
  Store(tmp.store).Store(ok_row, okeys, n);
}

long long tiles_per_row(int n_cols) { return (n_cols + kTile - 1) / kTile; }

// The exact int64 key sum of each row, PAD tail included, reading only the
// live prefix: a block walks its row's tiles with a stride of gridDim.x and
// stops at the first PAD-led tile (all later ones are PAD too).  The tile
// the PAD tail starts in sums its PAD slots with the rest; the whole tiles
// after it add (slots after the tile) * PAD_KEY, counted by the last tile
// that leads with a live key; an all-PAD row adds C * PAD_KEY once.
__global__ void __launch_bounds__(kThreads)
row_key_sums_kernel(const int* __restrict__ keys, int n_cols, int tiles_per_row,
                    unsigned long long* __restrict__ sums) {
  using SumReduce = cub::BlockReduce<long long, kThreads>;
  __shared__ SumReduce::TempStorage tmp;
  const int* rk = keys + static_cast<long long>(blockIdx.y) * n_cols;
  long long acc = 0;
  for (int tile = blockIdx.x; tile < tiles_per_row; tile += gridDim.x) {
    const int tile0 = tile * kTile;
    const int n = min(kTile, n_cols - tile0);
    if (rk[tile0] == kPadKey) {
      if (tile == 0 && threadIdx.x == 0) acc += static_cast<long long>(n_cols) * kPadKey;
      break;
    }
    if (n == kTile) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) acc += rk[tile0 + j * kThreads + threadIdx.x];
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) acc += rk[tile0 + i];
    }
    const int after = tile0 + n;
    if (threadIdx.x == 0 && after < n_cols && rk[after] == kPadKey) {
      acc += static_cast<long long>(n_cols - after) * kPadKey;
    }
  }
  const long long total = SumReduce(tmp).Sum(acc);
  if (threadIdx.x == 0 && total != 0) {
    atomicAdd(sums + blockIdx.y, static_cast<unsigned long long>(total));
  }
}

}  // namespace

// Each row's int64 key sum into sums[0, n_rows), which it zeroes first.
extern "C" int row_key_sums_launch(const int* keys, long long* sums, int n_rows, int n_cols,
                                   int n_sms, cudaStream_t stream) {
  if (n_rows <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(sums, 0, n_rows * sizeof(long long), stream);
  if (err != cudaSuccess || n_cols <= 0) return static_cast<int>(err);
  const long long per_row = tiles_per_row(n_cols);
  // About eight blocks an SM in all: enough loads in flight to stream the
  // live prefixes, few enough that the atomics into one row do not queue.
  const long long blocks = std::max(1LL, std::min(per_row, 8LL * n_sms / n_rows));
  const dim3 grid(static_cast<unsigned>(blocks), n_rows);
  row_key_sums_kernel<<<grid, kThreads, 0, stream>>>(
      keys, n_cols, static_cast<int>(per_row), reinterpret_cast<unsigned long long*>(sums));
  return static_cast<int>(cudaGetLastError());
}

// 64-bit words of scratch a launch over (n_rows, n_cols) needs: a status
// word a tile and the ticket counter.
extern "C" long long segment_reduce_scratch(int n_rows, int n_cols) {
  return tiles_per_row(n_cols) * n_rows + 1;
}

extern "C" int segment_reduce_launch(const int* keys, const int* vals, int* out_k,
                                     int* out_v, const int* addend,
                                     unsigned long long* scratch, int n_rows, int n_cols,
                                     cudaStream_t stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  const long long per_row = tiles_per_row(n_cols);
  const long long tiles = per_row * n_rows;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (tiles + 1) * sizeof(unsigned long long),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_reduce_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      keys, vals, out_k, out_v, addend, n_cols, static_cast<int>(per_row), scratch,
      reinterpret_cast<unsigned*>(scratch + tiles));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
