// Sorted segment reduce for the reduce tasks of the MapReduce engine.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_reduce/kernel.py
// (_segment_reduce_kernel, called by segment_reduce_fwd): for each (N, C)
// row of key-sorted, PAD_KEY-tailed int32 keys, the sum of each equal-key
// run at the run's first slot, (PAD_KEY, 0) elsewhere.
//
// Design.  The TPU kernel builds a C x C one-hot matrix to feed the MXU;
// that is O(C^2) work and memory and is not carried over.  On the main
// path a reduce wave is ONE row of about 4n/R slots (53.7 M at 2^26 tokens
// and R = 5), so one block per row would leave 131 of 132 SMs idle: the
// grid is (ceil(C / kTile), N), tiled along the row.  Each block
// classifies its tile's slots, runs a block-wide segmented scan, writes
// out_k for every slot, and writes each run's partial sum at the run's
// head: a plain store when the run lies wholly inside the tile, else an
// atomicAdd into out_v (zeroed by the wrapper).  A run that began in an
// earlier tile finds its head by binary search, valid since rows are
// sorted.  Sums accumulate in int32, so the result is exact at every size
// (the Pallas kernel's float32 MXU sum is exact only below 2^24).
//
// Bound on an H100: memory.  Per slot it reads 8 B (key, value) and
// writes 8 B (out_k, out_v), 16 B in all, at 3.35 TB/s: 0.26 ms for a
// 53.7 M-slot row.  Loads and stores go through shared memory
// (cub warp-transpose) so that each warp touches contiguous 128 B lines;
// the arithmetic per slot is a handful of integer operations.

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                      int* __restrict__ out_k, int* __restrict__ out_v, int n_cols) {
  __shared__ union {
    Load::TempStorage load;
    Store::TempStorage store;
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

  Seg in[kItems], out[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = k[j] != kPadKey;
    in[j] = Seg{head[j] ? 1 : 0, live ? static_cast<unsigned>(v[j]) : 0u,
                head[j] ? static_cast<int>(threadIdx.x) * kItems + j : -1};
  }
  SegScan(tmp.scan).InclusiveScan(in, out, SegOp());
  __syncthreads();

  int ok[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    ok[j] = head[j] ? k[j] : kPadKey;
    if (flush[j]) {
      const int sum = static_cast<int>(out[j].sum);
      if (out[j].tag >= 0 && whole[j]) {
        out_v[row_off + tile0 + out[j].tag] = sum;
      } else {
        const int at = out[j].tag >= 0 ? tile0 + out[j].tag : lower_bound(rk, tile0, k[j]);
        atomicAdd(out_v + row_off + at, sum);
      }
    }
  }
  Store(tmp.store).Store(out_k + row_off + tile0, ok, n);
}

}  // namespace

extern "C" int segment_reduce_launch(const int* keys, const int* vals, int* out_k,
                                     int* out_v, int n_rows, int n_cols,
                                     cudaStream_t stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  const dim3 grid((n_cols + kTile - 1) / kTile, n_rows);
  segment_reduce_kernel<<<grid, kThreads, 0, stream>>>(keys, vals, out_k, out_v, n_cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
