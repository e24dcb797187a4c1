// Fused candidate-set assignment on Hopper (sm_90a): the sparse top-k path.
//
// Replaces the TPU kernel src/repro/kernels/assign/fused.py:_fused_kernel
// (entry point fused_assign_pallas).  Semantics are those of
// fused_ref.fused_assign_ref: per row, the best valid candidate (cand < E;
// ties to the lowest slot) gives `site` (-1 when no candidate scores above
// -5e29), then FIFO admission in row order against per-site capacity, where
// every claim counts, admitted or not.
//
// Bound: the kernel reads the N x K f32 scores and i32 candidates once and
// writes one int and one bool per row (13.7 MB at the engine's N=100000,
// K=16, E=300), so it is bound by device-memory bandwidth.  This first design
// reads a row's K slots from one thread (the warp's rows share cache lines
// through L1) and keeps the admission scan off device memory except for one
// float per (row tile, site).
//
// The TPU grid walked row blocks in order and carried the per-site `used`
// claims in VMEM scratch.  Blocks on this card run in no order, so the
// admission is a tiled scan in three launches:
//   1. tiles (one CTA per kTileRows rows): each thread picks the best slot of
//      its rows into shared memory; then one thread per site walks the tile's
//      rows in order, writes each member row's in-tile exclusive prefix of
//      sizes, and the tile's total for the site;
//   2. scan (one thread per site): the exclusive prefix of the tile totals
//      over tiles, in tile order;
//   3. admit (one thread per row): pos = tile base + in-tile prefix, and
//      admit = pos + size <= cap + 1e-6.
// As in assign.cu, exactness holds for integral sizes (cores) whose sums stay
// below 2^24: every prefix sum is then exact in f32, and site and admit equal
// the plain version bit for bit for any row-block size of the plain version.
// Non-integral sizes add in another order than the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;   // invalid-slot marker
constexpr int kTileRows = 512;      // rows of one tile (pass 1)
constexpr int kThreads = 256;       // threads of a tile's CTA
constexpr int kScanThreads = 128;   // pass 2: sites per CTA
constexpr int kAdmitThreads = 256;  // pass 3: rows per CTA

__global__ void fused_tile_kernel(const float* __restrict__ scores, const int* __restrict__ cand,
                                  const float* __restrict__ sizes, int n, int k, int e_count,
                                  int* __restrict__ site, int* __restrict__ bin,
                                  float* __restrict__ local, float* __restrict__ tile_tot) {
  __shared__ int s_bin[kTileRows];
  __shared__ float s_w[kTileRows];
  const long row0 = static_cast<long>(blockIdx.x) * kTileRows;
  const int rows = n - row0 < kTileRows ? static_cast<int>(n - row0) : kTileRows;

  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const long r = row0 + i;
    const float* sc = scores + r * k;
    const int* cd = cand + r * k;
    // first max: a later slot wins only when strictly greater
    float best = cd[0] < e_count ? sc[0] : kNegInf;
    int best_slot = 0;
    for (int j = 1; j < k; ++j) {
      const float v = cd[j] < e_count ? sc[j] : kNegInf;
      if (v > best) {
        best = v;
        best_slot = j;
      }
    }
    const int s = cd[best_slot];
    const bool ok = best > kNegInf / 2;
    const int b = ok ? (s < 0 ? 0 : (s >= e_count ? e_count - 1 : s)) : -1;
    site[r] = ok ? s : -1;
    bin[r] = b;
    s_bin[i] = b;
    s_w[i] = ok ? sizes[r] : 0.f;
  }
  __syncthreads();

  // one thread per site walks the tile in row order: claims and in-tile
  // positions without atomics, so the sums are the same on every run
  for (int e = threadIdx.x; e < e_count; e += kThreads) {
    float run = 0.f;
    for (int i = 0; i < rows; ++i) {
      if (s_bin[i] == e) {
        local[row0 + i] = run;
        run += s_w[i];
      }
    }
    tile_tot[static_cast<long>(blockIdx.x) * e_count + e] = run;
  }
}

__global__ void fused_scan_kernel(const float* __restrict__ tile_tot, int n_tiles, int e_count,
                                  float* __restrict__ base) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_count) return;
  float acc = 0.f;
#pragma unroll 8
  for (int t = 0; t < n_tiles; ++t) {
    const long o = static_cast<long>(t) * e_count + e;
    const float x = tile_tot[o];
    base[o] = acc;
    acc += x;
  }
}

__global__ void fused_admit_kernel(const int* __restrict__ bin, const float* __restrict__ local,
                                   const float* __restrict__ base,
                                   const float* __restrict__ sizes,
                                   const float* __restrict__ caps, int n, int e_count,
                                   bool* __restrict__ admit) {
  const long r = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int b = bin[r];
  bool a = false;
  if (b >= 0) {
    const float pos = base[(r / kTileRows) * e_count + b] + local[r];
    a = pos + sizes[r] <= caps[b] + 1e-6f;
  }
  admit[r] = a;
}

}  // namespace

// Scratch the caller allocates: bin int[n], local float[n], tile_tot and
// base float[n_tiles * e_count] with n_tiles = fused_n_tiles(n).
extern "C" int fused_n_tiles(int n) { return (n + kTileRows - 1) / kTileRows; }

// Launch the three passes on `stream`; returns cudaGetLastError() after them.
extern "C" int fused_launch(const float* scores, const int* cand, const float* sizes,
                            const float* caps, int n, int k, int e_count, int* site, bool* admit,
                            int* bin, float* local, float* tile_tot, float* base, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0 && k > 0 && e_count > 0) {
    const int n_tiles = fused_n_tiles(n);
    fused_tile_kernel<<<n_tiles, kThreads, 0, st>>>(scores, cand, sizes, n, k, e_count, site,
                                                    bin, local, tile_tot);
    fused_scan_kernel<<<(e_count + kScanThreads - 1) / kScanThreads, kScanThreads, 0, st>>>(
        tile_tot, n_tiles, e_count, base);
    fused_admit_kernel<<<(n + kAdmitThreads - 1) / kAdmitThreads, kAdmitThreads, 0, st>>>(
        bin, local, base, sizes, caps, n, e_count, admit);
  }
  return static_cast<int>(cudaGetLastError());
}
