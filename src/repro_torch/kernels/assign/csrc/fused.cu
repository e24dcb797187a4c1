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
// K=16, E=300; 0.0041 ms at 3.35 TB/s), so it is bound by device-memory
// bandwidth.  Everything else it touches (a float per row, the per-tile
// site totals) stays in L2.
//
// The TPU grid walked row blocks in order and carried the per-site `used`
// claims in VMEM scratch.  Blocks on this card run in no order.  Because
// every claim counts, a claim's `pos` is the exclusive prefix of sizes over
// the earlier claims of its site, so admission is a segmented scan over row
// tiles of kTileRows rows, in three launches:
//   1. rows (one CTA a tile, one warp 32 rows): a row's K slots are read by a
//      group of G lanes (G = the power of two that covers K/4, at most 32),
//      each lane 4 slots with one 16-byte load of scores and one of
//      candidates when K % 4 == 0 (K=16: 4 lanes a row, 8 rows a warp-wide
//      load, a warp's 32 rows all in flight at once).  The pick is a
//      butterfly over the group; ties go to the lowest slot.  Each warp
//      then ranks its 32 claims: __match_any_sync finds the lanes with the
//      same site, and a claim's in-warp prefix is the sum of the sizes of the
//      earlier such lanes.  Each warp's last claim on a site writes the
//      warp's total for the site into a [warps][sites] table in shared
//      memory; one thread a site scans the table over the warps in row
//      order, which gives each claim its in-tile prefix and the tile its
//      per-site totals, written bin-major ([E][n_tiles]).  Sites go through
//      the table kTableBins at a time;
//   2. base (one warp a site): the exclusive prefix of the site's tile totals
//      over tiles, in place; a step of the warp stages 32 * kScanPer tiles
//      in shared memory with coalesced loads, a lane adds kScanPer of them in
//      order and one warp scan joins the lanes;
//   3. place (one thread a row): pos = base + in-tile prefix, and
//      admit = pos + size <= cap + 1e-6.  When the caller passes a `pos`
//      array the pass also stores pos there (0 for a row without a claim):
//      the units its site had claimed before the row, what a job-parallel
//      run adds the lower ranks' claims to.  4 bytes a row more, 0.4 MB at
//      the engine shape.
// Lanes: L independent problems (scores [L][N][K], cand [L][N][K], sizes
// [L][N], caps [L][E]; outputs [L][N]) take the same three launches, the
// JAX package's kernel under vmap.  A lane's tiles are a block of CTAs and no
// tile straddles two lanes; rows are numbered across lanes ([L][N]
// flattened), so the rows pass is the one-problem code; the tile totals are
// [L][E][tiles] and the base pass scans L * E rows.  A lane's results are
// those of a call on it alone.  L = 1 compiles the kernels without the lane
// arithmetic (the LANES template flag), so one problem keeps its registers.
// The scans add in another order than the plain version's cumulative sum.
// For integral sizes (cores) whose sums stay below 2^24 every partial sum is
// an integer that f32 holds exactly, so site and admit equal the plain
// version bit for bit for any row-block size of the plain version; nothing
// uses atomics, so every run gives the same bits for any sizes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;   // invalid-slot marker
constexpr int kWarp = 32;
constexpr int kWarps = 8;           // warps of a rows CTA
constexpr int kThreads = kWarps * kWarp;
constexpr int kTileRows = kThreads; // rows of a tile: 32 a warp
constexpr int kBatch = 4;           // warp-wide row loads in flight a lane
constexpr int kTableBins = 1024;    // sites a rows CTA totals at a time
constexpr int kScanPer = 16;        // tiles a lane holds a step (pass 2)
constexpr int kBaseWarps = 4;       // sites a base CTA scans (pass 2)
constexpr int kPlaceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// (v, s) comes before (bv, bs): larger score first, lower slot on ties.
__device__ __forceinline__ bool before(float v, int s, float bv, int bs) {
  return v > bv || (v == bv && s < bs);
}

// The 4 slots slot0 .. slot0 + 3 of `row` (scores and candidates); slots
// past K are never looked at.
template <bool VEC>
__device__ __forceinline__ void load_slots(float4& sv, int4& cv, const float* __restrict__ scores,
                                           const int* __restrict__ cand, long long row, int k,
                                           int slot0, bool live) {
  sv = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  cv = make_int4(0, 0, 0, 0);
  if (!live || slot0 >= k) return;
  const long long o = row * k + slot0;
  if (VEC) {
    sv = __ldg(reinterpret_cast<const float4*>(scores + o));
    cv = __ldg(reinterpret_cast<const int4*>(cand + o));
  } else {
    const int m = k - slot0;
    sv.x = __ldg(scores + o);
    cv.x = __ldg(cand + o);
    if (m > 1) { sv.y = __ldg(scores + o + 1); cv.y = __ldg(cand + o + 1); }
    if (m > 2) { sv.z = __ldg(scores + o + 2); cv.z = __ldg(cand + o + 2); }
    if (m > 3) { sv.w = __ldg(scores + o + 3); cv.w = __ldg(cand + o + 3); }
  }
}

// Fold slot `s` (score x, candidate c) into this lane's best.
__device__ __forceinline__ void consider(float x, int c, int s, int k, int e_count, float& bv,
                                         int& bs, int& bc) {
  if (s < k) {
    const float v = c < e_count ? x : kNegInf;
    if (before(v, s, bv, bs)) {
      bv = v;
      bs = s;
      bc = c;
    }
  }
}

template <bool VEC, bool LANES>
__global__ void __launch_bounds__(kThreads, 4)  // 64 registers: 4 CTAs an SM, no spills
    fused_rows_kernel(const float* __restrict__ scores, const int* __restrict__ cand,
                      const float* __restrict__ sizes, int n, int k, int e_count, int g_lanes,
                      int n_tiles, int* __restrict__ site, float* __restrict__ local,
                      float* __restrict__ tile_tot) {
  extern __shared__ float s_tab[];   // [kWarps][min(E, kTableBins)]: per-warp site totals
  __shared__ int s_bin[kTileRows];   // the row's site bin, -1: no claim
  __shared__ float s_w[kTileRows];   // the row's size (0 without a claim)
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  // this CTA's problem (lane of the batch) and its tile there; rows are
  // numbered across lanes, so every row access below is the one-problem code
  const int problem = LANES ? static_cast<int>(blockIdx.x) / n_tiles : 0;
  const int tile = LANES ? static_cast<int>(blockIdx.x) - problem * n_tiles
                         : static_cast<int>(blockIdx.x);
  const long long tile0 = static_cast<long long>(tile) * kTileRows;
  const long long row0 = static_cast<long long>(problem) * n + tile0;
  const int rows = n - tile0 < kTileRows ? static_cast<int>(n - tile0) : kTileRows;
  // this problem's tile totals: [E][n_tiles] at problem * E * n_tiles
  if (LANES) tile_tot += static_cast<long long>(problem) * e_count * n_tiles;
  const int ec0 = e_count < kTableBins ? e_count : kTableBins;
  for (int e = lane; e < ec0; e += kWarp) s_tab[warp * ec0 + e] = 0.f;  // this warp's row, chunk 0

  // ---- picks: G lanes a row, R = 32 / G rows a warp-wide load, the warp's
  // 32 rows in G loads, kBatch of them in flight at once ------------------
  const int G = g_lanes;
  const int R = kWarp / G;
  const int j = lane % G;            // this lane's slot group: slots 4 j .. 4 j + 3
  const int q = lane / G;            // this lane's row within a load
  const int wrow0 = warp * kWarp;    // the warp's first row in the tile
  for (int s0 = 0; s0 < G; s0 += kBatch) {
    float4 sv[kBatch];
    int4 cv[kBatch];
    float sz[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = wrow0 + (s0 + b) * R + q;
      const bool live = s0 + b < G && i < rows;
      load_slots<VEC>(sv[b], cv[b], scores, cand, row0 + i, k, 4 * j, live);
      sz[b] = live && j == 0 ? __ldg(sizes + row0 + i) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (s0 + b >= G) break;        // the same for the whole warp
      const int i = wrow0 + (s0 + b) * R + q;
      const long long row = row0 + i;
      const bool live = i < rows;
      float bv = -INFINITY;          // this lane's first maximum ...
      int bs = 0x7fffffff;           // ... its slot ...
      int bc = 0;                    // ... and its candidate
      consider(sv[b].x, cv[b].x, 4 * j, k, e_count, bv, bs, bc);
      consider(sv[b].y, cv[b].y, 4 * j + 1, k, e_count, bv, bs, bc);
      consider(sv[b].z, cv[b].z, 4 * j + 2, k, e_count, bv, bs, bc);
      consider(sv[b].w, cv[b].w, 4 * j + 3, k, e_count, bv, bs, bc);
      // K > 128: the lane's further slots 4 (j + 32 t) .., in rising order
      for (int s = 4 * (j + G); live && s < k; s += 4 * G) {
        for (int c = 0; c < 4 && s + c < k; ++c)
          consider(__ldg(scores + row * k + s + c), __ldg(cand + row * k + s + c), s + c, k,
                   e_count, bv, bs, bc);
      }
      for (int off = G / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int os = __shfl_xor_sync(kFull, bs, off);
        const int oc = __shfl_xor_sync(kFull, bc, off);
        if (before(ov, os, bv, bs)) {
          bv = ov;
          bs = os;
          bc = oc;
        }
      }
      if (j == 0) {
        const bool ok = live && bv > kNegInf / 2;
        if (live) site[row] = ok ? bc : -1;
        s_bin[i] = ok ? (bc < 0 ? 0 : (bc >= e_count ? e_count - 1 : bc)) : -1;
        s_w[i] = ok ? sz[b] : 0.f;
      }
    }
  }
  __syncwarp();

  // ---- in-warp ranks: the sizes of the warp's earlier claims on the bin ---
  const int i = threadIdx.x;         // this thread's row in the tile: wrow0 + lane
  const int bin = s_bin[i];
  const unsigned peers = __match_any_sync(kFull, bin);
  float excl = 0.f;
  for (unsigned m = peers & ((1u << lane) - 1u); m; m &= m - 1u) excl += s_w[wrow0 + __ffs(m) - 1];
  const bool last = bin >= 0 && 31 - __clz(peers) == lane;  // the warp's last claim on bin

  // ---- per-warp site totals, scanned over the warps in row order, a chunk
  // of kTableBins sites at a time: in-tile prefixes and the tile's totals --
  for (int e0 = 0; e0 < e_count; e0 += kTableBins) {
    const int ec = e_count - e0 < kTableBins ? e_count - e0 : kTableBins;
    if (e0 > 0)
      for (int e = lane; e < ec; e += kWarp) s_tab[warp * ec + e] = 0.f;
    __syncwarp();
    const bool mine = bin >= e0 && bin < e0 + ec;
    if (mine && last) s_tab[warp * ec + bin - e0] = excl + s_w[i];
    __syncthreads();
    for (int e = threadIdx.x; e < ec; e += kThreads) {
      float carry = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float x = s_tab[w * ec + e];
        s_tab[w * ec + e] = carry;
        carry += x;
      }
      tile_tot[(e0 + e) * static_cast<long long>(n_tiles) + tile] = carry;
    }
    __syncthreads();
    if (mine && i < rows) local[row0 + i] = s_tab[warp * ec + bin - e0] + excl;
    if (e0 + kTableBins < e_count) __syncthreads();  // before the next chunk's zeros
  }
  if (bin < 0 && i < rows) local[row0 + i] = __int_as_float(0x7fc00000);  // NaN: no claim
}

// tile_tot[e][*] becomes its exclusive prefix over tiles, in place, 32 *
// kScanPer tiles a step: the warp loads them with coalesced loads into
// shared memory, lane l sums tiles kScanPer l .. kScanPer (l + 1) - 1 in
// order, one warp scan gives each lane its start, and the warp stores the
// prefixes back with coalesced stores.
__device__ __forceinline__ int padded(int t) { return t + t / kScanPer; }  // no bank conflicts

__global__ void __launch_bounds__(kBaseWarps * kWarp)
    fused_base_kernel(float* __restrict__ tile_tot, int n_tiles, int e_count) {
  __shared__ float s_tiles[kBaseWarps][kWarp * (kScanPer + 1)];
  const int warp = threadIdx.x / kWarp;
  const int e = blockIdx.x * kBaseWarps + warp;
  const int lane = threadIdx.x % kWarp;
  if (e >= e_count) return;
  float* row = tile_tot + static_cast<long long>(e) * n_tiles;
  float* sw = s_tiles[warp];
  float carry = 0.f;
  for (int t0 = 0; t0 < n_tiles; t0 += kWarp * kScanPer) {
#pragma unroll
    for (int c = 0; c < kScanPer; ++c) {
      const int t = kWarp * c + lane;
      sw[padded(t)] = t0 + t < n_tiles ? row[t0 + t] : 0.f;
    }
    __syncwarp();
    float x[kScanPer];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kScanPer; ++c) {
      x[c] = sum;
      sum += sw[padded(kScanPer * lane + c)];
    }
    float incl = sum;
    for (int off = 1; off < kWarp; off <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    const float start = carry + excl;
#pragma unroll
    for (int c = 0; c < kScanPer; ++c) sw[padded(kScanPer * lane + c)] = start + x[c];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kScanPer; ++c) {
      const int t = kWarp * c + lane;
      if (t0 + t < n_tiles) row[t0 + t] = sw[padded(t)];
    }
    carry += __shfl_sync(kFull, incl, kWarp - 1);
    __syncwarp();
  }
}

// One thread a row of the [lanes][n] rows; with LANES, row r is row r % n
// of problem r / n, whose site bins start at problem * E.  One problem keeps
// the 32-bit row arithmetic.
template <bool LANES>
__global__ void fused_place_kernel(const int* __restrict__ site, const float* __restrict__ local,
                                   const float* __restrict__ base,
                                   const float* __restrict__ sizes,
                                   const float* __restrict__ caps, long long rows, int n,
                                   int e_count, int n_tiles, bool* __restrict__ admit,
                                   float* __restrict__ pos_out) {
  using Row = typename std::conditional<LANES, long long, int>::type;
  const Row r = static_cast<Row>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float l = local[r];
  bool a = false;
  if (!isnan(l)) {  // the row claims a site
    const Row problem = LANES ? r / n : 0;
    const int s = site[r];
    const Row b = problem * e_count + (s < 0 ? 0 : (s >= e_count ? e_count - 1 : s));
    const Row t = (r - problem * n) / kTileRows;   // the row's tile in its problem
    const float pos = base[static_cast<long long>(b) * n_tiles + t] + l;
    a = pos + sizes[r] <= caps[b] + 1e-6f;
    if (pos_out != nullptr) pos_out[r] = pos;
  } else if (pos_out != nullptr) {
    pos_out[r] = 0.f;
  }
  admit[r] = a;
}

template <bool VEC, bool LANES>
cudaError_t launch_rows(int ctas, int n_tiles, size_t smem, cudaStream_t st,
                        const float* scores, const int* cand, const float* sizes, int n, int k,
                        int e_count, int g, int* site, float* local, float* tile_tot) {
  fused_rows_kernel<VEC, LANES><<<ctas, kThreads, smem, st>>>(
      scores, cand, sizes, n, k, e_count, g, n_tiles, site, local, tile_tot);
  return cudaGetLastError();
}

}  // namespace

// Rows of a tile: the caller's scratch is local float[lanes * n] and tile_tot
// float[lanes * E * ceil(n / fused_tile_rows())].
extern "C" int fused_tile_rows() { return kTileRows; }

// Launch the three passes over `lanes` problems of n rows on `stream`;
// returns cudaGetLastError() after them.  `pos` (float[lanes * n]) may be
// null: then no position is stored.
extern "C" int fused_launch(const float* scores, const int* cand, const float* sizes,
                            const float* caps, int lanes, int n, int k, int e_count, int* site,
                            bool* admit, float* local, float* tile_tot, float* pos,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes <= 0 || n <= 0 || k <= 0 || e_count <= 0)
    return static_cast<int>(cudaGetLastError());
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int ctas = lanes * n_tiles;
  const int quads = (k + 3) / 4;
  int g = 1;
  while (g < quads && g < kWarp) g <<= 1;
  const bool vec = k % 4 == 0 && (reinterpret_cast<uintptr_t>(scores) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(cand) & 15u) == 0;
  const bool many = lanes > 1;
  const size_t smem = sizeof(float) * kWarps * (e_count < kTableBins ? e_count : kTableBins);
  cudaError_t err;
  switch ((vec ? 2 : 0) + (many ? 1 : 0)) {
    case 0: err = launch_rows<false, false>(ctas, n_tiles, smem, st, scores, cand, sizes, n, k, e_count, g, site, local, tile_tot); break;
    case 1: err = launch_rows<false, true>(ctas, n_tiles, smem, st, scores, cand, sizes, n, k, e_count, g, site, local, tile_tot); break;
    case 2: err = launch_rows<true, false>(ctas, n_tiles, smem, st, scores, cand, sizes, n, k, e_count, g, site, local, tile_tot); break;
    default: err = launch_rows<true, true>(ctas, n_tiles, smem, st, scores, cand, sizes, n, k, e_count, g, site, local, tile_tot); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bins = lanes * e_count;   // rows of the tile totals, one warp each
  fused_base_kernel<<<(bins + kBaseWarps - 1) / kBaseWarps, kBaseWarps * kWarp, 0, st>>>(
      tile_tot, n_tiles, bins);
  const long long rows = static_cast<long long>(lanes) * n;
  const unsigned blocks = static_cast<unsigned>((rows + kPlaceThreads - 1) / kPlaceThreads);
  if (many)
    fused_place_kernel<true><<<blocks, kPlaceThreads, 0, st>>>(site, local, tile_tot, sizes,
                                                               caps, rows, n, e_count, n_tiles,
                                                               admit, pos);
  else
    fused_place_kernel<false><<<blocks, kPlaceThreads, 0, st>>>(site, local, tile_tot, sizes,
                                                                caps, rows, n, e_count, n_tiles,
                                                                admit, pos);
  return static_cast<int>(cudaGetLastError());
}
