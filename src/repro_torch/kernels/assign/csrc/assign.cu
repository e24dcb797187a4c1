// Capacity-constrained greedy assignment on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/assign/assign.py:_assign_kernel
// (entry point assign_pallas).  Semantics are those of ref.assign_ref: row
// softmax gates over feasible bins (score > -5e29), k slot-major first-argmax
// rounds with ties to the lowest bin, and FIFO admission against per-bin
// capacity, where claims are taken in the order (row block of block_n, slot,
// row) and a per-bin `used` carry counts every claim, admitted or not.
//
// The TPU grid walked row blocks in order and carried `used` in VMEM scratch.
// Because every claim counts, a claim's `pos` is simply the exclusive prefix
// of sizes over the earlier claims of its bin in claim order, so admission is
// a segmented scan and needs no walk of all claims per bin.  Claims are cut
// into tiles, each a run of rows of one slot within one row block (a tile
// never spans two row blocks; tiles are numbered in claim order).  Lanes: K
// independent problems (scores [K][N][E], sizes [K][N], caps [K][E]; outputs
// [K][N][k]) take the same launches; each lane has its own tiles and tile
// totals, so a lane's results are those of a call on it alone.
//
// Two callers with opposite shapes, so three forms, chosen by shape in
// assign_launch (plan()):
//
// * rows form, the engine's one large problem ([100000, 300] or 16 lanes of
//   it, k = 1): bound by reading the N x E f32 scores once (120 MB, 0.036 ms
//   at 3.35 TB/s).  Three launches:
//   1. rows (one CTA a 256-row tile, one warp a row): the row is read once
//      into registers (16-byte loads when E % 4 == 0, up to 16 values a
//      lane, so E <= 512 stays in registers; wider rows reread the rest from
//      L1/L2), the warp's next two rows loading while it works; the max
//      (with the first pick), the exp-sum and the other picks come from
//      registers.  Then, per slot, one warp walks the tile's claims in row
//      order, 32 at a time: a claim's in-tile prefix is the sum of the sizes
//      of the earlier lanes with its bin (shuffles) plus the bin's running
//      total in shared memory.  It writes that prefix as `pos` and the
//      tile's per-bin totals (bin-major, [E][n_tiles]).
//   2. base (one warp a bin): the exclusive prefix of the tile totals over
//      tiles, in place, 32 tiles a step.
//   3. place (one thread a claim): pos += its tile's base for its bin, and
//      admit = pos + size <= cap + 1e-6.
// * cluster form, the MoE router's many small problems ([32, 512, E] at
//   k = 8 a prefill, [1, 4, E] a decode step).  Its bytes are few (3.9 MB
//   read and written at [32, 512, 32]: 0.0012 ms at 3.35 TB/s), so what
//   bounds it is issued instructions (clock64 stamps put ~90% of a CTA's
//   time in the k pick rounds while each round rescanned a row's values,
//   at half-rate integer compares and selects), the serial chain of the
//   admission scan, and filling 132 SMs.  A lane is cut into tiles of 32,
//   64 or 128 rows (the fewest rows that need at most 8 tiles), one CTA
//   each, and a lane's CTAs form one thread-block cluster (padded to 1, 2,
//   4 or 8 CTAs; padding CTAs hold no rows): 256 CTAs at [32, 512, E].  One
//   launch:
//   a. picks (one warp a row, bins lane + 32 j in registers; a warp works
//      on 4 rows together at E <= 64 and 2 above, their rounds interleaved):
//      every lane caches its first two elements (scores clamped at -5e29,
//      where every infeasible score ties, as none is ever a live pick); a
//      round reduces the lanes' heads with one redux.sync max over an
//      order-preserving integer key and one redux.sync min over the bins
//      holding the winner (in place of a 5-step butterfly of two shuffles
//      and a rescan of every value), and the winning lane pops its head,
//      refilling its cache only when it runs dry (0.7 times a row at
//      E = 384, k = 8); the k gates are computed together once a row;
//   b. in-tile prefixes (one warp a slot): __match_any_sync groups the 32
//      claims of a chunk by bin, and a claim's prefix is the count of the
//      earlier lanes of its group (their sizes when a size is not 1) plus
//      the bin's running total; the totals end as the tile's [k][E] totals;
//   c. the lane's tile totals scanned in claim order across the cluster
//      through distributed shared memory, with 16-byte remote stores only:
//      CTA r owns a run of bins; each CTA stores its totals into the
//      owners' shared memory, a cluster barrier, each owner scans its bins
//      (a thread four bins and a run of 8 tiles, in claim order) and stores
//      each tile's bases into that tile's CTA, a second barrier;
//   d. each CTA places its own claims: pos = base + in-tile prefix, admit
//      as above.
//   A lane takes this form when it needs at most 8 tiles (block_n and Tg
//   decide: N <= 1024 rows at k = 1) and its shared memory fits 96 KB.
// * tiles form, a routing problem too large for one cluster (k > 1): steps a
//   and b with 64-row tiles, which write the in-tile prefixes as `pos` and
//   the tile totals as the rows form does, then the rows form's base and
//   place launches.
// Every other shape (k = 1 over more than 1024 rows, or shared memory past
// 96 KB) takes the rows form.
//
// The scans add in another order than the plain version's cumulative sum.
// For integral sizes (cores; tokens = 1) whose sums stay below 2^24 every
// partial sum is an integer that f32 holds exactly, so idx, admit and pos
// equal the plain version bit for bit (as in fused.cu); nothing uses atomics,
// so every run gives the same bits for any sizes.  `gate` is exp(s - max) /
// exp-sum, within 1e-6 of the plain version.  The rows form's bits are those
// of the three-pass kernel before the routing forms were added (__expf, the
// float4 register layout).  The routing forms take exp as ex2.approx of
// (s - max) log2(e) and add the exp-sum in another order (bins lane + 32 j),
// so their gates may differ from the rows form's in the last bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;       // infeasible-score marker
constexpr int kWarp = 32;
constexpr int kWarps = 8;               // warps of a rows CTA
constexpr int kThreads = kWarps * kWarp;
constexpr int kTileRows = 256;          // rows of a tile
constexpr int kMaxRegs = 16;            // row values a lane keeps in registers
constexpr int kRegBins = kMaxRegs * kWarp;  // bins kept in registers (512)
constexpr int kPlaceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClusterMax = 8;          // CTAs of a cluster: the portable maximum
constexpr int kRouteTileRows = 64;      // rows of a tile in the tiles form
constexpr int kSeg = 8;                 // claim-order tiles a thread scans in the cluster form
constexpr size_t kRouteSmemMax = 96 * 1024;

enum Form { kFormRows = 0, kFormCluster = 1, kFormTiles = 2 };

// (v, i) comes before (bv, bi) in pick order: larger score first, lower bin
// on ties.  A strict total order, so the k picks of a row are its first k
// elements in this order.
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The bin of register slot i of `lane`: float4 j of a lane holds bins
// 4 * (lane + 32 j) .. + 3 when VEC, else slot i holds bin lane + 32 i.
// Either way a lane's bins rise with i, so a lane's first maximum is the
// first slot that beats all before it.
template <bool VEC>
__device__ __forceinline__ int reg_bin(int i, int lane) {
  return VEC ? 4 * (lane + kWarp * (i / 4)) + (i % 4) : lane + kWarp * i;
}

// NR values of a row for this lane; bins past E read as -inf.
template <bool VEC, int NR>
__device__ __forceinline__ void load_row(float (&v)[NR], const float* __restrict__ s,
                                         int e_count, int lane) {
  if (VEC) {
#pragma unroll
    for (int j = 0; j < NR / 4; ++j) {
      const int e = 4 * (lane + kWarp * j);
      float4 x = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (e < e_count) x = __ldg(reinterpret_cast<const float4*>(s + e));
      v[4 * j] = x.x;
      v[4 * j + 1] = x.y;
      v[4 * j + 2] = x.z;
      v[4 * j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int e = lane + kWarp * i;
      v[i] = e < e_count ? __ldg(s + e) : -INFINITY;
    }
  }
}

// Calls f(value, bin) for the bins past those kept in registers (E > 512),
// read again from L1/L2, in rising bin order.
template <typename Fn>
__device__ __forceinline__ void visit_tail(const float* __restrict__ s, int e_count, int lane,
                                           Fn&& f) {
  for (int e = kRegBins + lane; e < e_count; e += kWarp) f(__ldg(s + e), e);
}

template <bool VEC, int NR>
__global__ void __launch_bounds__(kThreads)
    assign_rows_kernel(const float* __restrict__ scores, const float* __restrict__ sizes, int n,
                       int e_count, int k, int block_rows, int tiles_per_block, int n_tiles,
                       int lane_ctas, int* __restrict__ idx, float* __restrict__ gate,
                       float* __restrict__ pos, float* __restrict__ tile_tot) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_bin = reinterpret_cast<int*>(smem);                     // [k][kTileRows]
  float* s_w = reinterpret_cast<float*>(s_bin + k * kTileRows);  // [kTileRows]
  float* s_run = s_w + kTileRows;                                // [kWarps][E]
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  // this CTA's problem (lane of the batch) and its tile there; rows are
  // numbered across lanes ([K][N] flattened), so every row access below is
  // the one-problem kernel's
  const int problem = blockIdx.x / lane_ctas;
  const int cta = blockIdx.x - problem * lane_ctas;
  const int block = cta / tiles_per_block;
  const int t = cta % tiles_per_block;
  const long long lane0 = static_cast<long long>(problem) * n;
  const long long blk0 = lane0 + static_cast<long long>(block) * block_rows;
  const long long r0 = blk0 + static_cast<long long>(t) * kTileRows;
  long long r1 = r0 + kTileRows;
  if (r1 > blk0 + block_rows) r1 = blk0 + block_rows;
  if (r1 > lane0 + n) r1 = lane0 + n;
  const int rows = r1 > r0 ? static_cast<int>(r1 - r0) : 0;

  // ---- gates and picks: one warp a row, the row read once; the warp's next
  // two rows load while this one is worked on.  The first pick is the row's
  // maximum (first bin on ties), found in the same butterfly as the maximum.
  // An infeasible score (-1e30 or -inf) never beats a feasible one and adds
  // exp(-huge) = 0 to the sum; bins past E read as -inf. -------------------
  float cur[NR], nx1[NR], nx2[NR];
  const long long row_step = static_cast<long long>(kWarps) * e_count;
  if (warp < rows) load_row<VEC, NR>(cur, scores + (r0 + warp) * e_count, e_count, lane);
  if (warp + kWarps < rows)
    load_row<VEC, NR>(nx1, scores + (r0 + warp) * e_count + row_step, e_count, lane);
  for (int i = warp; i < rows; i += kWarps) {
    const long long row = r0 + i;
    const float* s = scores + row * e_count;
    if (i + 2 * kWarps < rows) load_row<VEC, NR>(nx2, s + 2 * row_step, e_count, lane);

    float m = -INFINITY;   // this lane's first maximum, then the row's
    int mi = e_count;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      if (cur[j] > m) {
        m = cur[j];
        mi = reg_bin<VEC>(j, lane);
      }
    }
    visit_tail(s, e_count, lane, [&](float x, int e) {
      if (x > m) {
        m = x;
        mi = e;
      }
    });
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, m, off);
      const int oi = __shfl_xor_sync(kFull, mi, off);
      if (before(ov, oi, m, mi)) {
        m = ov;
        mi = oi;
      }
    }
    float denom = 0.f;
#pragma unroll
    for (int j = 0; j < NR; ++j) denom += __expf(cur[j] - m);
    visit_tail(s, e_count, lane, [&](float x, int) { denom += __expf(x - m); });
    for (int off = kWarp / 2; off > 0; off >>= 1) denom += __shfl_xor_sync(kFull, denom, off);
    denom = fmaxf(denom, 1e-30f);

    float bv = m;             // the pick of this slot
    int bi = mi;
    bool live = m > kNegInf / 2;  // every pick so far was feasible
    for (int slot = 0; slot < k; ++slot) {
      if (slot > 0 && live) {
        // this lane's first maximum among the bins after the last pick
        const float last_v = bv;
        const int last_i = bi;
        bv = -INFINITY;
        bi = e_count;
        auto consider = [&](float x, int e) {
          if ((x < last_v || (x == last_v && e > last_i)) && x > bv) {
            bv = x;
            bi = e;
          }
        };
#pragma unroll
        for (int j = 0; j < NR; ++j) consider(cur[j], reg_bin<VEC>(j, lane));
        visit_tail(s, e_count, lane, consider);
        for (int off = kWarp / 2; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(kFull, bv, off);
          const int oi = __shfl_xor_sync(kFull, bi, off);
          if (before(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        live = bv > kNegInf / 2;
      }
      if (lane == 0) {
        const long long o = row * k + slot;
        idx[o] = live ? bi : -1;
        gate[o] = live ? __expf(bv - m) / denom : 0.f;
        pos[o] = 0.f;
        s_bin[slot * kTileRows + i] = live ? bi : -1;
      }
    }
    if (lane == 0) s_w[i] = sizes[row];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      cur[j] = nx1[j];
      nx1[j] = nx2[j];
    }
  }
  __syncthreads();

  // ---- in-tile prefixes and tile totals: one warp a slot -----------------
  for (int slot = warp; slot < k; slot += kWarps) {
    float* run = s_run + warp * e_count;
    for (int e = lane; e < e_count; e += kWarp) run[e] = 0.f;
    __syncwarp();
    for (int g = 0; g < rows; g += kWarp) {
      const int i = g + lane;
      const int b = i < rows ? s_bin[slot * kTileRows + i] : -1;
      const float w = b >= 0 ? s_w[i] : 0.f;
      float excl = 0.f;      // sizes of the earlier lanes with this bin
      bool last = true;      // no later lane has this bin
#pragma unroll
      for (int j = 0; j < kWarp; ++j) {
        const int bj = __shfl_sync(kFull, b, j);
        const float wj = __shfl_sync(kFull, w, j);
        if (bj == b) {
          if (j < lane) excl += wj;
          if (j > lane) last = false;
        }
      }
      const float base = b >= 0 ? run[b] : 0.f;
      __syncwarp();
      if (b >= 0) {
        pos[(r0 + i) * k + slot] = base + excl;
        if (last) run[b] = base + excl + w;
      }
      __syncwarp();
    }
    const long long tile = (static_cast<long long>(block) * k + slot) * tiles_per_block + t;
    const long long bin0 = static_cast<long long>(problem) * e_count;
    for (int e = lane; e < e_count; e += kWarp) tile_tot[(bin0 + e) * n_tiles + tile] = run[e];
    __syncwarp();
  }
}

// tile_tot[e][*] becomes its exclusive prefix over tiles, in place; with
// lanes, e runs over the K * E rows of [K][E][n_tiles].
__global__ void assign_base_kernel(float* __restrict__ tile_tot, int n_tiles, int e_count) {
  const int e = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (e >= e_count) return;
  float* row = tile_tot + static_cast<long long>(e) * n_tiles;
  float carry = 0.f;
  for (int t0 = 0; t0 < n_tiles; t0 += kWarp) {
    const int t = t0 + lane;
    const float x = t < n_tiles ? row[t] : 0.f;
    float incl = x;
    for (int off = 1; off < kWarp; off <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    if (t < n_tiles) row[t] = carry + excl;
    carry += __shfl_sync(kFull, incl, kWarp - 1);
  }
}

// ---------------------------------------------------------------------------
// The routing forms (cluster and tiles).

// The bins each CTA of a cluster of `ctas` owns in the scan of tile totals:
// E / ctas rounded up to a multiple of 4, so that 16-byte stores carry them.
__host__ __device__ __forceinline__ int owned_bins(int e_count, int ctas) {
  return ((e_count + ctas - 1) / ctas + 3) & ~3;
}

// An integer key with the order of the floats (equal floats, -0 and +0
// included, give equal keys): the sign-magnitude bits made two's complement.
// The map is its own inverse.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(__fadd_rn(v, 0.f));  // -0 -> +0
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

// A split cluster barrier: arrive when the CTA starts, wait before the first
// store into another CTA's shared memory, which must have started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 2^x by the special-function unit (flush-to-zero: a term below 2^-126
// adds nothing to a sum that holds exp(0) = 1).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// A lane's cached head and next element of a row, scores clamped below at
// -5e29 (every infeasible score ties there: none is ever a live pick), -inf
// when empty, their bins, and the bins the lane has given.
struct Head {
  float k1, k2;
  int b1, b2, taken;
};

__device__ __forceinline__ void head_insert(Head& h, bool ok, float x, int e) {
  const bool g1 = ok & (x > h.k1);
  const bool g2 = ok & (x > h.k2);
  h.k2 = g1 ? h.k1 : (g2 ? x : h.k2);
  h.b2 = g1 ? h.b1 : (g2 ? e : h.b2);
  h.k1 = g1 ? x : h.k1;
  h.b1 = g1 ? e : h.b1;
}

// This lane's first two elements of a row in before() order: of all its
// bins (ALL), or of those after (av, ab).  Bins rise along the scan, so a
// strict > keeps the lower bin of equal scores.
template <bool ALL, int NR>
__device__ __forceinline__ void head_fill(Head& h, const float (&v)[NR],
                                          const float* __restrict__ s, int e_count, int lane,
                                          float av, int ab) {
  h.k1 = h.k2 = -INFINITY;
  h.b1 = h.b2 = INT_MAX;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const float x = fmaxf(v[j], 0.5f * kNegInf);
    const int e = lane + kWarp * j;
    head_insert(h, ALL || (x < av) | ((x == av) & (e > ab)), x, e);
  }
  if constexpr (NR == kMaxRegs) {  // only then may E pass the 512 bins kept in registers
    visit_tail(s, e_count, lane, [&](float xs, int e) {
      const float x = fmaxf(xs, 0.5f * kNegInf);
      head_insert(h, ALL || (x < av) | ((x == av) & (e > ab)), x, e);
    });
  }
}

// The k picks of P rows of one warp (rows i0 + 8 p of the tile, valid where
// below `rows`; this lane holds bins lane + 32 j of row p in v[p], bins past
// E read as -inf), written to idx and gate.  Pick j is a row's j-th element
// in before() order.  Every lane caches its first two elements of a row
// (one pass over its values); each round the warp reduces the lanes' heads
// with one redux.sync max over their order_keys and one redux.sync min over
// the bins holding the winning key, the winning lane pops its head, and a
// lane whose cache runs dry while it holds more bins finds its next two
// after its last pick (a lane gives three of a row's k picks rarely).  So a
// round costs a few instructions whatever E is; the P rows' rounds are
// independent and interleave, which hides the reductions' latency.  Pads
// come after every real bin, and a pick that is not feasible ends the row:
// its slots and the later ones are -1 with gate 0.  Each round's pick goes
// to shared memory (s_bin [k][R], s_val), and the row's k picks and gates
// leave in one coalesced store of up to 32 slots.
template <int NR, int P>
__device__ __forceinline__ void pick_rows(const float (&v)[P][NR], const float* __restrict__ s0,
                                          int i0, int rows, long long r0, int e_count, int k,
                                          int lane, int tile_rows, int* __restrict__ idx,
                                          float* __restrict__ gate, int* __restrict__ s_bin,
                                          float* __restrict__ s_val) {
  // row p is row i0 + 8 p of the tile, its scores at s0 + 8 p E
  auto row_s = [&](int p) { return s0 + static_cast<long long>(kWarps) * p * e_count; };
  Head h[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    head_fill<true, NR>(h[p], v[p], row_s(p), e_count, lane, 0.f, 0);
    h[p].taken = 0;
  }
  const int avail = (e_count - lane + kWarp - 1) / kWarp;  // this lane's bins
  float m[P], denom[P];
  bool live[P];
#pragma unroll
  for (int p = 0; p < P; ++p) live[p] = true;
  for (int slot = 0; slot < k; ++slot) {
    int wk[P], wb[P];
    float wv[P];
#pragma unroll
    for (int p = 0; p < P; ++p) wk[p] = __reduce_max_sync(kFull, order_key(h[p].k1));
#pragma unroll
    for (int p = 0; p < P; ++p) {
      wv[p] = key_value(wk[p]);
      wb[p] = __reduce_min_sync(kFull, h[p].k1 == wv[p] ? h[p].b1 : INT_MAX);
    }
    bool dry[P];
    bool any_dry = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      live[p] = live[p] & (wv[p] > 0.5f * kNegInf);
      const bool win = (h[p].k1 == wv[p]) & (h[p].b1 == wb[p]);
      if constexpr (NR == 1) {  // a lane holds one bin (E <= 32): it never refills
        h[p].k1 = win ? -INFINITY : h[p].k1;
      } else {
        h[p].k1 = win ? h[p].k2 : h[p].k1;
        h[p].b1 = win ? h[p].b2 : h[p].b1;
        h[p].k2 = win ? -INFINITY : h[p].k2;
        h[p].b2 = win ? INT_MAX : h[p].b2;
        h[p].taken += win ? 1 : 0;
        dry[p] = live[p] & win & (h[p].k1 == -INFINITY) & (h[p].taken < avail);
        any_dry |= dry[p];
      }
    }
    if (NR > 1 && __any_sync(kFull, any_dry)) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (dry[p]) head_fill<false, NR>(h[p], v[p], row_s(p), e_count, lane, wv[p], wb[p]);
    }
    if (slot == 0) {  // each row's maximum and exp-sum
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float mp = wv[p];
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < NR; ++j) d += exp2_approx((v[p][j] - mp) * kLog2e);
        if constexpr (NR == kMaxRegs)
          visit_tail(row_s(p), e_count, lane,
                     [&](float x, int) { d += exp2_approx((x - mp) * kLog2e); });
        m[p] = mp;
        denom[p] = d;
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int p = 0; p < P; ++p) denom[p] += __shfl_xor_sync(kFull, denom[p], off);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) denom[p] = fmaxf(denom[p], 1e-30f);
    }
    if (lane == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = i0 + kWarps * p;
        if (i < rows) {
          s_bin[slot * tile_rows + i] = live[p] ? wb[p] : -1;
          s_val[slot * tile_rows + i] = wv[p];
        }
      }
    }
  }
  __syncwarp();
  // the k picks and gates of each row, 32 slots a store
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = i0 + kWarps * p;
    if (i < rows) {
      for (int j = lane; j < k; j += kWarp) {
        const int b = s_bin[j * tile_rows + i];
        const long long o = (r0 + i) * k + j;
        idx[o] = b;
        gate[o] = b >= 0 ? exp2_approx((s_val[j * tile_rows + i] - m[p]) * kLog2e) / denom[p] : 0.f;
      }
    }
  }
}

// One tile of a routing form: its rows' picks (step a) and in-tile prefixes
// (step b); then, in the cluster form, the lane's scan of tile totals over
// the cluster (step c) and the tile's pos and admit (step d); in the tiles
// form, the in-tile prefixes as pos and the tile totals for the base and
// place launches.  Shared memory: s_bin [k][R] i32, s_w [R], s_pre [k][R],
// s_tot [k][Ep], s_val [k][R], and in the cluster form s_base [k][Ep],
// s_gather [C k][EB] and s_part [EB / 4][C k / kSeg] float4s (Ep: E padded
// to a multiple of 4; EB: the bins a CTA owns; C: the cluster's CTAs).
template <bool CLUSTER, int NR>
__device__ __forceinline__ void route_tile(const float* __restrict__ scores,
                                           const float* __restrict__ sizes,
                                           const float* __restrict__ caps, int n, int e_count,
                                           int k, int block_rows, int tiles_per_block,
                                           int tile_rows, int lane_ctas, int n_tiles,
                                           int* __restrict__ idx, float* __restrict__ gate,
                                           bool* __restrict__ admit, float* __restrict__ pos,
                                           float* __restrict__ tile_tot) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = tile_rows;
  int* s_bin = reinterpret_cast<int*>(smem);
  float* s_w = reinterpret_cast<float*>(s_bin + k * R);
  float* s_pre = s_w + R;
  const int ep = (e_count + 3) & ~3;  // a slot's bins, padded to 16 bytes
  float* s_tot = s_pre + k * R;
  float* s_val = s_tot + k * ep;  // [k][R]: each pick's score
  float* s_base = s_val + k * R;
  float* s_gather = s_base + k * ep;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int problem = blockIdx.x / lane_ctas;
  const int cta = blockIdx.x - problem * lane_ctas;  // the CTA's rank in its cluster
  const int block = cta / tiles_per_block;
  const int t = cta % tiles_per_block;
  const long long lane0 = static_cast<long long>(problem) * n;
  const long long blk0 = lane0 + static_cast<long long>(block) * block_rows;
  const long long r0 = blk0 + static_cast<long long>(t) * R;
  long long r1 = r0 + R;
  if (r1 > blk0 + block_rows) r1 = blk0 + block_rows;
  if (r1 > lane0 + n) r1 = lane0 + n;
  const int rows = r1 > r0 ? static_cast<int>(r1 - r0) : 0;  // 0 on a padding CTA
  if constexpr (CLUSTER) cluster_arrive_relaxed();

  for (int x = threadIdx.x; x < k * ep; x += kThreads) s_tot[x] = 0.f;
  float w = 1.f;
  if (threadIdx.x < R) {
    if (threadIdx.x < rows) w = sizes[r0 + threadIdx.x];
    s_w[threadIdx.x] = threadIdx.x < rows ? w : 0.f;
  }
  // every size of the tile is 1 (tokens): a claim's in-tile prefix is a count
  const bool unit = __syncthreads_and(w == 1.f);

  // ---- a. picks: one warp P rows at a time (rows i0 + 8 p), their rounds
  // interleaved ------------------------------------------------------------
  {
    constexpr int P = NR <= 2 ? 4 : 2;  // rows a warp works on together
    float cur[P][NR], nxt[P][NR];
    auto load = [&](float (&dst)[P][NR], int i0) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        load_row<false, NR>(dst[p], scores + (r0 + i0 + kWarps * p) * e_count, e_count, lane);
    };
    // whole groups of P rows, the next group loading while one is worked
    // on; then the warp's last rows one at a time
    constexpr int step = kWarps * P;
    constexpr bool kPrefetch = P * NR <= 12;  // registers for the next group
    int i0 = warp;
    if (i0 + kWarps * (P - 1) < rows) {
      load(cur, i0);
      for (;;) {
        const bool more = i0 + step + kWarps * (P - 1) < rows;
        if (more && kPrefetch) load(nxt, i0 + step);
        pick_rows<NR, P>(cur, scores + (r0 + i0) * e_count, i0, rows, r0, e_count, k, lane, R,
                         idx, gate, s_bin, s_val);
        i0 += step;
        if (!more) break;
        if (kPrefetch) {
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int j = 0; j < NR; ++j) cur[p][j] = nxt[p][j];
        } else {
          load(cur, i0);
        }
      }
    }
    for (; i0 < rows; i0 += kWarps) {
      float one[1][NR];
      load_row<false, NR>(one[0], scores + (r0 + i0) * e_count, e_count, lane);
      pick_rows<NR, 1>(one, scores + (r0 + i0) * e_count, i0, rows, r0, e_count, k, lane, R, idx,
                       gate, s_bin, s_val);
    }
  }
  __syncthreads();

  // ---- b. in-tile prefixes and the tile's totals: one warp a slot, 32
  // claims a step, grouped by bin ------------------------------------------
  const unsigned lt = (1u << lane) - 1u;
  const unsigned gt = ~((2u << lane) - 1u);
  for (int slot = warp; slot < k; slot += kWarps) {
    float* run = s_tot + slot * ep;
    for (int g = 0; g < rows; g += kWarp) {
      const int i = g + lane;
      const int b = i < rows ? s_bin[slot * R + i] : -1;
      const unsigned group = __match_any_sync(kFull, b);
      float excl = 0.f;  // sizes of the earlier claims of the chunk with this bin
      if (unit) {
        excl = static_cast<float>(__popc(group & lt));
      } else {
        for (unsigned bits = group & lt; bits; bits &= bits - 1u) excl += s_w[g + __ffs(bits) - 1];
      }
      const float before_chunk = b >= 0 ? run[b] : 0.f;
      __syncwarp();
      if (b >= 0) {
        s_pre[slot * R + i] = before_chunk + excl;
        if ((group & gt) == 0u) run[b] = before_chunk + excl + s_w[i];
      }
      __syncwarp();
    }
  }

  if constexpr (CLUSTER) {
    // ---- c. the lane's tile totals scanned in claim order over the cluster.
    // Claim-order tile o = (row block b, slot s, tile t) = (b k + s) T + t
    // lives in CTA b T + t.  CTA r owns the EB bins from r EB (EB a multiple
    // of 4): every CTA stores its totals into the owners' s_gather (16-byte
    // remote stores, no remote reads); after a barrier each owner scans its
    // bins in claim order (a thread four bins and a segment of kSeg tiles)
    // and stores each tile's bases into that tile's CTA's s_base; after a
    // second barrier every CTA reads its own. ---------------------------
    cg::cluster_group cluster = cg::this_cluster();
    const int C = lane_ctas;
    const int T = tiles_per_block;
    const int eb = owned_bins(e_count, C);
    const int blocks = (n + block_rows - 1) / block_rows;
    __syncthreads();
    cluster_wait();
    const int ep4 = ep / 4;
    const int pushes = cta < blocks * T ? k * ep4 : 0;  // padding CTAs hold no tile
    for (int x = threadIdx.x; x < pushes; x += kThreads) {
      const int slot = x / ep4;
      const int e0 = 4 * (x - slot * ep4);
      const int owner = e0 / eb;
      const int o = (block * k + slot) * T + t;
      *reinterpret_cast<float4*>(cluster.map_shared_rank(s_gather, owner) + o * eb + e0 -
                                 owner * eb) =
          *reinterpret_cast<const float4*>(s_tot + slot * ep + e0);
    }
    cluster.sync();
    // claim-order tiles in segments of kSeg: one thread four bins and a
    // segment sums the segment, then walks it from the sum of the earlier
    // segments
    const int n_ord = blocks * k * T;
    const int nseg = (n_ord + kSeg - 1) / kSeg;
    const int mine = min(eb, e_count - cta * eb);  // this CTA's bins (<= 0: none)
    const int items = mine > 0 ? (mine + 3) / 4 * nseg : 0;
    float4* s_part = reinterpret_cast<float4*>(s_gather + C * k * eb);
    auto add4 = [](float4& a, const float4& x) {
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    };
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int j4 = it / nseg;
      const int g = it - j4 * nseg;
      const int o1 = min(n_ord, (g + 1) * kSeg);
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int o = g * kSeg; o < o1; ++o)
        add4(sum, *reinterpret_cast<const float4*>(s_gather + o * eb + 4 * j4));
      s_part[it] = sum;
    }
    __syncthreads();
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int j4 = it / nseg;
      const int g = it - j4 * nseg;
      const int e0 = cta * eb + 4 * j4;
      float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < g; ++q) add4(carry, s_part[j4 * nseg + q]);
      const int o0 = g * kSeg;
      const int o1 = min(n_ord, o0 + kSeg);
      int tt = o0 % T, slot = (o0 / T) % k, b = o0 / (T * k);
      for (int o = o0; o < o1; ++o) {
        *reinterpret_cast<float4*>(cluster.map_shared_rank(s_base, b * T + tt) + slot * ep + e0) =
            carry;
        add4(carry, *reinterpret_cast<const float4*>(s_gather + o * eb + 4 * j4));
        if (++tt == T) {
          tt = 0;
          if (++slot == k) {
            slot = 0;
            ++b;
          }
        }
      }
    }
    cluster.sync();

    // ---- d. this tile's claims: pos and admit, in claim-index order -------
    const float* lane_caps = caps + static_cast<long long>(problem) * e_count;
    for (int c = threadIdx.x; c < rows * k; c += kThreads) {
      const int i = c / k;
      const int slot = c - i * k;
      const int b = s_bin[slot * R + i];
      float p = 0.f;
      bool a = false;
      if (b >= 0) {
        p = s_base[slot * ep + b] + s_pre[slot * R + i];
        a = p + s_w[i] <= __ldg(lane_caps + b) + 1e-6f;
      }
      const long long o = (r0 + i) * k + slot;
      pos[o] = p;
      admit[o] = a;
    }
  } else {
    __syncthreads();
    // the tile totals, bin-major as the rows form writes them, and each
    // claim's in-tile prefix as pos (the place launch adds the base)
    const long long bin0 = static_cast<long long>(problem) * e_count;
    for (int slot = warp; slot < k; slot += kWarps) {
      const long long tile = (static_cast<long long>(block) * k + slot) * tiles_per_block + t;
      for (int e = lane; e < e_count; e += kWarp)
        tile_tot[(bin0 + e) * n_tiles + tile] = s_tot[slot * ep + e];
    }
    for (int c = threadIdx.x; c < rows * k; c += kThreads) {
      const int i = c / k;
      const int slot = c - i * k;
      const int b = s_bin[slot * R + i];
      pos[(r0 + i) * k + slot] = b >= 0 ? s_pre[slot * R + i] : 0.f;
    }
  }
}

template <int NR>
__global__ void __launch_bounds__(kThreads, 3)
    assign_cluster_kernel(const float* __restrict__ scores, const float* __restrict__ sizes,
                          const float* __restrict__ caps, int n, int e_count, int k,
                          int block_rows, int tiles_per_block, int tile_rows, int lane_ctas,
                          int* __restrict__ idx, float* __restrict__ gate,
                          bool* __restrict__ admit, float* __restrict__ pos) {
  route_tile<true, NR>(scores, sizes, caps, n, e_count, k, block_rows, tiles_per_block,
                       tile_rows, lane_ctas, 0, idx, gate, admit, pos, nullptr);
}

template <int NR>
__global__ void __launch_bounds__(kThreads, 3)
    assign_tile_kernel(const float* __restrict__ scores, const float* __restrict__ sizes,
                       int n, int e_count, int k, int block_rows, int tiles_per_block,
                       int tile_rows, int lane_ctas, int n_tiles, int* __restrict__ idx,
                       float* __restrict__ gate, float* __restrict__ pos,
                       float* __restrict__ tile_tot) {
  route_tile<false, NR>(scores, sizes, nullptr, n, e_count, k, block_rows, tiles_per_block,
                        tile_rows, lane_ctas, n_tiles, idx, gate, nullptr, pos, tile_tot);
}

template <int TILE>
__global__ void assign_place_kernel(const int* __restrict__ idx, const float* __restrict__ sizes,
                                    const float* __restrict__ caps,
                                    const float* __restrict__ base, long long claims, int n,
                                    int e_count, int k, int block_rows, int tiles_per_block,
                                    int n_tiles, bool* __restrict__ admit,
                                    float* __restrict__ pos) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= claims) return;
  const int b = idx[o];
  bool a = false;
  if (b >= 0) {
    const long long lane_claims = static_cast<long long>(n) * k;
    const long long problem = o / lane_claims;
    const long long ol = o - problem * lane_claims;   // claim within its lane
    const long long r = ol / k;
    const int slot = static_cast<int>(ol - r * k);
    const long long block = r / block_rows;
    const int t = static_cast<int>((r - block * block_rows) / TILE);
    const long long tile = (block * k + slot) * tiles_per_block + t;
    const long long bin = problem * e_count + b;
    const float p = base[bin * n_tiles + tile] + pos[o];
    pos[o] = p;
    a = p + sizes[problem * n + r] <= caps[bin] + 1e-6f;
  }
  admit[o] = a;
}

struct Plan {
  int form, tile_rows, block_rows, tiles_per_block, n_tiles, ctas;  // ctas: a lane's
  size_t smem;
};

size_t route_smem(int form, int k, int e_count, int tile_rows, int ctas) {
  const size_t claims = static_cast<size_t>(k) * tile_rows;
  const size_t ep = (e_count + 3) & ~3;
  size_t words = 3 * claims + tile_rows + k * ep;  // s_bin, s_pre, s_val, s_w, s_tot
  if (form == kFormCluster) {  // s_base, s_gather, s_part
    const size_t eb = owned_bins(e_count, ctas);
    const size_t segs = (static_cast<size_t>(ctas) * k + kSeg - 1) / kSeg;
    words += k * ep + static_cast<size_t>(ctas) * k * eb + eb * segs;
  }
  return 4 * words;
}

// The form of a call (see the note at the top).  k = 1 takes claims in row
// order whatever block_n is, so one block holds all rows.
Plan plan(int n, int e_count, int k, int block_n) {
  Plan p{};
  p.block_rows = (k == 1 || block_n > n) ? n : block_n;
  if (p.block_rows < 1) p.block_rows = 1;
  const long long blocks = (static_cast<long long>(n) + p.block_rows - 1) / p.block_rows;
  for (int rows = 32; rows <= 128; rows *= 2) {   // the cluster form: at most 8 tiles a lane
    const long long tiles = blocks * ((p.block_rows + rows - 1) / rows);
    if (tiles > kClusterMax) continue;
    int ctas = 1;
    while (ctas < tiles) ctas *= 2;
    const size_t smem = route_smem(kFormCluster, k, e_count, rows, ctas);
    if (smem > kRouteSmemMax) break;
    p.form = kFormCluster;
    p.tile_rows = rows;
    p.tiles_per_block = (p.block_rows + rows - 1) / rows;
    p.ctas = ctas;
    p.n_tiles = 0;
    p.smem = smem;
    return p;
  }
  const size_t tile_smem = route_smem(kFormTiles, k, e_count, kRouteTileRows, 1);
  p.form = k > 1 && tile_smem <= kRouteSmemMax ? kFormTiles : kFormRows;
  p.tile_rows = p.form == kFormTiles ? kRouteTileRows : kTileRows;
  p.tiles_per_block = (p.block_rows + p.tile_rows - 1) / p.tile_rows;
  p.ctas = static_cast<int>(blocks * p.tiles_per_block);
  p.n_tiles = p.ctas * k;
  p.smem = p.form == kFormTiles
               ? tile_smem
               : sizeof(int) * static_cast<size_t>(k) * kTileRows +
                     sizeof(float) * (kTileRows + static_cast<size_t>(kWarps) * e_count);
  return p;
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The arguments of one call, for the launchers below.
struct Call {
  const float *scores, *sizes, *caps;
  int lanes, n, e_count, k;
  int* idx;
  float* gate;
  bool* admit;
  float *pos, *scratch;
  cudaStream_t st;
};

struct RowsForm {
  template <bool VEC, int NR>
  static cudaError_t launch(const Plan& p, const Call& c) {
    const cudaError_t err = allow_smem(reinterpret_cast<const void*>(assign_rows_kernel<VEC, NR>),
                                       p.smem);
    if (err != cudaSuccess) return err;
    assign_rows_kernel<VEC, NR><<<static_cast<unsigned>(static_cast<long long>(c.lanes) * p.ctas),
                                  kThreads, p.smem, c.st>>>(
        c.scores, c.sizes, c.n, c.e_count, c.k, p.block_rows, p.tiles_per_block, p.n_tiles,
        p.ctas, c.idx, c.gate, c.pos, c.scratch);
    return cudaSuccess;
  }
};

struct TilesForm {
  template <int NR>
  static cudaError_t launch(const Plan& p, const Call& c) {
    const cudaError_t err = allow_smem(reinterpret_cast<const void*>(assign_tile_kernel<NR>),
                                       p.smem);
    if (err != cudaSuccess) return err;
    assign_tile_kernel<NR><<<static_cast<unsigned>(static_cast<long long>(c.lanes) * p.ctas),
                             kThreads, p.smem, c.st>>>(
        c.scores, c.sizes, c.n, c.e_count, c.k, p.block_rows, p.tiles_per_block, p.tile_rows,
        p.ctas, p.n_tiles, c.idx, c.gate, c.pos, c.scratch);
    return cudaSuccess;
  }
};

struct ClusterForm {
  template <int NR>
  static cudaError_t launch(const Plan& p, const Call& c) {
    const cudaError_t err = allow_smem(reinterpret_cast<const void*>(assign_cluster_kernel<NR>),
                                       p.smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(c.lanes) * p.ctas), 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = c.st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(p.ctas);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, assign_cluster_kernel<NR>, c.scores, c.sizes, c.caps, c.n,
                              c.e_count, c.k, p.block_rows, p.tiles_per_block, p.tile_rows,
                              p.ctas, c.idx, c.gate, c.admit, c.pos);
  }
};

// The rows form: the values a lane keeps (enough 128-bin groups for E, at
// most 512 bins) and the 16-byte loads, chosen by E and the scores' alignment.
cudaError_t launch_rows(const Plan& p, const Call& c) {
  const bool vec = c.e_count % 4 == 0 && (reinterpret_cast<uintptr_t>(c.scores) & 15u) == 0;
  const int groups =
      c.e_count > kRegBins ? kMaxRegs / 4 : (c.e_count + 4 * kWarp - 1) / (4 * kWarp);
  switch ((groups < 1 ? 1 : groups) * 2 + (vec ? 1 : 0)) {
    case 2: return RowsForm::launch<false, 4>(p, c);
    case 3: return RowsForm::launch<true, 4>(p, c);
    case 4: return RowsForm::launch<false, 8>(p, c);
    case 5: return RowsForm::launch<true, 8>(p, c);
    case 6: return RowsForm::launch<false, 12>(p, c);
    case 7: return RowsForm::launch<true, 12>(p, c);
    case 8: return RowsForm::launch<false, 16>(p, c);
    default: return RowsForm::launch<true, 16>(p, c);
  }
}

// The routing forms: a lane keeps bins lane + 32 j, j < NR, with NR the
// fewest of 1, 2, 4, 8, 12, 16 that hold E (16 past 512 bins).
template <typename Form_>
cudaError_t launch_route(const Plan& p, const Call& c) {
  const int per = (c.e_count + kWarp - 1) / kWarp;
  if (per <= 1) return Form_::template launch<1>(p, c);
  if (per <= 2) return Form_::template launch<2>(p, c);
  if (per <= 4) return Form_::template launch<4>(p, c);
  if (per <= 8) return Form_::template launch<8>(p, c);
  if (per <= 12) return Form_::template launch<12>(p, c);
  return Form_::template launch<16>(p, c);
}

}  // namespace

// Floats of scratch the caller allocates for assign_launch: K * E * n_tiles
// (0 for the cluster form, which keeps its tile totals in shared memory).
extern "C" long long assign_scratch_floats(int lanes, int n, int e_count, int k, int block_n) {
  if (lanes <= 0 || n <= 0 || k <= 0) return 0;
  return static_cast<long long>(lanes) * e_count * plan(n, e_count, k, block_n).n_tiles;
}

// The form assign_launch takes for these shapes: out[0] the form (0 rows,
// 1 cluster, 2 tiles), out[1] the rows of a tile, out[2] a lane's CTAs (the
// cluster size in the cluster form), out[3] the launches of a call.
extern "C" void assign_plan(int lanes, int n, int e_count, int k, int block_n, int* out) {
  const Plan p = plan(n < 1 ? 1 : n, e_count, k < 1 ? 1 : k, block_n);
  out[0] = p.form;
  out[1] = p.tile_rows;
  out[2] = p.ctas;
  out[3] = lanes <= 0 || n <= 0 || k <= 0 ? 0 : p.form == kFormCluster ? 1 : 3;
}

// Launch the form's passes over `lanes` problems of n rows on `stream`;
// returns the first launch error, else cudaGetLastError() after them.
extern "C" int assign_launch(const float* scores, const float* sizes, const float* caps,
                             int lanes, int n, int e_count, int k, int block_n, int* idx,
                             float* gate, bool* admit, float* pos, float* scratch,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  const Plan p = plan(n, e_count, k, block_n);
  const Call c{scores, sizes, caps, lanes, n, e_count, k, idx, gate, admit, pos, scratch, st};
  cudaError_t err = p.form == kFormCluster ? launch_route<ClusterForm>(p, c)
                    : p.form == kFormTiles ? launch_route<TilesForm>(p, c)
                                           : launch_rows(p, c);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.form == kFormCluster) return static_cast<int>(cudaGetLastError());
  const int bins = lanes * e_count;   // rows of the tile totals, one warp each
  if (bins > 0) {
    assign_base_kernel<<<(bins + kWarps - 1) / kWarps, kThreads, 0, st>>>(scratch, p.n_tiles,
                                                                         bins);
  }
  const long long claims = static_cast<long long>(lanes) * n * k;
  const unsigned place_ctas = static_cast<unsigned>((claims + kPlaceThreads - 1) / kPlaceThreads);
  if (p.form == kFormTiles) {
    assign_place_kernel<kRouteTileRows><<<place_ctas, kPlaceThreads, 0, st>>>(
        idx, sizes, caps, scratch, claims, n, e_count, k, p.block_rows, p.tiles_per_block,
        p.n_tiles, admit, pos);
  } else {
    assign_place_kernel<kTileRows><<<place_ctas, kPlaceThreads, 0, st>>>(
        idx, sizes, caps, scratch, claims, n, e_count, k, p.block_rows, p.tiles_per_block,
        p.n_tiles, admit, pos);
  }
  return static_cast<int>(cudaGetLastError());
}
