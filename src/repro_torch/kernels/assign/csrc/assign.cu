// Capacity-constrained greedy assignment on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/assign/assign.py:_assign_kernel
// (entry point assign_pallas).  Semantics are those of ref.assign_ref: row
// softmax gates over feasible bins (score > -5e29), k slot-major first-argmax
// rounds with ties to the lowest bin, and FIFO admission against per-bin
// capacity, where claims are taken in the order (row block of block_n, slot,
// row) and a per-bin `used` carry counts every claim, admitted or not.
//
// Bound: the kernel reads the N x E f32 score matrix once (120 MB at the
// engine's N=100000, E=300; 0.036 ms at 3.35 TB/s) and everything else is
// small, so it is bound by device-memory bandwidth.
//
// The TPU grid walked row blocks in order and carried `used` in VMEM scratch.
// Because every claim counts, a claim's `pos` is simply the exclusive prefix
// of sizes over the earlier claims of its bin in claim order, so admission is
// a segmented scan and needs no walk of all claims per bin.  Claims are cut
// into tiles, each a run of kTileRows rows of one slot within one row block
// (tiles are numbered in claim order), and the work takes three launches:
//   1. rows (one CTA a tile's rows, one warp a row): the row is read once
//      from device memory into registers (16-byte loads when E % 4 == 0,
//      up to 16 values a lane, so E <= 512 stays in registers; wider rows
//      reread the rest from L1/L2), the warp's next two rows loading while
//      it works; the max (with the first pick), the exp-sum and the other
//      picks come from registers.  Then, per slot, one warp walks the tile's claims
//      in row order, 32 at a time: a claim's in-tile prefix is the sum of the
//      sizes of the earlier lanes with its bin (shuffles) plus the bin's
//      running total in shared memory.  It writes that prefix as `pos` and
//      the tile's per-bin totals (bin-major, [E][n_tiles]).
//   2. base (one warp a bin): the exclusive prefix of the tile totals over
//      tiles, in place, 32 tiles a step.
//   3. place (one thread a claim): pos += its tile's base for its bin, and
//      admit = pos + size <= cap + 1e-6.
// The scans add in another order than the plain version's cumulative sum.
// For integral sizes (cores; tokens = 1) whose sums stay below 2^24 every
// partial sum is an integer that f32 holds exactly, so idx, admit and pos
// equal the plain version bit for bit (as in fused.cu); nothing uses atomics,
// so every run gives the same bits for any sizes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
                       int* __restrict__ idx, float* __restrict__ gate, float* __restrict__ pos,
                       float* __restrict__ tile_tot) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_bin = reinterpret_cast<int*>(smem);                     // [k][kTileRows]
  float* s_w = reinterpret_cast<float*>(s_bin + k * kTileRows);  // [kTileRows]
  float* s_run = s_w + kTileRows;                                // [kWarps][E]
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int block = blockIdx.x / tiles_per_block;
  const int t = blockIdx.x % tiles_per_block;
  const long long blk0 = static_cast<long long>(block) * block_rows;
  const long long r0 = blk0 + static_cast<long long>(t) * kTileRows;
  long long r1 = r0 + kTileRows;
  if (r1 > blk0 + block_rows) r1 = blk0 + block_rows;
  if (r1 > n) r1 = n;
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
    for (int e = lane; e < e_count; e += kWarp) tile_tot[e * static_cast<long long>(n_tiles) + tile] = run[e];
    __syncwarp();
  }
}

// tile_tot[e][*] becomes its exclusive prefix over tiles, in place.
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

__global__ void assign_place_kernel(const int* __restrict__ idx, const float* __restrict__ sizes,
                                    const float* __restrict__ caps,
                                    const float* __restrict__ base, long long claims, int k,
                                    int block_rows, int tiles_per_block, int n_tiles,
                                    bool* __restrict__ admit, float* __restrict__ pos) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= claims) return;
  const int b = idx[o];
  bool a = false;
  if (b >= 0) {
    const long long r = o / k;
    const int slot = static_cast<int>(o - r * k);
    const long long block = r / block_rows;
    const int t = static_cast<int>((r - block * block_rows) / kTileRows);
    const long long tile = (block * k + slot) * tiles_per_block + t;
    const float p = base[static_cast<long long>(b) * n_tiles + tile] + pos[o];
    pos[o] = p;
    a = p + sizes[r] <= caps[b] + 1e-6f;
  }
  admit[o] = a;
}

struct Plan {
  int block_rows, tiles_per_block, n_tiles, ctas;
};

// k = 1 takes claims in row order whatever block_n is, so one block holds all rows.
Plan plan(int n, int k, int block_n) {
  Plan p{};
  p.block_rows = (k == 1 || block_n > n) ? n : block_n;
  if (p.block_rows < 1) p.block_rows = 1;
  p.tiles_per_block = (p.block_rows + kTileRows - 1) / kTileRows;
  const long long blocks = (static_cast<long long>(n) + p.block_rows - 1) / p.block_rows;
  p.ctas = static_cast<int>(blocks * p.tiles_per_block);
  p.n_tiles = p.ctas * k;
  return p;
}

template <bool VEC, int NR>
cudaError_t launch_rows(const Plan& p, size_t smem, cudaStream_t st, const float* scores,
                        const float* sizes, int n, int e_count, int k, int* idx, float* gate,
                        float* pos, float* scratch) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_rows_kernel<VEC, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  assign_rows_kernel<VEC, NR><<<p.ctas, kThreads, smem, st>>>(
      scores, sizes, n, e_count, k, p.block_rows, p.tiles_per_block, p.n_tiles, idx, gate, pos,
      scratch);
  return cudaSuccess;
}

}  // namespace

// Floats of scratch the caller allocates for assign_launch: E * n_tiles.
extern "C" long long assign_scratch_floats(int n, int e_count, int k, int block_n) {
  if (n <= 0 || k <= 0) return 0;
  return static_cast<long long>(e_count) * plan(n, k, block_n).n_tiles;
}

// Launch the three passes on `stream`; returns cudaGetLastError() after them.
extern "C" int assign_launch(const float* scores, const float* sizes, const float* caps, int n,
                             int e_count, int k, int block_n, int* idx, float* gate, bool* admit,
                             float* pos, float* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  const Plan p = plan(n, k, block_n);
  const size_t smem = sizeof(int) * static_cast<size_t>(k) * kTileRows +
                      sizeof(float) * (kTileRows + static_cast<size_t>(kWarps) * e_count);
  const bool vec = e_count % 4 == 0 && (reinterpret_cast<uintptr_t>(scores) & 15u) == 0;
  // values a lane keeps: enough 128-bin groups for E, at most 512 bins
  const int groups = e_count > kRegBins ? kMaxRegs / 4 : (e_count + 4 * kWarp - 1) / (4 * kWarp);
  cudaError_t err = cudaSuccess;
  switch ((groups < 1 ? 1 : groups) * 2 + (vec ? 1 : 0)) {
    case 2: err = launch_rows<false, 4>(p, smem, st, scores, sizes, n, e_count, k, idx, gate, pos, scratch); break;
    case 3: err = launch_rows<true, 4>(p, smem, st, scores, sizes, n, e_count, k, idx, gate, pos, scratch); break;
    case 4: err = launch_rows<false, 8>(p, smem, st, scores, sizes, n, e_count, k, idx, gate, pos, scratch); break;
    case 5: err = launch_rows<true, 8>(p, smem, st, scores, sizes, n, e_count, k, idx, gate, pos, scratch); break;
    case 6: err = launch_rows<false, 12>(p, smem, st, scores, sizes, n, e_count, k, idx, gate, pos, scratch); break;
    case 7: err = launch_rows<true, 12>(p, smem, st, scores, sizes, n, e_count, k, idx, gate, pos, scratch); break;
    case 8: err = launch_rows<false, 16>(p, smem, st, scores, sizes, n, e_count, k, idx, gate, pos, scratch); break;
    default: err = launch_rows<true, 16>(p, smem, st, scores, sizes, n, e_count, k, idx, gate, pos, scratch); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (e_count > 0) {
    assign_base_kernel<<<(e_count + kWarps - 1) / kWarps, kThreads, 0, st>>>(scratch, p.n_tiles,
                                                                            e_count);
  }
  const long long claims = static_cast<long long>(n) * k;
  assign_place_kernel<<<static_cast<unsigned>((claims + kPlaceThreads - 1) / kPlaceThreads),
                        kPlaceThreads, 0, st>>>(idx, sizes, caps, scratch, claims, k,
                                                p.block_rows, p.tiles_per_block, p.n_tiles, admit,
                                                pos);
  return static_cast<int>(cudaGetLastError());
}
