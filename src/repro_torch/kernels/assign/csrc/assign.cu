// Capacity-constrained greedy assignment on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/assign/assign.py:_assign_kernel
// (entry point assign_pallas).  Semantics are those of ref.assign_ref: row
// softmax gates over feasible bins (score > -5e29), k slot-major first-argmax
// rounds with ties to the lowest bin, and FIFO admission against per-bin
// capacity, where claims are taken in the order (row block of block_n, slot,
// row) and a per-bin `used` carry counts every claim, admitted or not.
//
// Bound: pass 1 reads the N x E f32 score matrix once (120 MB at the engine's
// N=100000, E=300), so the kernel is bound by device-memory bandwidth.  This
// first design does nothing about that bound beyond coalesced row reads: one
// warp per row, lanes striding over the bins.  Pass 2 reads only idx/sizes
// (N*k*4 + N*4 bytes per bin, served from L2).
//
// The TPU grid walked row blocks in order and carried `used` in VMEM scratch.
// Blocks on this card run in no order, so the work splits in two passes:
//   pass 1 (rows):      one warp per row computes the gates and the k picks and
//                       writes idx/gate with pos = 0, admit = false defaults;
//   pass 2 (admission): one CTA per bin walks the claims in the TPU kernel's
//                       order, a block-wide exclusive prefix sum of sizes over
//                       the rows that picked this bin in each chunk, with
//                       `used` carried in a register from chunk to chunk.
// Each (row, slot) pair belongs to one bin, so pass-2 writes never collide.
// For integral sizes (cores; tokens = 1) every prefix sum is exact in f32, so
// idx, admit and pos equal the plain version bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;       // infeasible-score marker
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;        // pass 1: one warp per row
constexpr int kScanThreads = 256;       // pass 2: threads of one bin's CTA
constexpr unsigned kFull = 0xffffffffu;

// (v, i) comes before (bv, bi) in pick order: larger score first, lower bin
// on ties.  A strict total order, so the k picks of a row are its first k
// elements in this order.
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void assign_rows_kernel(const float* __restrict__ scores, int n, int e_count, int k,
                                   int* __restrict__ idx, float* __restrict__ gate,
                                   bool* __restrict__ admit, float* __restrict__ pos) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long row = static_cast<long>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= n) return;
  const float* s = scores + row * e_count;

  float m = -INFINITY;
  for (int e = lane; e < e_count; e += kWarp) {
    const float v = s[e];
    if (v > kNegInf / 2) m = fmaxf(m, v);
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));

  float denom = 0.f;
  for (int e = lane; e < e_count; e += kWarp) {
    const float v = s[e];
    if (v > kNegInf / 2) denom += expf(v - m);
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) denom += __shfl_xor_sync(kFull, denom, off);
  denom = fmaxf(denom, 1e-30f);

  float last_v = INFINITY;  // the previous pick; nothing comes before it yet
  int last_i = -1;
  bool live = true;         // every pick so far was feasible
  for (int slot = 0; slot < k; ++slot) {
    float bv = -INFINITY;
    int bi = e_count;
    if (live) {
      for (int e = lane; e < e_count; e += kWarp) {
        const float v = s[e];
        if (slot > 0 && (e == last_i || before(v, e, last_v, last_i))) continue;  // picked
        if (before(v, e, bv, bi)) { bv = v; bi = e; }
      }
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (before(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      live = bv > kNegInf / 2;
    }
    if (lane == 0) {
      const long o = row * k + slot;
      idx[o] = live ? bi : -1;
      gate[o] = live ? expf(bv - m) / denom : 0.f;
      pos[o] = 0.f;
      admit[o] = false;
    }
    last_v = bv;
    last_i = bi;
  }
}

__device__ __forceinline__ float warp_inclusive_scan(float x, int lane) {
  for (int off = 1; off < kWarp; off <<= 1) {
    const float y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

__global__ void assign_admit_kernel(const int* __restrict__ idx, const float* __restrict__ sizes,
                                    const float* __restrict__ caps, int n, int k, int block_n,
                                    bool* __restrict__ admit, float* __restrict__ pos) {
  constexpr int kWarps = kScanThreads / kWarp;
  __shared__ float warp_total[kWarps];
  const int bin = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const float cap = caps[bin] + 1e-6f;
  float used = 0.f;  // units claimed from this bin by earlier chunks

  for (long b0 = 0; b0 < n; b0 += block_n) {
    const long b1 = b0 + block_n < n ? b0 + block_n : static_cast<long>(n);
    for (int slot = 0; slot < k; ++slot) {
      for (long r0 = b0; r0 < b1; r0 += kScanThreads) {
        const long r = r0 + threadIdx.x;
        const bool member = r < b1 && idx[r * k + slot] == bin;
        if (__syncthreads_count(member) == 0) continue;
        const float w = member ? sizes[r] : 0.f;
        const float incl = warp_inclusive_scan(w, lane);
        if (lane == kWarp - 1) warp_total[warp] = incl;
        __syncthreads();
        if (warp == 0) {
          float t = lane < kWarps ? warp_total[lane] : 0.f;
          t = warp_inclusive_scan(t, lane);
          if (lane < kWarps) warp_total[lane] = t;
        }
        __syncthreads();
        float excl = __shfl_up_sync(kFull, incl, 1);
        if (lane == 0) excl = 0.f;
        if (warp > 0) excl += warp_total[warp - 1];
        if (member) {
          const float p = used + excl;
          pos[r * k + slot] = p;
          admit[r * k + slot] = p + w <= cap;
        }
        used += warp_total[kWarps - 1];
        __syncthreads();  // warp_total is rewritten by the next chunk
      }
    }
  }
}

}  // namespace

// Launch both passes on `stream`; returns cudaGetLastError() after them.
extern "C" int assign_launch(const float* scores, const float* sizes, const float* caps, int n,
                             int e_count, int k, int block_n, int* idx, float* gate, bool* admit,
                             float* pos, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0 && k > 0) {
    const int rows_grid = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    assign_rows_kernel<<<rows_grid, kRowsPerBlock * kWarp, 0, st>>>(scores, n, e_count, k, idx,
                                                                    gate, admit, pos);
    if (e_count > 0) {
      assign_admit_kernel<<<e_count, kScanThreads, 0, st>>>(idx, sizes, caps, n, k, block_n,
                                                            admit, pos);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
