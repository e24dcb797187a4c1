// Gradient of the assignment's gates with respect to the scores, on Hopper
// (sm_90a): the MoE router's backward.
//
// Replaces no TPU kernel: the JAX package trains its router through XLA's
// autodiff of assign_ref's masked row softmax (src/repro/kernels/assign/
// ref.py:35-39), gathered at the picks (:68), from moe_route's combine
// weights (ops.py:117-120).  The port's forward on the card is the
// assignment kernel (assign.cu), whose `gate` output is the only one with a
// gradient; the plain version is ref.gate_backward_ref.  For one row with
// feasible bins (score > -5e29), g = softmax over them, picks idx[0..k-1]
// (-1 where infeasible) and the gates' gradient dgate[0..k-1]:
//   G_e = sum of dgate_j over the slots j with idx_j == e (slot order),
//   dot = sum_e G_e g_e,  dscores_e = g_e (G_e - dot) on feasible e, else 0;
// an infeasible pick adds nothing (its gate is 0 whatever the scores), and
// a row without a feasible bin gets zeros.
//
// Bound: one read of the scores, the picks and dgate and one write of
// dscores, all f32 or i32: 5.2 MB at granite-moe's router [32, 512, 32],
// k = 8 (1.6 us at 3.35 TB/s), 51.4 MB at kimi-k2's [32, 512, 384] (15.3
// us), so bytes bound it.  What held a row back was latency: the k slots'
// picks and gradients loaded one slot after another, each by every lane.
//
// One warp a row, 8 warps a CTA; a warp walks a run of consecutive rows
// (rows_per_warp, chosen so that the card's warps cover the rows about once),
// the next row's scores, picks and gradients loading while the row is worked
// on.  A lane keeps NR values of a row, NR matched to E (1 at E <= 32, 2 at
// E <= 64, then 4, 8, 12 or 16 up to 512): bins lane + 32 i, or with VEC
// (E % 4 == 0, NR >= 4, 16-byte aligned rows) float4 j of the lane holding
// bins 4 (lane + 32 j) .. + 3, read and written with 16-byte accesses.
// Lane j holds slot j's pick and gradient (one coalesced load each for up
// to 32 slots).  At E <= 64 the lanes broadcast them by shuffles and each
// lane adds those of its bins, in slot order.  Above, where that costs k
// compares a value, lane j stores its gradient into the warp's table of E
// gradients in shared memory (zeros elsewhere), from which each lane reads
// G for its bins (picks of one bin in two slots, or k > 32, add in slot
// order, by one lane), and g is p times the exp-sum's reciprocal (within an
// ulp of p / sum).  The max, the exp-sum and dot are shuffle trees in a
// fixed order and nothing uses atomics, so every run gives the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // infeasible-score marker
constexpr int kWarp = 32;
constexpr int kMaxPer = 16;        // bins a lane: E <= 512
constexpr int kWarps = 8;          // warps of a CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// The bin of value i of `lane`.
template <int NR, bool VEC>
__device__ __forceinline__ int bin_of(int i, int lane) {
  return VEC ? 4 * (lane + kWarp * (i / 4)) + (i % 4) : lane + kWarp * i;
}

// A row's values for this lane (bins past E read as infeasible), and the
// pick and gradient of slot `lane` (when below k).
template <int NR, bool VEC>
__device__ __forceinline__ void load_row(float (&v)[NR], int& pick, float& dg,
                                         const float* __restrict__ s,
                                         const int* __restrict__ idx,
                                         const float* __restrict__ dgate, int e_count, int k,
                                         int lane) {
  if (VEC) {
#pragma unroll
    for (int j = 0; j < NR / 4; ++j) {
      const int e = 4 * (lane + kWarp * j);
      float4 x = make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
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
      v[i] = e < e_count ? __ldg(s + e) : kNegInf;
    }
  }
  pick = lane < k ? __ldg(idx + lane) : -1;
  dg = lane < k ? __ldg(dgate + lane) : 0.f;
}

// G of one row into the warp's table g (zero outside the row's picks):
// g[idx_j] = dgate_j.  Slot `lane` of the first 32 is in (pick, dg).  Picks
// of one bin in more than one slot, or k > 32, add in slot order, by one
// lane.
__device__ __forceinline__ void fold_picks(float* g, int pick, float dg,
                                           const int* __restrict__ idx,
                                           const float* __restrict__ dgate, int e_count, int k,
                                           int lane) {
  // a pick outside [0, E) adds nothing; idle lanes take a key of their own
  const int key = lane < k && pick >= 0 && pick < e_count ? pick : -1 - lane;
  const unsigned same = __match_any_sync(kFull, key);
  if (k <= kWarp && !__any_sync(kFull, __popc(same) > 1)) {
    if (key >= 0) g[key] = dg;
  } else if (lane == 0) {
    for (int j = 0; j < k; ++j) {
      const int e = __ldg(idx + j);
      if (e >= 0 && e < e_count) g[e] += __ldg(dgate + j);
    }
  }
  __syncwarp();
}

// The warp's table of a row's gradients by bin, in shared memory, where a
// lane keeps more than two values of a row.
template <bool TABLE>
__device__ __forceinline__ float* warp_table() {
  if constexpr (TABLE) {
    __shared__ __align__(16) float s_g[kWarps][kWarp * kMaxPer];
    return s_g[threadIdx.x >> 5];
  } else {
    return nullptr;
  }
}

template <int NR, bool VEC>
__global__ void __launch_bounds__(kWarp * kWarps)
gate_backward_kernel(const float* __restrict__ scores, const int* __restrict__ idx,
                     const float* __restrict__ dgate, float* __restrict__ dscores,
                     long long rows, int e_count, int k, int rows_per_warp) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * rows_per_warp;
  if (first >= rows) return;  // a whole warp leaves together
  const long long end = first + rows_per_warp < rows ? first + rows_per_warp : rows;
  float* g = warp_table<(NR > 2)>();  // zeros but at a row's picks
  if constexpr (NR > 2) {
    for (int e = lane; e < kWarp * NR; e += kWarp) g[e] = 0.f;
    __syncwarp();
  }

  float v[NR], nv[NR];
  int pick, npick;
  float dg, ndg;
  load_row<NR, VEC>(v, pick, dg, scores + first * e_count, idx + first * k, dgate + first * k,
                    e_count, k, lane);
  for (long long row = first; row < end; ++row) {
    if (row + 1 < end) {
      load_row<NR, VEC>(nv, npick, ndg, scores + (row + 1) * e_count, idx + (row + 1) * k,
                        dgate + (row + 1) * k, e_count, k, lane);
    }
    float* out = dscores + row * e_count;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < NR; ++i)
      if (v[i] > 0.5f * kNegInf) mx = fmaxf(mx, v[i]);
    mx = warp_max(mx);
    if (mx == -INFINITY) {  // no feasible bin: every gate is 0
#pragma unroll
      for (int i = 0; i < NR; ++i) v[i] = 0.f;
    } else {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        v[i] = v[i] > 0.5f * kNegInf ? expf(v[i] - mx) : 0.f;  // p; 0 off the feasible bins
        sum += v[i];
      }
      const float denom = fmaxf(warp_sum(sum), 1e-30f);
      float G[NR];
      if constexpr (NR <= 2) {
        // a few bins a lane: each slot's pick and gradient broadcast from
        // its lane by shuffles, in slot order
#pragma unroll
        for (int i = 0; i < NR; ++i) G[i] = 0.f;
        for (int j0 = 0; j0 < k; j0 += kWarp) {
          int e_l = pick;
          float d_l = dg;
          if (j0 > 0) {  // slots past the first 32
            e_l = j0 + lane < k ? __ldg(idx + row * k + j0 + lane) : -1;
            d_l = j0 + lane < k ? __ldg(dgate + row * k + j0 + lane) : 0.f;
          }
          const int nj = k - j0 < kWarp ? k - j0 : kWarp;
#pragma unroll 8
          for (int j = 0; j < nj; ++j) {
            const int e = __shfl_sync(kFull, e_l, j);
            const float d = __shfl_sync(kFull, d_l, j);
#pragma unroll
            for (int i = 0; i < NR; ++i)
              if (e == bin_of<NR, VEC>(i, lane)) G[i] += d;
          }
        }
#pragma unroll
        for (int i = 0; i < NR; ++i) v[i] = v[i] / denom;  // g
      } else {
        // many bins a lane: the picks' gradients through the warp's table
        fold_picks(g, pick, dg, idx + row * k, dgate + row * k, e_count, k, lane);
        if (VEC) {
#pragma unroll
          for (int j = 0; j < NR / 4; ++j) {
            const float4 x = *reinterpret_cast<const float4*>(g + 4 * (lane + kWarp * j));
            G[4 * j] = x.x;
            G[4 * j + 1] = x.y;
            G[4 * j + 2] = x.z;
            G[4 * j + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < NR; ++i) G[i] = g[lane + kWarp * i];
        }
        __syncwarp();
        for (int j = lane; j < k; j += kWarp) {  // the table back to zeros
          const int e = __ldg(idx + row * k + j);
          if (e >= 0 && e < e_count) g[e] = 0.f;
        }
        __syncwarp();
        const float inv = 1.f / denom;
#pragma unroll
        for (int i = 0; i < NR; ++i) v[i] = v[i] * inv;  // g
      }
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NR; ++i) dot = fmaf(G[i], v[i], dot);
      dot = warp_sum(dot);
#pragma unroll
      for (int i = 0; i < NR; ++i) v[i] = v[i] > 0.f ? v[i] * (G[i] - dot) : 0.f;
    }
    if (VEC) {
#pragma unroll
      for (int j = 0; j < NR / 4; ++j) {
        const int e = 4 * (lane + kWarp * j);
        if (e < e_count)
          *reinterpret_cast<float4*>(out + e) =
              make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int e = lane + kWarp * i;
        if (e < e_count) out[e] = v[i];
      }
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) v[i] = nv[i];
    pick = npick;
    dg = ndg;
  }
}

template <int NR, bool VEC>
cudaError_t launch(const float* scores, const int* idx, const float* dgate, float* dscores,
                   long long rows, int e_count, int k, cudaStream_t stream) {
  // about one run of rows a warp over the card's resident warps (64 an SM)
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long warps = static_cast<long long>(sms) * 64;
  long long per = (rows + warps - 1) / warps;
  per = per < 1 ? 1 : per > 8 ? 8 : per;
  const long long blocks = (rows + per * kWarps - 1) / (per * kWarps);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gate_backward_kernel<NR, VEC><<<static_cast<unsigned>(blocks), kWarp * kWarps, 0, stream>>>(
      scores, idx, dgate, dscores, rows, e_count, k, static_cast<int>(per));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest E the kernel takes.
int gate_backward_max_bins() { return kWarp * kMaxPer; }

// scores f32[rows, E], idx i32[rows, k], dgate f32[rows, k] -> dscores
// f32[rows, E], all contiguous.  Returns a cudaError_t (0 on success).
int gate_backward_launch(const float* scores, const int* idx, const float* dgate,
                         float* dscores, long long rows, int e_count, int k,
                         cudaStream_t stream) {
  if (rows < 0 || e_count <= 0 || e_count > kWarp * kMaxPer || k <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const bool vec = e_count % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(scores) | reinterpret_cast<uintptr_t>(dscores)) &
                    15u) == 0;
  const int per = (e_count + kWarp - 1) / kWarp;  // values a lane needs
  if (per <= 1) return launch<1, false>(scores, idx, dgate, dscores, rows, e_count, k, stream);
  if (per <= 2) return launch<2, false>(scores, idx, dgate, dscores, rows, e_count, k, stream);
  if (per <= 4)
    return vec ? launch<4, true>(scores, idx, dgate, dscores, rows, e_count, k, stream)
               : launch<4, false>(scores, idx, dgate, dscores, rows, e_count, k, stream);
  if (per <= 8)
    return vec ? launch<8, true>(scores, idx, dgate, dscores, rows, e_count, k, stream)
               : launch<8, false>(scores, idx, dgate, dscores, rows, e_count, k, stream);
  if (per <= 12)
    return vec ? launch<12, true>(scores, idx, dgate, dscores, rows, e_count, k, stream)
               : launch<12, false>(scores, idx, dgate, dscores, rows, e_count, k, stream);
  return vec ? launch<16, true>(scores, idx, dgate, dscores, rows, e_count, k, stream)
             : launch<16, false>(scores, idx, dgate, dscores, rows, e_count, k, stream);
}

}  // extern "C"
