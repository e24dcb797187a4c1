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
// k = 8 (1.6 us at 3.35 TB/s), so bytes bound it.
//
// One warp a row, 8 rows a CTA: a lane keeps bins lane + 32 i (i < 16, so
// E <= 512) in registers, each load a coalesced 128-byte row segment; the
// max, the exp-sum and dot are shuffle trees in a fixed order and nothing
// uses atomics, so every run gives the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // infeasible-score marker
constexpr int kWarp = 32;
constexpr int kPer = 16;           // bins a lane: E <= 512
constexpr int kRowsPerCta = 8;
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

__global__ void __launch_bounds__(kWarp * kRowsPerCta)
gate_backward_kernel(const float* __restrict__ scores, const int* __restrict__ idx,
                     const float* __restrict__ dgate, float* __restrict__ dscores,
                     long long rows, int e_count, int k) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerCta + (threadIdx.x >> 5);
  const int lane = threadIdx.x & (kWarp - 1);
  if (row >= rows) return;  // a whole warp leaves together
  const float* s = scores + row * e_count;
  float* out = dscores + row * e_count;

  float v[kPer];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = lane + kWarp * i;
    v[i] = e < e_count ? s[e] : kNegInf;
    if (v[i] > 0.5f * kNegInf) mx = fmaxf(mx, v[i]);
  }
  mx = warp_max(mx);
  if (mx == -INFINITY) {  // no feasible bin: every gate is 0
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + kWarp * i;
      if (e < e_count) out[e] = 0.f;
    }
    return;
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    v[i] = v[i] > 0.5f * kNegInf ? expf(v[i] - mx) : 0.f;  // p; 0 off the feasible bins
    sum += v[i];
  }
  const float denom = fmaxf(warp_sum(sum), 1e-30f);

  float G[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) G[i] = 0.f;
  for (int j = 0; j < k; ++j) {
    const int e = idx[row * k + j];
    const float dg = dgate[row * k + j];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (e >= 0 && e == lane + kWarp * i) G[i] += dg;
  }
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    v[i] = v[i] / denom;  // g
    dot = fmaf(G[i], v[i], dot);
  }
  dot = warp_sum(dot);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = lane + kWarp * i;
    if (e < e_count) out[e] = v[i] * (G[i] - dot);  // g is 0 off the feasible bins
  }
}

}  // namespace

extern "C" {

// The largest E the kernel takes.
int gate_backward_max_bins() { return kWarp * kPer; }

// scores f32[rows, E], idx i32[rows, k], dgate f32[rows, k] -> dscores
// f32[rows, E], all contiguous.  Returns a cudaError_t (0 on success).
int gate_backward_launch(const float* scores, const int* idx, const float* dgate,
                         float* dscores, long long rows, int e_count, int k,
                         cudaStream_t stream) {
  if (rows < 0 || e_count <= 0 || e_count > kWarp * kPer || k <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const long long blocks = (rows + kRowsPerCta - 1) / kRowsPerCta;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gate_backward_kernel<<<static_cast<unsigned>(blocks), kWarp * kRowsPerCta, 0, stream>>>(
      scores, idx, dgate, dscores, rows, e_count, k);
  return cudaGetLastError();
}

}  // extern "C"
