// Per-segment sums in row order, deterministic on the card (sm_90a).
//
// Takes the place of the engine's scatter-adds (src/repro/core/engine.py:142,
// jax.ops.segment_sum; no TPU kernel: XLA lowers it to a scatter).  On the
// CPU that scatter adds rows in index order, and the float per-site sums
// (freed and used memory, queued work, the start phase's segment totals)
// depend on that order in their last bits.  CUDA atomics add in an order that
// changes from run to run, so this kernel keeps the CPU's order instead.
//
// The wrapper stably sorts the segment ids; `perm` lists the rows of segment
// s, in row order, at perm[offsets[s] .. offsets[s+1]).  One thread per
// segment then folds its rows sequentially from 0, exactly as the scatter
// does.  Integer sums take the same path (they are exact in any order).
//
// Bound: the inputs are J*(4*F + 4) bytes plus the sort; at J=100000 that is
// well under a megabyte, so the kernel is bound by launch latency and by the
// longest segment's serial chain, not by bytes or operations.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFeatures = 4;
constexpr int kThreads = 128;

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ values, int features,
                                   const long long* __restrict__ perm,
                                   const long long* __restrict__ offsets, int segments,
                                   T* __restrict__ out) {
  const int seg = blockIdx.x * blockDim.x + threadIdx.x;
  if (seg >= segments) return;
  T acc[kMaxFeatures];
  for (int f = 0; f < kMaxFeatures; ++f) acc[f] = T(0);
  const long long lo = offsets[seg], hi = offsets[seg + 1];
  for (long long i = lo; i < hi; ++i) {
    const long long row = perm[i];
    for (int f = 0; f < features; ++f) acc[f] += values[row * features + f];
  }
  for (int f = 0; f < features; ++f) out[static_cast<long long>(seg) * features + f] = acc[f];
}

template <typename T>
int launch(const T* values, int features, const long long* perm, const long long* offsets,
           int segments, T* out, void* stream) {
  if (features < 1 || features > kMaxFeatures) return static_cast<int>(cudaErrorInvalidValue);
  if (segments > 0) {
    const int grid = (segments + kThreads - 1) / kThreads;
    segment_sum_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        values, features, perm, offsets, segments, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int segment_sum_f32(const float* values, int features, const long long* perm,
                               const long long* offsets, int segments, float* out,
                               void* stream) {
  return launch<float>(values, features, perm, offsets, segments, out, stream);
}

extern "C" int segment_sum_i32(const int* values, int features, const long long* perm,
                               const long long* offsets, int segments, int* out, void* stream) {
  return launch<int>(values, features, perm, offsets, segments, out, stream);
}
