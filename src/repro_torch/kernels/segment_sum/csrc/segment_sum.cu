// Per-segment sums in row order, deterministic, in one launch up to 25599
// segments (sm_90a).
//
// Takes the place of the engine's scatter-adds (src/repro/core/engine.py:142,
// jax.ops.segment_sum; no TPU kernel: XLA lowers it to a scatter).  On the
// CPU that scatter adds rows in index order from +0.0, and the float
// per-site sums (freed and used memory, queued work, the start phase's
// segment totals) depend on that order in their last bits.  CUDA atomics add
// floats in an order that changes from run to run, so this kernel keeps the
// CPU's order instead.  Ids outside [0, S) are dropped; in most engine calls
// most rows carry the padding id S.
//
// Bound: the inputs are J*(4*F + 4) bytes, 0.8 MB at J=100000 and F=1
// (0.00024 ms at 3.35 TB/s), so bytes do not bound it.  Float addition is
// not associative: each segment's sum is a chain of dependent adds in row
// order, so the parallelism is across segments, and the kernel is bound by
// its launch, its three grid-wide barriers and the longest segment's chain.
// Worst case: one segment holding all J=100000 rows is 100000 dependent adds
// (~4 cycles each, ~0.25 ms); the sort-based design before this one had the
// same chain with a dependent global load per step.
//
// Design: a stable counting sort of the rows by segment, then one warp a
// segment folds its rows in order, all in one cooperative launch:
//   A. count: each warp of the grid takes a slice of rows (warp g's rows all
//      come before warp g + 1's) and counts them per segment in shared
//      memory; a CTA writes its per-segment counts;
//   B. (grid barrier) offsets: one warp a segment scans that segment's
//      counts over the CTAs, in place, 32 CTAs a step;
//   C. (grid barrier) scatter: each CTA scans the segments' totals into
//      their starts and gives each of its warps a base per segment; a warp
//      walks its slice 32 rows at a time, lanes with the same segment
//      (__match_any_sync) take consecutive places in row order, and the
//      values go to `list`, grouped by segment;
//   D. (grid barrier) fold: one warp a segment loads its rows 128 at a time
//      (the next 128 loading while the current ones fold) and adds them in
//      row order from +0.0 through shuffles, so a lone -0.0 row and an empty
//      segment give +0.0, as the scatter does.  Integer sums, exact in any
//      order, add each 32 rows with one warp-wide add.
// The caller gives scratch for the counts (G x S ints), the totals (S) and
// the grouped values (J x F).
//
// Many segments: a CTA keeps (warps + 1) x S + 1 counts in shared memory,
// which caps S at 25599.  Above the cap, float sums run the same kernel once
// for each window of 10239 segments (4 warps a CTA), each launch counting
// only the ids inside its window, so every sum still folds in row order;
// integer sums, exact in any order, add each row into its segment's sum in
// device memory (segment_add_kernel) after a memset of the output.
//
// Launch state (the SM count, the occupancy, the shared-memory attribute) is
// kept for each device that cudaGetDevice names, so the caller makes the
// tensors' device current before it calls.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 8;                   // warps of a CTA
constexpr int kSmemBudget = 200 * 1024;        // bytes of counts a CTA may keep
constexpr int kBatch = 4;                      // 32-row loads a lane keeps in flight (fold)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Adds v[b][f], the values of the segment's rows 32 b + j (j = lane that
// holds them), b < nb, to acc: floats in row order through shuffles (every
// lane keeps the same sum), integers with one warp-wide add a group.
template <int F>
__device__ __forceinline__ void fold_batch(float (&acc)[F], const float (&v)[kBatch][F], int nb) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    if (b < nb) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += __shfl_sync(kFull, v[b][f], j);
      }
    }
  }
}

template <int F>
__device__ __forceinline__ void fold_batch(int (&acc)[F], const int (&v)[kBatch][F], int nb) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    if (b < nb) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += __reduce_add_sync(kFull, v[b][f]);
    }
  }
}

// Loads the grouped values [i0, i0 + 32 kBatch) of a segment (zeros from
// `end` on; +0.0 leaves a float sum's bits alone, as it is never -0.0);
// returns how many 32-row groups hold rows.
template <typename T, int F>
__device__ __forceinline__ int load_batch(T (&v)[kBatch][F], const T* __restrict__ list,
                                          long long i0, long long end, int lane) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const long long i = i0 + 32 * b + lane;
#pragma unroll
    for (int f = 0; f < F; ++f) v[b][f] = i < end ? list[i * F + f] : T(0);
  }
  const long long left = end - i0;
  return left <= 0 ? 0 : (left >= 32 * kBatch ? kBatch : static_cast<int>((left + 31) / 32));
}

template <typename T, typename IdT, int F>
__global__ void segment_sum_kernel(const T* __restrict__ values, const IdT* __restrict__ ids,
                                   long long n, long long lo, int segments, int* __restrict__ cnt,
                                   int* __restrict__ tot, T* __restrict__ list,
                                   T* __restrict__ out) {
  extern __shared__ int smem[];  // [warps][S] counts, then bases; [S + 1] starts
  cg::grid_group grid = cg::this_grid();
  const int S = segments;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = gridDim.x * warps;
  const int gw = blockIdx.x * warps + warp;           // this warp in row order
  int* wcnt = smem + warp * S;
  int* start = smem + warps * S;
  const long long per_warp = ((n + n_warps - 1) / n_warps + 31) / 32 * 32;
  const long long r_lo = gw * per_warp;
  const long long r_hi = r_lo + per_warp < n ? r_lo + per_warp : n;

  // ---- A. per-warp counts, then this CTA's -------------------------------
  for (int i = threadIdx.x; i < warps * S; i += blockDim.x) smem[i] = 0;
  __syncthreads();
  for (long long r = r_lo + lane; r < r_hi; r += 32) {
    const long long id = static_cast<long long>(ids[r]) - lo;
    if (id >= 0 && id < S) atomicAdd(&wcnt[id], 1);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int c = 0;
    for (int w = 0; w < warps; ++w) c += smem[w * S + s];
    cnt[static_cast<long long>(blockIdx.x) * S + s] = c;
  }
  grid.sync();

  // ---- B. per segment, the exclusive scan of its counts over CTAs --------
  const int ctas = gridDim.x;
  for (int s = gw; s < S; s += n_warps) {
    int carry = 0;
    for (int c0 = 0; c0 < ctas; c0 += 32) {
      const int c = c0 + lane;
      const long long o = static_cast<long long>(c) * S + s;
      const int x = c < ctas ? cnt[o] : 0;
      const int incl = warp_inclusive_scan(x, lane);
      if (c < ctas) cnt[o] = carry + incl - x;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) tot[s] = carry;
  }
  grid.sync();

  // ---- C. segment starts, warp bases, then the scatter in row order ------
  if (warp == 0) {
    int carry = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int x = s0 + lane < S ? tot[s0 + lane] : 0;
      const int incl = warp_inclusive_scan(x, lane);
      if (s0 + lane < S) start[s0 + lane] = carry + incl - x;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) start[S] = carry;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int run = start[s] + cnt[static_cast<long long>(blockIdx.x) * S + s];
    for (int w = 0; w < warps; ++w) {
      const int c = smem[w * S + s];
      smem[w * S + s] = run;
      run += c;
    }
  }
  __syncthreads();
  for (long long r0 = r_lo; r0 < r_hi; r0 += 32) {
    const long long r = r0 + lane;
    const long long id = r < r_hi ? static_cast<long long>(ids[r]) - lo : -1;
    const int s = id >= 0 && id < S ? static_cast<int>(id) : -1;
    const unsigned peers = __match_any_sync(kFull, s);
    int base = 0;
    if (s >= 0) {
      base = wcnt[s];
      const long long p = base + __popc(peers & ((1u << lane) - 1u));
#pragma unroll
      for (int f = 0; f < F; ++f) list[p * F + f] = values[r * F + f];
    }
    __syncwarp();
    if (s >= 0 && 31 - __clz(peers) == lane) wcnt[s] = base + __popc(peers);
    __syncwarp();
  }
  grid.sync();

  // ---- D. one warp a segment folds its rows in order ----------------------
  for (int s = gw; s < S; s += n_warps) {
    T acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = T(0);
    const long long end = start[s + 1];
    long long i0 = start[s];
    T cur[kBatch][F], nxt[kBatch][F];
    int nb = load_batch<T, F>(cur, list, i0, end, lane);
    while (nb > 0) {
      const int nb_next = load_batch<T, F>(nxt, list, i0 + 32 * kBatch, end, lane);
      fold_batch<F>(acc, cur, nb);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
#pragma unroll
        for (int f = 0; f < F; ++f) cur[b][f] = nxt[b][f];
      }
      nb = nb_next;
      i0 += 32 * kBatch;
    }
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (lane == f) out[static_cast<long long>(s) * F + f] = acc[f];
  }
}

// Integer sums over more segments than the counting plan keeps in shared
// memory: integer adds are exact in any order, so each row adds its values
// to its segment's sums in device memory (zeroed before the launch).
template <typename IdT, int F>
__global__ void segment_add_kernel(const int* __restrict__ values, const IdT* __restrict__ ids,
                                   long long n, int segments, int* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += step) {
    const IdT id = ids[r];
    if (id >= 0 && id < segments) {
#pragma unroll
      for (int f = 0; f < F; ++f) atomicAdd(&out[static_cast<long long>(id) * F + f], values[r * F + f]);
    }
  }
}

// A launch's shape.  Up to the shared-memory cap (`window` == segments) one
// launch counts every segment; above it float sums take ceil(segments /
// window) launches, each over the ids of one window of segments, and integer
// sums take segment_add_kernel.
struct Plan {
  int warps, grid, window;  // grid 0: no plan (bad arguments or too many devices)
  size_t smem;
};

constexpr int kWindowWarps = 4;  // warps of a CTA when the segments take windows
constexpr int kMaxDevices = 64;

// Launch state of one kernel instance on one device: the SM count, the
// dynamic shared memory the attribute allows, and the occupancy of the last
// (warps, smem) asked for.
struct DeviceState {
  int sms = 0;
  size_t attr_smem = 0;
  int occ_warps = 0;
  size_t occ_smem = 0;
  int per_sm = 0;
};

std::mutex g_state_mutex;

template <typename T, typename IdT, int F>
Plan plan(long long n, int segments) {
  Plan p{};
  if (segments < 1) return p;
  int warps = (kSmemBudget / 4 - segments - 1) / segments;
  if (warps >= 1) {
    p.window = segments;
    p.warps = warps > kMaxWarps ? kMaxWarps : warps;
  } else {
    p.window = (kSmemBudget / 4 - 1) / (kWindowWarps + 1);
    p.warps = kWindowWarps;
  }
  p.smem = sizeof(int) * (static_cast<size_t>(p.warps + 1) * p.window + 1);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return p;
  static DeviceState states[kMaxDevices];  // one a device, for this instance
  int sms, per_sm;
  {
    std::lock_guard<std::mutex> guard(g_state_mutex);
    DeviceState& st = states[dev];
    if (st.sms == 0) cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, dev);
    if (p.smem > st.attr_smem) {
      if (cudaFuncSetAttribute(segment_sum_kernel<T, IdT, F>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(p.smem)) != cudaSuccess)
        return p;
      st.attr_smem = p.smem;
    }
    if (st.occ_warps != p.warps || st.occ_smem != p.smem) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&st.per_sm, segment_sum_kernel<T, IdT, F>,
                                                    32 * p.warps, p.smem);
      st.occ_warps = p.warps;
      st.occ_smem = p.smem;
    }
    sms = st.sms;
    per_sm = st.per_sm;
  }
  long long grid = (n + 128LL * p.warps - 1) / (128LL * p.warps);  // ~4 rows a lane
  const long long most = static_cast<long long>(sms) * per_sm;
  grid = grid > most ? most : grid;
  p.grid = static_cast<int>(grid < 1 ? 1 : grid);
  return p;
}

template <typename T, typename IdT, int F>
cudaError_t launch(const T* values, const IdT* ids, long long n, int segments, void* scratch,
                   T* out, cudaStream_t st) {
  const Plan p = plan<T, IdT, F>(n, segments);
  if (p.grid == 0) return cudaErrorInvalidValue;
  if (std::is_integral<T>::value && p.window < segments) {  // exact in any order
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(T) * F * static_cast<size_t>(segments), st);
    if (err != cudaSuccess || n == 0) return err;
    long long blocks = (n + 255) / 256;
    const long long most = 32LL * 1024;
    blocks = blocks > most ? most : blocks;
    segment_add_kernel<IdT, F><<<static_cast<int>(blocks), 256, 0, st>>>(
        reinterpret_cast<const int*>(values), ids, n, segments, reinterpret_cast<int*>(out));
    return cudaGetLastError();
  }
  int* cnt = static_cast<int*>(scratch);
  int* tot = cnt + static_cast<size_t>(p.grid) * p.window;
  T* list = reinterpret_cast<T*>(tot + p.window);
  for (long long lo = 0; lo < segments; lo += p.window) {
    int seg = static_cast<int>(segments - lo < p.window ? segments - lo : p.window);
    T* o = out + lo * F;
    void* args[] = {&values, &ids, &n, &lo, &seg, &cnt, &tot, &list, &o};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        segment_sum_kernel<T, IdT, F>, dim3(p.grid), dim3(32 * p.warps), args, p.smem, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, typename IdT, int F>
long long scratch_bytes(long long n, int segments) {
  const Plan p = plan<T, IdT, F>(n, segments);
  if (p.grid == 0) return -1;
  if (std::is_integral<T>::value && p.window < segments) return 0;
  return 4LL * (static_cast<long long>(p.grid) + 1) * p.window +
         static_cast<long long>(sizeof(T)) * n * F;
}

template <typename T, typename IdT>
int dispatch(const T* values, int features, const IdT* ids, long long n, int segments,
             void* scratch, T* out, void* stream) {
  if (features < 1 || features > 4 || n < 0 || segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (segments == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (features) {
    case 1: err = launch<T, IdT, 1>(values, ids, n, segments, scratch, out, st); break;
    case 2: err = launch<T, IdT, 2>(values, ids, n, segments, scratch, out, st); break;
    case 3: err = launch<T, IdT, 3>(values, ids, n, segments, scratch, out, st); break;
    default: err = launch<T, IdT, 4>(values, ids, n, segments, scratch, out, st); break;
  }
  return static_cast<int>(err);
}

template <typename T, typename IdT>
long long dispatch_scratch(int features, long long n, int segments) {
  switch (features) {
    case 1: return scratch_bytes<T, IdT, 1>(n, segments);
    case 2: return scratch_bytes<T, IdT, 2>(n, segments);
    case 3: return scratch_bytes<T, IdT, 3>(n, segments);
    case 4: return scratch_bytes<T, IdT, 4>(n, segments);
    default: return -1;
  }
}

}  // namespace

// NAME: `segments` sums of `features` columns of `values` ([n, features],
// row-major) by the ids `ids` ([n], int32 or int64), launched on `stream`,
// with `scratch` of NAME_scratch's bytes (-1: no plan for the current
// device).
#define SEGMENT_SUM_ENTRY(NAME, T, IdT)                                                   \
  extern "C" int NAME(const T* values, int features, const IdT* ids, long long n,         \
                      int segments, void* scratch, T* out, void* stream) {                \
    return dispatch<T, IdT>(values, features, ids, n, segments, scratch, out, stream);    \
  }                                                                                       \
  extern "C" long long NAME##_scratch(int features, long long n, int segments) {          \
    return dispatch_scratch<T, IdT>(features, n, segments);                               \
  }

SEGMENT_SUM_ENTRY(segment_sum_f32_i32, float, int)
SEGMENT_SUM_ENTRY(segment_sum_f32_i64, float, long long)
SEGMENT_SUM_ENTRY(segment_sum_i32_i32, int, int)
SEGMENT_SUM_ENTRY(segment_sum_i32_i64, int, long long)
