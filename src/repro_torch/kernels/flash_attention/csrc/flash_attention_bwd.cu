// Causal / sliding-window GQA flash attention, backward, on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains through XLA's autodiff of
// its plain chunked attention (src/repro/kernels/flash_attention/ops.py:34,
// reached from models/attention.py's attention_train, attention_bidir and
// cross_attention).  The port's forward on the card is the hand-written
// flash kernel (flash_attention.cu), so its gradient is one too; the plain
// version is ref.attention_bwd_ref.  Semantics are the forward's: q
// [B,Hq,S,D] against k/v [B,Hkv,Skv,D], KV head h / (Hq/Hkv), q rows
// right-aligned to the end of the KV (row position i + Skv - S), a key col
// kept when col < Skv, col <= row (causal) and col > row - window
// (window > 0).  With O the forward's output, LSE its log-sum-exp and dO the
// output's gradient:
//   P = exp(scale Q K^T - LSE) over the kept keys,  dV = P^T dO,
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// each in f32 and returned in the inputs' dtype (bf16 or f32).
//
// The LSE is the forward kernel's (every forward route writes it when asked,
// f32 [B,Hq,S], natural log, +inf for a row that keeps no key, so that P is
// 0 there and the row's gradient is zero); nothing here recomputes a row's
// max or sum.
//
// Bound: the useful work is 2.5x the forward's (Q K^T and P V, 4 D FLOP a
// kept pair; the backward adds dO V^T, P^T dO, dS^T Q and dS K), so at
// granite-moe's training shape [4, 16, 4096, 64] causal it is 3.4e11 FLOP
// against 0.2 GB of inputs and gradients: bound by operations, 0.35 ms.
//
// Three kernels a call; none uses atomics, so a gradient has the same bits
// on every run.
//   1. preprocess (a warp a row): delta = rowsum(dO * O); on the wgmma route
//      it also copies the LSE, both into rows padded to a multiple of 64
//      (LSE +inf, delta 0 past S), so that a tile's 64 values are one
//      256-byte-aligned TMA box (a box whose start is not 16-byte aligned
//      faults).
//   2. dK/dV (one CTA a key tile and KV head): K and V stay in shared
//      memory; the CTA walks the G query heads of its group and their q
//      tiles that can see the key tile (tiles wholly before the key tile
//      under causality, or past the window, are skipped), recomputing P and
//      dS, and accumulates dK and dV in registers.  Because the CTA owns its
//      KV head's rows, GQA needs no atomics.
//   3. dQ (one CTA a q tile and head, the heaviest causal tiles first):
//      Q and dO stay in shared memory; it walks the key tiles that the
//      forward visits and accumulates dQ in registers.
// Three routes take these three steps:
//   - bf16 at D = 64, 128 and 256 (every family's training attention): TMA,
//     mbarrier rings and wgmma, warp-specialised like the forward's
//     flash_fwd_kernel_wgmma (see "Hopper" below);
//   - bf16 at D = 16, 32 and 96: mma.sync on the tensor cores (the `_mma`
//     kernels);
//   - f32 at every D, and bf16 at D = 192: every product in f32 on the CUDA
//     cores (bf16 widened when staged), whose ceiling is the card's 67
//     TFLOP/s of f32 FMA.  Tiles are 64 rows (32 for D > 128, so the four
//     staged [rows][D] tiles fit in shared memory); 256 threads, thread
//     (rg, cg) owning tile rows rg + 16 i and product columns cg + 16 j, or
//     output columns cg + 16 j of D, so a row's 16 threads are one
//     half-warp and every staged row is read 16 bytes a thread with rows
//     padded by 4 floats (conflict-free).
// The tensor-core routes round P and dS to bf16 once, for the products that
// take them (dV = P^T dO, dK = dS^T Q, dQ = dS K); dS itself is formed from
// the f32 P and dP.  The error this leaves is within 2^-6 of each row's
// largest gradient (chip_smoke.py phase 21(b)), at about the bf16 rounding of
// the gradients themselves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
struct Tile {
  static constexpr int kRows = D <= 128 ? 64 : 32;  // rows of a q tile or a key tile
  static constexpr int kR = kRows / 16;             // tile rows (and product columns) a thread
  static constexpr int kLd = D + 4;                 // padded row of a staged [rows][D] tile
  static constexpr int kLdP = kRows + 4;            // padded row of a [rows][rows] tile
  static constexpr int kCols = D / 16;              // output columns a thread
  static constexpr int kStaged = kRows * kLd;
  static constexpr size_t kKvBytes = sizeof(float) * (4 * kStaged + 2 * kRows * kLdP + 2 * kRows);
  static constexpr size_t kQBytes = sizeof(float) * (4 * kStaged + kRows * kLdP + 2 * kRows);
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // contiguous [B, Hq, S, D]
  const void* dout;  // contiguous [B, Hq, S, D]
  void* dq;          // contiguous [B, Hq, S, D]
  void* dk;          // contiguous [B, Hkv, Skv, D]
  void* dv;          // contiguous [B, Hkv, Skv, D]
  const float* lse;  // [B, Hq, S]: each row's log-sum-exp, from the forward
  float* delta;      // [B, Hq, s_pad]: rowsum(dO * O)
  float* lse_pad;    // [B, Hq, s_pad]: lse, +inf past S (the wgmma route only)
  int hq, hkv, group, s_len, skv, d, s_pad;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale;
  int causal, window;
};

__device__ __forceinline__ bool kept(int row, int col, int skv, int causal, int window) {
  return col < skv && (!causal || col <= row) && (window <= 0 || col > row - window);
}

// rows [row0, row0 + valid) of a [*, D] matrix with row stride `ss` into
// dst[r][kLd] as f32; the tile's rows past `valid` are zero
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss, int row0,
                                      int valid) {
  constexpr int kRows = Tile<D>::kRows, kLd = Tile<D>::kLd;
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * kLd + d] = r < valid ? to_f32(src[(row0 + r) * ss + d]) : 0.f;
  }
}

// acc[i][j] += a[rg + 16 i] . b[cg + 16 j] over D, both staged [rows][kLd]
template <int D>
__device__ __forceinline__ void dot_rows(float (&acc)[Tile<D>::kR][Tile<D>::kR],
                                         const float* a, const float* b, int rg, int cg) {
  constexpr int kR = Tile<D>::kR, kLd = Tile<D>::kLd;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[kR], bv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (rg + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < kR; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (cg + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        acc[i][j] = fmaf(av[i].w, bv[j].w, s);
      }
  }
}

// out[i][j] += sum over r of p[rg + 16 i][r] * m[r][cg + 16 j]: p a
// [rows][kLdP] tile, m a staged [rows][kLd] one
template <int D>
__device__ __forceinline__ void acc_rows(float (&out)[Tile<D>::kR][Tile<D>::kCols],
                                         const float* p, const float* m, int rg, int cg) {
  constexpr int kRows = Tile<D>::kRows, kR = Tile<D>::kR, kLd = Tile<D>::kLd;
  constexpr int kLdP = Tile<D>::kLdP, kCols = Tile<D>::kCols;
#pragma unroll 2
  for (int r = 0; r < kRows; r += 4) {
    float4 pv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (rg + 16 * i) * kLdP + r);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float* mc = m + r * kLd + cg + 16 * j;
      const float m0 = mc[0], m1 = mc[kLd], m2 = mc[2 * kLd], m3 = mc[3 * kLd];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        float s = out[i][j];
        s = fmaf(pv[i].x, m0, s);
        s = fmaf(pv[i].y, m1, s);
        s = fmaf(pv[i].z, m2, s);
        out[i][j] = fmaf(pv[i].w, m3, s);
      }
    }
  }
}

// ------------------------------------------------------------ preprocess ---

// delta = rowsum(dO * O), a warp a row, for every route (o and dout are
// contiguous [B, Hq, S, D]), into rows of s_pad; with lse_pad (the wgmma
// route), also the forward's log-sum-exp into rows of s_pad, +inf (and
// delta 0) past S, so that a tile's 64 values are one aligned TMA box.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ delta,
                            float* __restrict__ lse_pad, long long n_rows, int s_len, int s_pad,
                            int d) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // n_rows counts rows of s_pad
  const long long bh = row / s_pad;
  const int i = static_cast<int>(row - bh * s_pad);
  if (i >= s_len) {
    if (lane == 0) {
      delta[row] = 0.f;
      lse_pad[row] = INFINITY;
    }
    return;
  }
  const long long src = bh * s_len + i;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(to_f32(dout[src * d + c]), to_f32(o[src * d + c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    delta[row] = s;
    if (lse_pad != nullptr) lse_pad[row] = lse[src];
  }
}

template <typename T>
cudaError_t launch_preprocess(const Params& p, int batch, cudaStream_t stream) {
  const long long n_rows = static_cast<long long>(batch) * p.hq * p.s_pad;
  const long long blocks = (n_rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_bwd_preprocess_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(p.o), static_cast<const T*>(p.dout), p.lse, p.delta, p.lse_pad,
      n_rows, p.s_len, p.s_pad, p.d);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- dK, dV ---

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Params p) {
  constexpr int kRows = Tile<D>::kRows, kR = Tile<D>::kR, kLdP = Tile<D>::kLdP;
  constexpr int kCols = Tile<D>::kCols;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + Tile<D>::kStaged;
  float* qs = vs + Tile<D>::kStaged;
  float* gs = qs + Tile<D>::kStaged;      // dO
  float* pt = gs + Tile<D>::kStaged;      // P^T [key][row]
  float* dst = pt + kRows * kLdP;         // dS^T [key][row]
  float* row_lse = dst + kRows * kLdP;
  float* row_delta = row_lse + kRows;

  const int ik = blockIdx.x;  // key tile 0 sees the most causal rows: heaviest first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int k0 = ik * kRows;
  const int kcount = min(kRows, p.skv - k0);
  const int off = p.skv - p.s_len;  // row position = q index + off

  stage<T, D>(ks, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, kcount);
  stage<T, D>(vs, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, kcount);

  float dk[kR][kCols], dv[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk[i][j] = dv[i][j] = 0.f;

  // q tiles with a row that keeps a key of this tile
  const int nq = (p.s_len + kRows - 1) / kRows;
  const int iq_begin = p.causal ? max(0, k0 - off) / kRows : 0;
  int iq_end = nq;
  if (p.window > 0) {
    const int last = k0 + kcount - 2 + p.window - off;  // the last q index in the window
    iq_end = last >= 0 ? min(nq, last / kRows + 1) : 0;
  }

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = hk * p.group + hh;
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const long long head_rows = (static_cast<long long>(b) * p.hq + h) * p.s_len;
    const T* gb = static_cast<const T*>(p.dout) + head_rows * D;
    for (int iq = iq_begin; iq < iq_end; ++iq) {
      const int q0 = iq * kRows;
      const int rows = min(kRows, p.s_len - q0);
      __syncthreads();  // the previous step is done with qs, gs, pt, dst and the row values
      stage<T, D>(qs, qb, p.q_ss, q0, rows);
      stage<T, D>(gs, gb, D, q0, rows);
      if (tid < kRows) {
        const bool ok = tid < rows;
        row_lse[tid] = ok ? p.lse[head_rows + q0 + tid] : 0.f;
        row_delta[tid] = ok ? p.delta[head_rows + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[kR][kR], dp[kR][kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) s[i][j] = dp[i][j] = 0.f;
      dot_rows<D>(s, ks, qs, rg, cg);   // s[i][j] = K[c_i] . Q[r_j]
      dot_rows<D>(dp, vs, gs, rg, cg);  // dp[i][j] = V[c_i] . dO[r_j]
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int c = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int r = cg + 16 * j;
          const bool live = r < rows && kept(q0 + r + off, k0 + c, p.skv, p.causal, p.window);
          const float pv = live ? expf(s[i][j] * p.scale - row_lse[r]) : 0.f;
          pt[c * kLdP + r] = pv;
          dst[c * kLdP + r] = pv * (dp[i][j] - row_delta[r]);
        }
      }
      __syncthreads();
      acc_rows<D>(dv, pt, gs, rg, cg);   // dV[c] += sum_r P[r][c] dO[r]
      acc_rows<D>(dk, dst, qs, rg, cg);  // dK[c] += sum_r dS[r][c] Q[r]
    }
  }

  const long long out_rows = (static_cast<long long>(b) * p.hkv + hk) * p.skv + k0;
  T* dkb = static_cast<T*>(p.dk) + out_rows * D;
  T* dvb = static_cast<T*>(p.dv) + out_rows * D;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int c = rg + 16 * i;
    if (c >= kcount) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      store(dkb + c * D + cg + 16 * j, dk[i][j] * p.scale);
      store(dvb + c * D + cg + 16 * j, dv[i][j]);
    }
  }
}

// --------------------------------------------------------------------- dQ ---

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int kRows = Tile<D>::kRows, kR = Tile<D>::kR, kLdP = Tile<D>::kLdP;
  constexpr int kCols = Tile<D>::kCols;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* gs = qs + Tile<D>::kStaged;      // dO
  float* ks = gs + Tile<D>::kStaged;
  float* vs = ks + Tile<D>::kStaged;
  float* ds = vs + Tile<D>::kStaged;      // dS [row][key]
  float* row_lse = ds + kRows * kLdP;
  float* row_delta = row_lse + kRows;

  const int nq = (p.s_len + kRows - 1) / kRows;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = iq * kRows;
  const int rows = min(kRows, p.s_len - q0);
  const int q_lo = q0 + (p.skv - p.s_len);
  const int q_hi = q_lo + rows - 1;
  const long long row_base = (static_cast<long long>(b) * p.hq + h) * p.s_len + q0;

  stage<T, D>(qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, q0, rows);
  stage<T, D>(gs, static_cast<const T*>(p.dout) + (row_base - q0) * D, D, q0, rows);
  if (tid < kRows) {
    const bool ok = tid < rows;
    row_lse[tid] = ok ? p.lse[row_base + tid] : 0.f;
    row_delta[tid] = ok ? p.delta[row_base + tid] : 0.f;
  }
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + (h / p.group) * p.v_sh;

  float dq[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dq[i][j] = 0.f;

  int kt_end = (p.skv + kRows - 1) / kRows;
  if (p.causal) kt_end = q_hi >= 0 ? min(kt_end, q_hi / kRows + 1) : 0;
  const int kt_begin = p.window > 0 ? max(0, q_lo - p.window + 1) / kRows : 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kRows;
    const int kcount = min(kRows, p.skv - k0);
    __syncthreads();  // the previous tile is done with ks, vs and ds
    stage<T, D>(ks, kb, p.k_ss, k0, kcount);
    stage<T, D>(vs, vb, p.v_ss, k0, kcount);
    __syncthreads();
    float s[kR][kR], dp[kR][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_rows<D>(s, qs, ks, rg, cg);   // s[i][j] = Q[r_i] . K[c_j]
    dot_rows<D>(dp, gs, vs, rg, cg);  // dp[i][j] = dO[r_i] . V[c_j]
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int c = cg + 16 * j;
        const bool live = r < rows && kept(q_lo + r, k0 + c, p.skv, p.causal, p.window);
        const float pv = live ? expf(s[i][j] * p.scale - row_lse[r]) : 0.f;
        ds[r * kLdP + c] = pv * (dp[i][j] - row_delta[r]);
      }
    }
    __syncthreads();
    acc_rows<D>(dq, ds, ks, rg, cg);  // dQ[r] += sum_c dS[r][c] K[c]
  }

  T* dqb = static_cast<T*>(p.dq) + row_base * D;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = rg + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(dqb + r * D + cg + 16 * j, dq[i][j] * p.scale);
  }
}

template <typename T, int D>
cudaError_t launch_typed(const Params& p, int batch, cudaStream_t stream) {
  using TL = Tile<D>;
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dq = flash_bwd_dq_kernel<T, D>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(TL::kKvBytes))) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(TL::kQBytes))) != cudaSuccess) return err;
  const int nq = (p.s_len + TL::kRows - 1) / TL::kRows;
  const int nk = (p.skv + TL::kRows - 1) / TL::kRows;
  if ((err = launch_preprocess<T>(p, batch, stream)) != cudaSuccess) return err;
  dkdv<<<dim3(nk, p.hkv, batch), kThreads, TL::kKvBytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq<<<dim3(nq, p.hq, batch), kThreads, TL::kQBytes, stream>>>(p);
  return cudaGetLastError();
}

// f32 at every D; bf16 only where no tensor-core route reaches (D = 192),
// so no other bf16 instantiation is compiled
template <typename T>
cudaError_t launch_head_dim(int d, const Params& p, int batch, cudaStream_t stream) {
  if constexpr (sizeof(T) == sizeof(float)) {
    switch (d) {
      case 16: return launch_typed<T, 16>(p, batch, stream);
      case 32: return launch_typed<T, 32>(p, batch, stream);
      case 64: return launch_typed<T, 64>(p, batch, stream);
      case 96: return launch_typed<T, 96>(p, batch, stream);
      case 128: return launch_typed<T, 128>(p, batch, stream);
      case 256: return launch_typed<T, 256>(p, batch, stream);
      default: break;
    }
  }
  switch (d) {
    case 192: return launch_typed<T, 192>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------ tensor cores (bf16) ---
//
// bfloat16 at D = 16, 32 or 96 runs the same three steps with every product
// on the tensor cores: mma.sync m16n8k16 (bf16 in, f32 accumulate), 128
// threads a CTA, 4 warps of 16 rows (or keys) against tiles of 64, each
// staged with 16-byte loads into rows padded by 8 bf16.  A product's A
// operand comes from shared memory (Q, dO, K, V) or straight from the
// previous product's f32 accumulators (P and dS, rounded to bf16), and its B
// operand from shared memory, through ldmatrix.trans where it is row-major
// in the reduced index (dO and Q for dV and dK, K for dQ).  The LSE and
// rowsum(dO * O) are read as the CUDA-core route reads them.

constexpr int kMmaRows = 64;
constexpr int kMmaThreads = 128;

template <int D>
struct MmaTile {
  static constexpr int kLd = D + 8;  // a staged bf16 row: 16-byte aligned, conflict-free fragments
  static constexpr int kTile = kMmaRows * kLd;
  static constexpr size_t kBytes = sizeof(__nv_bfloat16) * 4 * kTile + sizeof(float) * 2 * kMmaRows;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// rows [row0, row0 + valid) of a [*, D] bf16 matrix into a [64][D + 8] tile,
// 16 bytes a thread a step; rows past `valid` are zero
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride, int row0, int valid) {
  constexpr int kChunks = D / 8, kLd = MmaTile<D>::kLd;
  for (int c = threadIdx.x; c < kMmaRows * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + ch * 8);
    *reinterpret_cast<uint4*>(dst + r * kLd + ch * 8) = val;
  }
}

// acc[nt] += A(rows a_row0 .. + 15 of `a`) . B(rows nt * 8 .. + 7 of `b`)^T
// over D: 8 n-tiles of 8 columns, both operands staged [64][D + 8]
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int a_row0, int g, int t) {
  constexpr int kLd = MmaTile<D>::kLd;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* ar = a + (a_row0 + g) * kLd + kk * 16 + 2 * t;
    const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * kLd), ld32(ar + 8), ld32(ar + 8 * kLd + 8)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* br = b + (nt * 8 + g) * kLd + kk * 16 + 2 * t;
      mma_bf16(acc[nt], af, ld32(br), ld32(br + 8));
    }
  }
}

// out[j] (a [16][D] block, 8 columns a j) += A . M: A the [16][64] block
// held as the f32 accumulators `src` (rounded to bf16), M a staged [64][D]
// tile read through ldmatrix.trans
template <int D>
__device__ __forceinline__ void mma_acc(float (&out)[D / 8][4], const float (&src)[8][4],
                                        const __nv_bfloat16* m, int lane) {
  constexpr int kLd = MmaTile<D>::kLd;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: this lane's row of matrix `mat`
#pragma unroll
  for (int kk = 0; kk < kMmaRows / 16; ++kk) {
    const uint32_t af[4] = {pack_bf16x2(src[2 * kk][0], src[2 * kk][1]),
                            pack_bf16x2(src[2 * kk][2], src[2 * kk][3]),
                            pack_bf16x2(src[2 * kk + 1][0], src[2 * kk + 1][1]),
                            pack_bf16x2(src[2 * kk + 1][2], src[2 * kk + 1][3])};
    const __nv_bfloat16* mr = m + (kk * 16 + mrow + (mat & 1) * 8) * kLd + (mat >> 1) * 8;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, mr + dp * 16);
      mma_bf16(out[2 * dp], af, bv[0], bv[1]);
      mma_bf16(out[2 * dp + 1], af, bv[2], bv[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkdv_kernel_mma(Params p) {
  constexpr int kLd = MmaTile<D>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + MmaTile<D>::kTile;
  __nv_bfloat16* qs = vs + MmaTile<D>::kTile;
  __nv_bfloat16* gs = qs + MmaTile<D>::kTile;  // dO
  float* row_lse = reinterpret_cast<float*>(gs + MmaTile<D>::kTile);
  float* row_delta = row_lse + kMmaRows;

  const int ik = blockIdx.x;  // key tile 0 sees the most causal rows: heaviest first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = ik * kMmaRows;
  const int kcount = min(kMmaRows, p.skv - k0);
  const int off = p.skv - p.s_len;
  const int c0 = warp * 16 + g;  // this thread's keys c0 and c0 + 8 of the tile

  stage_bf16<D>(ks, static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss,
                k0, kcount);
  stage_bf16<D>(vs, static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss,
                k0, kcount);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int nq = (p.s_len + kMmaRows - 1) / kMmaRows;
  const int iq_begin = p.causal ? max(0, k0 - off) / kMmaRows : 0;
  int iq_end = nq;
  if (p.window > 0) {
    const int last = k0 + kcount - 2 + p.window - off;  // the last q index in the window
    iq_end = last >= 0 ? min(nq, last / kMmaRows + 1) : 0;
  }

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = hk * p.group + hh;
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const long long head_rows = (static_cast<long long>(b) * p.hq + h) * p.s_len;
    const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(p.dout) + head_rows * D;
    for (int iq = iq_begin; iq < iq_end; ++iq) {
      const int q0 = iq * kMmaRows;
      const int rows = min(kMmaRows, p.s_len - q0);
      __syncthreads();  // the previous step is done with qs, gs and the row values
      stage_bf16<D>(qs, qb, p.q_ss, q0, rows);
      stage_bf16<D>(gs, gb, D, q0, rows);
      if (tid < kMmaRows) {
        const bool ok = tid < rows;
        row_lse[tid] = ok ? p.lse[head_rows + q0 + tid] : 0.f;
        row_delta[tid] = ok ? p.delta[head_rows + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[8][4], dp[8][4];  // [key][row]: keys c0 (e = 0, 1), c0 + 8 (e = 2, 3)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      mma_rows<D>(s, ks, qs, warp * 16, g, t);   // K Q^T
      mma_rows<D>(dp, vs, gs, warp * 16, g, t);  // V dO^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = nt * 8 + 2 * t + (e & 1);
          const bool live = r < rows && kept(q0 + r + off, k0 + c0 + 8 * (e >> 1), p.skv,
                                             p.causal, p.window);
          const float pv = live ? expf(s[nt][e] * p.scale - row_lse[r]) : 0.f;
          s[nt][e] = pv;
          dp[nt][e] = pv * (dp[nt][e] - row_delta[r]);
        }
      mma_acc<D>(dv, s, gs, lane);   // dV += P^T dO
      mma_acc<D>(dk, dp, qs, lane);  // dK += dS^T Q
    }
  }

  const long long out_rows = (static_cast<long long>(b) * p.hkv + hk) * p.skv + k0;
  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(p.dk) + out_rows * D;
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(p.dv) + out_rows * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c0 + 8 * i;
    if (c >= kcount) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + c * D + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dk[j][2 * i] * p.scale, dk[j][2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + c * D + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_kernel_mma(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = qs + MmaTile<D>::kTile;  // dO
  __nv_bfloat16* ks = gs + MmaTile<D>::kTile;
  __nv_bfloat16* vs = ks + MmaTile<D>::kTile;

  const int nq = (p.s_len + kMmaRows - 1) / kMmaRows;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = iq * kMmaRows;
  const int rows = min(kMmaRows, p.s_len - q0);
  const int q_lo = q0 + (p.skv - p.s_len);
  const int q_hi = q_lo + rows - 1;
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the tile
  const long long row_base = (static_cast<long long>(b) * p.hq + h) * p.s_len + q0;

  stage_bf16<D>(qs, static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
                q0, rows);
  stage_bf16<D>(gs, static_cast<const __nv_bfloat16*>(p.dout) + (row_base - q0) * D, D, q0,
                rows);
  float rlse[2], rdelta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = r0 + 8 * i < rows;
    rlse[i] = ok ? p.lse[row_base + r0 + 8 * i] : 0.f;
    rdelta[i] = ok ? p.delta[row_base + r0 + 8 * i] : 0.f;
  }
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb +
                            (h / p.group) * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb +
                            (h / p.group) * p.v_sh;

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  int kt_end = (p.skv + kMmaRows - 1) / kMmaRows;
  if (p.causal) kt_end = q_hi >= 0 ? min(kt_end, q_hi / kMmaRows + 1) : 0;
  const int kt_begin = p.window > 0 ? max(0, q_lo - p.window + 1) / kMmaRows : 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kMmaRows;
    const int kcount = min(kMmaRows, p.skv - k0);
    __syncthreads();  // the previous tile's readers are done with ks and vs
    stage_bf16<D>(ks, kb, p.k_ss, k0, kcount);
    stage_bf16<D>(vs, vb, p.v_ss, k0, kcount);
    __syncthreads();
    float s[8][4], dp[8][4];  // [row][key]: rows r0 (e = 0, 1), r0 + 8 (e = 2, 3)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    mma_rows<D>(s, qs, ks, warp * 16, g, t);   // Q K^T
    mma_rows<D>(dp, gs, vs, warp * 16, g, t);  // dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool live = r0 + 8 * i < rows &&
                          kept(q_lo + r0 + 8 * i, k0 + nt * 8 + 2 * t + (e & 1), p.skv,
                               p.causal, p.window);
        const float pv = live ? expf(s[nt][e] * p.scale - rlse[i]) : 0.f;
        dp[nt][e] = pv * (dp[nt][e] - rdelta[i]);
      }
    mma_acc<D>(dq, dp, ks, lane);  // dQ += dS K
  }

  __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(p.dq) + row_base * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqb + r * D + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dq[j][2 * i] * p.scale, dq[j][2 * i + 1] * p.scale);
  }
}

template <int D>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t stream) {
  using TL = MmaTile<D>;
  auto dkdv = flash_bwd_dkdv_kernel_mma<D>;
  auto dq = flash_bwd_dq_kernel_mma<D>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(TL::kBytes))) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(TL::kBytes))) != cudaSuccess) return err;
  const int nq = (p.s_len + kMmaRows - 1) / kMmaRows;
  const int nk = (p.skv + kMmaRows - 1) / kMmaRows;
  if ((err = launch_preprocess<__nv_bfloat16>(p, batch, stream)) != cudaSuccess) return err;
  dkdv<<<dim3(nk, p.hkv, batch), kMmaThreads, TL::kBytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq<<<dim3(nq, p.hq, batch), kMmaThreads, TL::kBytes, stream>>>(p);
  return cudaGetLastError();
}

bool uses_mma(int dtype, int d) { return dtype == 1 && (d == 16 || d == 32 || d == 96); }

cudaError_t launch_mma_head_dim(int d, const Params& p, int batch, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_mma<16>(p, batch, stream);
    case 32: return launch_mma<32>(p, batch, stream);
    case 96: return launch_mma<96>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------ Hopper (bf16, wgmma) ---
//
// bfloat16 at D = 64, 128 and 256: the dK/dV and dQ steps as
// warp-specialised kernels on the recipe of the forward's
// flash_fwd_kernel_wgmma.  384 threads a CTA: warpgroup 0 is the producer,
// one thread of which keeps TMA loads in flight into mbarrier-guarded rings
// (4-D tensor maps over the tensors' own strides, 64-row boxes in the
// 128-byte swizzle, so projection views need no copy; 1-D maps for the
// padded LSE and delta); warpgroups 1 and 2 are consumers, with setmaxnreg
// moving registers from the producer (24) to them (240).  Every product is
// wgmma: S = Q K^T and dP = dO V^T (or their transposes) with both operands
// in shared memory, and the accumulating products with P or dS from
// registers (the accumulator of 16 columns is one k-step's A fragment) and
// the other operand in shared memory in the transpose-B form.
//   dK/dV at D = 64 and 128 (flash_bwd_dkdv_kernel_wgmma): 128 keys a CTA,
//   64 a consumer warpgroup, which holds dK and dV (2 x D/2 registers), S^T
//   and dP^T (32 each) and works alone: S^T = K Q^T and dP^T = V dO^T, P^T
//   and dS^T on the CUDA cores, dV += P^T dO issued before dS^T is formed,
//   then dK += dS^T Q.  The ring holds 4 stages of 64-row Q and dO tiles
//   with their 64 LSE and delta values; 99 KB at D = 64, 195 KB at 128.
//   dK/dV at D = 256 (flash_bwd_dkdv_kernel_wgmma_split): dK and dV for 64
//   keys would be 256 registers a thread, so the CTA owns 64 keys and splits
//   them between the warpgroups: warpgroup 1 holds dV and computes S^T and
//   P^T, which it hands to warpgroup 2 through shared memory (f32, two
//   buffers, named barriers 1-4); warpgroup 2 holds dK and computes dP^T and
//   dS^T.  Each holds 128 + 32 + 16 registers of data; 226 KB of shared
//   memory (K and V 64 KB, two stages of Q and dO 128 KB, the hand-over
//   32 KB).  Only 64 keys a KV head make a CTA, so recurrentgemma's one KV
//   head fills 64 of the 132 SMs.
//   dQ (flash_bwd_dq_kernel_wgmma): 128 q rows a CTA, 64 a consumer, against
//   K and V tiles of 128 keys at D = 64 and 64 otherwise (the registers:
//   S, dP, dS and D/2 of dQ); at D = 256 V has one stage so that the CTA
//   fits (225 KB).
//   Tiles wholly inside the mask skip it, as in the forward.  Key tile 0
//   (dK/dV) and the last q tile (dQ) are the heaviest under causality and
//   start first.

constexpr int kWgThreads = 384;     // producer warpgroup + two consumer warpgroups
constexpr int kWgRows = 64;         // rows of every tile: q rows, keys
constexpr int kBlock = kWgRows * 128;  // one 64-column block of a tile (a TMA box), 8 KB
constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU instruction (relative error ~2^-22; 2^-inf is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The dK/dV step's shared memory.  A tile of R rows is D/64 column blocks
// of R rows x 128 bytes in the 128-byte swizzle (R * 128 bytes apart).  A
// step takes 64 q rows.  At D = 64 and 128 a CTA owns 128 keys (a warpgroup
// 64 of them); at D = 256, 64 keys shared by the two warpgroups, which hand
// P^T over through shared memory (kXch).
template <int D>
struct DkdvSmem {
  static constexpr bool kSplit = D == 256;
  static constexpr int kBK = kSplit ? 64 : 128;      // keys a CTA
  static constexpr int kStages = kSplit ? 2 : 4;     // ring depth (what fits)
  static constexpr int kKvBlock = kBK * 128;         // one column block of the K or V tile
  static constexpr int kKvTile = (D / 64) * kKvBlock;
  static constexpr int kQTile = (D / 64) * kBlock;   // a 64-row Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKvTile;
  static constexpr int kQ = kV + kKvTile;                    // ring of Q tiles
  static constexpr int kDo = kQ + kStages * kQTile;          // ring of dO tiles
  static constexpr int kLse = kDo + kStages * kQTile;        // ring of 64 LSE values
  static constexpr int kDelta = kLse + kStages * 256;        // ring of 64 delta values
  static constexpr int kXch = kDelta + kStages * 256;        // P^T, f32, two 64 x 64 buffers
  static constexpr int kBar = kXch + (kSplit ? 2 * 64 * 64 * 4 : 0);
  static constexpr int kBars = 1 + 2 * kStages;              // kv_full, full[], empty[]
  static constexpr size_t kBytes = kBar + 8 * kBars + 1024;  // + room to align the base
};

// The dQ step's: Q and dO as two 64-row tiles each (one a consumer), rings
// of kBK-key K and V tiles (128 keys at D = 64, where the registers allow
// it, else 64); at D = 256 V has one stage, so that the CTA fits.
template <int D>
struct DqSmem {
  static constexpr int kBK = D == 64 ? 128 : 64;
  static constexpr int kTile = (D / 64) * kBlock;
  static constexpr int kKvBlock = kBK * 128;          // one column block of a K or V tile
  static constexpr int kKvTile = (D / 64) * kKvBlock;
  static constexpr int kKStages = 2;
  static constexpr int kVStages = D == 256 ? 1 : 2;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + 2 * kTile;
  static constexpr int kK = kDo + 2 * kTile;
  static constexpr int kV = kK + kKStages * kKvTile;
  static constexpr int kBar = kV + kVStages * kKvTile;
  static constexpr int kBars = 1 + 2 * kKStages + 2 * kVStages;  // q_full, k_full/empty, v_full/empty
  static constexpr size_t kBytes = kBar + 8 * kBars + 1024;
};

__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// acc[64 x N] = A B^T over D: A 64 rows of a tile whose 64-column blocks
// are `a_block` bytes apart, B an N-row tile (N = 64 or 128), both K-major in
// shared memory; a k-step is 32 bytes into a 128-byte swizzled row, each
// further 64 columns of D one column block on.
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a_addr, uint32_t b_addr,
                                         uint32_t a_block = kBlock) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = hopper::make_desc(a_addr + (kk / 4) * a_block + off, 16, 1024);
    const uint64_t db = hopper::make_desc(b_addr + (kk / 4) * (N * 128) + off, 16, 1024);
    if constexpr (N == 64) {
      hopper::wgmma_m64n64k16_ss(acc, da, db, kk > 0);
    } else {
      hopper::wgmma_m64n128k16_ss(acc, da, db, kk > 0);
    }
  }
}

// acc[64 x D] += A B: A a 64 x 16K f32 accumulator as bf16 fragments (the
// accumulator of columns 16kk..16kk+15 is k-step kk's A fragment), B a
// 16K-row tile in shared memory read MN-major (the transpose-B form), its
// 64-column blocks `block` bytes apart.
template <int D, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&a)[K][4],
                                         uint32_t b_addr, uint32_t block) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const uint32_t addr = b_addr + kk * 16 * 128;
    if constexpr (D == 64) {
      hopper::wgmma_m64n64k16_rs(acc, a[kk], hopper::make_desc(addr, block, 1024));
    } else if constexpr (D == 128) {
      hopper::wgmma_m64n128k16_rs(acc, a[kk], hopper::make_desc(addr, block, 1024));
    } else {
      static_assert(D == 256, "the wgmma backward takes D = 64, 128 or 256");
      hopper::wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[64]>(&acc[0]), a[kk],
                                  hopper::make_desc(addr, block, 1024));
      hopper::wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[64]>(&acc[64]), a[kk],
                                  hopper::make_desc(addr + 2 * block, block, 1024));
    }
  }
}

// A 64 x 16K f32 accumulator rounded once to bf16, as A fragments.
template <int K>
__device__ __forceinline__ void to_frags(const float (&x)[8 * K], uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) hopper::fence_regs(a[kk]);
}

// Loads an R-row tile (rows row0.., head h, batch b) of `map` (64-row
// boxes) as D/64 column blocks of R rows.
template <int D, int R>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int h, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int rr = 0; rr < R / 64; ++rr)
      hopper::tma_load_4d(dst + c * R * 128 + rr * kBlock, map, bar, c * 64, row0 + rr * 64, h, b);
}

// Writes a consumer's 64 x D accumulator (rows 16 warp + g (+ 8), times
// `mul`) as bf16 rows of a contiguous [*, D] matrix, rows below `valid`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 2], int valid,
                                           float mul, int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    if (r >= valid) continue;
    __nv_bfloat16* row = out + static_cast<long long>(r) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8) =
          __floats2bfloat162_rn(acc[4 * dt + 2 * i] * mul, acc[4 * dt + 2 * i + 1] * mul);
  }
}

// dK/dV at D = 64 and 128: a CTA owns 128 keys of one KV head, a consumer
// warpgroup 64 of them, and walks the 64-row q tiles of its group's heads
// that see them.  Each warpgroup computes S^T = K Q^T and dP^T = V dO^T,
// P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q; the two
// warpgroups share the ring of Q, dO, LSE and delta tiles and nothing else.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tlse,
                            const __grid_constant__ CUtensorMap tdelta, const Params p) {
  using L = DkdvSmem<D>;
  static_assert(!L::kSplit, "D = 256 runs flash_bwd_dkdv_kernel_wgmma_split");
  constexpr int kBK = L::kBK, kBQ = kWgRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::kStages;

  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kBK;  // key tile 0 sees the most causal rows: heaviest first
  const int kcount = min(kBK, p.skv - k0);
  const int off = p.skv - p.s_len;  // row position = q index + off
  const int nq = (p.s_len + kBQ - 1) / kBQ;
  const int iq_begin = p.causal ? max(0, k0 - off) / kBQ : 0;
  int iq_end = nq;
  if (p.window > 0) {
    const int last = k0 + kcount - 2 + p.window - off;  // the last q index in the window
    iq_end = last >= 0 ? min(nq, last / kBQ + 1) : 0;
  }
  const int n_iq = max(iq_end - iq_begin, 0);
  const int n_steps = p.group * n_iq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int st = 0; st < L::kStages; ++st) {
      hopper::mbar_init(full + st, 1);
      hopper::mbar_init(empty + st, 8);  // one arrival from each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the TMA loads ahead ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * L::kKvTile);
      load_tile<D, kBK>(smem + L::kK, &tk, kv_full, k0, hk, b);
      load_tile<D, kBK>(smem + L::kV, &tv, kv_full, k0, hk, b);
      for (int j = 0; j < n_steps; ++j) {
        const int h = hk * p.group + j / n_iq;
        const int q0 = (iq_begin + j % n_iq) * kBQ;
        const int st = j % L::kStages;
        hopper::mbar_wait(empty + st, ((j / L::kStages) & 1u) ^ 1u);  // the first round passes
        hopper::mbar_arrive_expect_tx(full + st, 2 * L::kQTile + 2 * 256);
        load_tile<D, kBQ>(smem + L::kQ + st * L::kQTile, &tq, full + st, q0, h, b);
        load_tile<D, kBQ>(smem + L::kDo + st * L::kQTile, &tdo, full + st, q0, h, b);
        const int row = (b * p.hq + h) * p.s_pad + q0;  // a multiple of 64: 256-byte aligned
        hopper::tma_load_1d(smem + L::kLse + st * 256, &tlse, full + st, row);
        hopper::tma_load_1d(smem + L::kDelta + st * 256, &tdelta, full + st, row);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int cw = __shfl_sync(0xffffffffu, (threadIdx.x >> 7) - 1, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group and column pair
  const uint32_t base = hopper::smem_addr(smem);
  // this warpgroup's 64 keys start 64 rows (8 KB) into each column block
  const uint32_t k_addr = base + L::kK + cw * kBlock;
  const uint32_t v_addr = base + L::kV + cw * kBlock;
  const float scale_log2 = p.scale * kLog2e;
  const int wk0 = k0 + cw * kWgRows;      // this warpgroup's first key
  const int c_lo = wk0 + warp * 16 + g;  // this thread's keys c_lo and c_lo + 8

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[32], dp[32];  // S^T then P^T, dP^T then dS^T: [key][q row]
  uint32_t ap[4][4], ads[4][4];

  hopper::mbar_wait(kv_full, 0);
  for (int j = 0; j < n_steps; ++j) {
    const int st = j % L::kStages;
    const int q0 = (iq_begin + j % n_iq) * kBQ;
    const uint32_t q_addr = base + L::kQ + st * L::kQTile;
    const uint32_t do_addr = base + L::kDo + st * L::kQTile;
    const float* lse = reinterpret_cast<const float*>(smem + L::kLse + st * 256);
    const float* delta = reinterpret_cast<const float*>(smem + L::kDelta + st * 256);
    hopper::mbar_wait(full + st, (j / L::kStages) & 1u);
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    issue_ss<D, kBQ>(s, k_addr, q_addr, L::kKvBlock);    // S^T = K Q^T
    issue_ss<D, kBQ>(dp, v_addr, do_addr, L::kKvBlock);  // dP^T = V dO^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    // P^T = exp(S^T scale - LSE) over the kept (key, row) pairs; only steps
    // that cut the causal diagonal, the window's edge or the end of the keys
    // or rows are masked (rows past S have LSE +inf either way)
    const bool whole = q0 + kBQ <= p.s_len && wk0 + kWgRows <= p.skv &&
                       (!p.causal || wk0 + kWgRows - 1 <= q0 + off) &&
                       (p.window <= 0 || wk0 > q0 + kBQ - 1 + off - p.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = 8 * (i >> 2) + 2 * t + (i & 1);
      const float e = ex2(fmaf(s[i], scale_log2, -lse[r] * kLog2e));
      s[i] = whole || (q0 + r < p.s_len &&
                       kept(q0 + r + off, c_lo + 8 * ((i >> 1) & 1), p.skv, p.causal, p.window))
                 ? e
                 : 0.f;
    }
    to_frags(s, ap);
    fence_frags(ap);
    hopper::fence_regs(dv);
    hopper::wgmma_fence();
    issue_rs<D, 4>(dv, ap, do_addr, kBlock);  // dV += P^T dO, while dS^T is formed
    hopper::wgmma_commit();
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = 8 * (i >> 2) + 2 * t + (i & 1);
      dp[i] = s[i] * (dp[i] - delta[r]);
    }
    to_frags(dp, ads);
    fence_frags(ads);
    hopper::fence_regs(dk);
    hopper::wgmma_fence();
    issue_rs<D, 4>(dk, ads, q_addr, kBlock);  // dK += dS^T Q
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    fence_frags(ap);
    fence_frags(ads);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + st);  // this warp is done with the stage
  }

  const long long out_rows = (static_cast<long long>(b) * p.hkv + hk) * p.skv + wk0;
  store_rows<D>(static_cast<__nv_bfloat16*>(p.dv) + out_rows * D, dv, kcount - cw * kWgRows, 1.f,
                warp, g, t);
  store_rows<D>(static_cast<__nv_bfloat16*>(p.dk) + out_rows * D, dk, kcount - cw * kWgRows,
                p.scale, warp, g, t);
}

// dK/dV at D = 256: a CTA owns 64 keys of one KV head and walks the 64-row
// q tiles of its group's heads that see them.  Warpgroup 1 ("P") computes
// S^T = K Q^T, P^T and dV += P^T dO; warpgroup 2 ("dS") computes
// dP^T = V dO^T, takes P^T from warpgroup 1 through shared memory (f32, two
// buffers), and computes dS^T and dK += dS^T Q.  Each holds one 64 x 256
// accumulator: 128 registers a thread, where both would need 256.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_kernel_wgmma_split(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tlse,
                            const __grid_constant__ CUtensorMap tdelta, const Params p) {
  using L = DkdvSmem<D>;
  static_assert(L::kSplit, "the split dK/dV kernel is for D = 256");
  constexpr int kBQ = kWgRows, kN = kBQ / 2, kK = kBQ / 16, kBufs = 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::kStages;

  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kWgRows;  // key tile 0 sees the most causal rows: heaviest first
  const int kcount = min(kWgRows, p.skv - k0);
  const int off = p.skv - p.s_len;  // row position = q index + off
  const int nq = (p.s_len + kBQ - 1) / kBQ;
  const int iq_begin = p.causal ? max(0, k0 - off) / kBQ : 0;
  int iq_end = nq;
  if (p.window > 0) {
    const int last = k0 + kcount - 2 + p.window - off;  // the last q index in the window
    iq_end = last >= 0 ? min(nq, last / kBQ + 1) : 0;
  }
  const int n_iq = max(iq_end - iq_begin, 0);
  const int n_steps = p.group * n_iq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int st = 0; st < L::kStages; ++st) {
      hopper::mbar_init(full + st, 1);
      hopper::mbar_init(empty + st, 8);  // one arrival from each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the TMA loads ahead ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * L::kKvTile);
      load_tile<D, kWgRows>(smem + L::kK, &tk, kv_full, k0, hk, b);
      load_tile<D, kWgRows>(smem + L::kV, &tv, kv_full, k0, hk, b);
      for (int j = 0; j < n_steps; ++j) {
        const int h = hk * p.group + j / n_iq;
        const int q0 = (iq_begin + j % n_iq) * kBQ;
        const int st = j % L::kStages;
        hopper::mbar_wait(empty + st, ((j / L::kStages) & 1u) ^ 1u);  // the first round passes
        hopper::mbar_arrive_expect_tx(full + st, 2 * L::kQTile + 2 * kBQ * 4);
        load_tile<D, kBQ>(smem + L::kQ + st * L::kQTile, &tq, full + st, q0, h, b);
        load_tile<D, kBQ>(smem + L::kDo + st * L::kQTile, &tdo, full + st, q0, h, b);
        const int row = (b * p.hq + h) * p.s_pad + q0;  // a multiple of 64: 256-byte aligned
        hopper::tma_load_1d(smem + L::kLse + st * kBQ * 4, &tlse, full + st, row);
        hopper::tma_load_1d(smem + L::kDelta + st * kBQ * 4, &tdelta, full + st, row);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int cw = __shfl_sync(0xffffffffu, (threadIdx.x >> 7) - 1, 0);  // 0: P and dV, 1: dS and dK
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int tid = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group and column pair
  const uint32_t base = hopper::smem_addr(smem);
  float* xch = reinterpret_cast<float*>(smem + L::kXch);
  const float scale_log2 = p.scale * kLog2e;
  const int c_lo = k0 + warp * 16 + g;  // this thread's keys c_lo and c_lo + 8

  float acc[D / 2];  // dV (warpgroup 1) or dK (warpgroup 2): keys 16 warp + g (+ 8)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float x[kN];  // S^T then P^T, or dP^T then dS^T: [key][q row]
  uint32_t a[kK][4];

  hopper::mbar_wait(kv_full, 0);
  for (int j = 0; j < n_steps; ++j) {
    const int st = j % L::kStages, buf = j % kBufs;
    const int q0 = (iq_begin + j % n_iq) * kBQ;
    const uint32_t q_addr = base + L::kQ + st * L::kQTile;
    const uint32_t do_addr = base + L::kDo + st * L::kQTile;
    hopper::mbar_wait(full + st, (j / L::kStages) & 1u);
    hopper::fence_regs(x);
    hopper::wgmma_fence();
    issue_ss<D, kBQ>(x, base + (cw == 0 ? L::kK : L::kV), cw == 0 ? q_addr : do_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(x);
    float* xb = xch + buf * kN * 128;
    if (cw == 0) {
      // P^T = exp(S^T scale - LSE) over the kept (key, row) pairs; only
      // steps that cut the causal diagonal, the window's edge or the end of
      // the keys or rows are masked (rows past S have LSE +inf either way)
      const float* lse = reinterpret_cast<const float*>(smem + L::kLse + st * kBQ * 4);
      const bool whole = q0 + kBQ <= p.s_len && kcount == kWgRows &&
                         (!p.causal || k0 + kWgRows - 1 <= q0 + off) &&
                         (p.window <= 0 || k0 > q0 + kBQ - 1 + off - p.window);
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int r = 8 * (i >> 2) + 2 * t + (i & 1);
        const float e = ex2(fmaf(x[i], scale_log2, -lse[r] * kLog2e));
        x[i] = whole || (q0 + r < p.s_len &&
                         kept(q0 + r + off, c_lo + 8 * ((i >> 1) & 1), p.skv, p.causal, p.window))
                   ? e
                   : 0.f;
      }
      if (j >= kBufs) hopper::named_bar_sync(3 + buf, 256);  // warpgroup 2 is done with it
#pragma unroll
      for (int i = 0; i < kN; ++i) xb[i * 128 + tid] = x[i];
      __threadfence_block();
      hopper::named_bar_arrive(1 + buf, 256);
      to_frags(x, a);
      fence_frags(a);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      issue_rs<D, kK>(acc, a, do_addr, kBlock);  // dV += P^T dO
    } else {
      // dS^T = P^T (dP^T - delta)
      const float* delta = reinterpret_cast<const float*>(smem + L::kDelta + st * kBQ * 4);
      hopper::named_bar_sync(1 + buf, 256);  // P^T of this step is in the buffer
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int r = 8 * (i >> 2) + 2 * t + (i & 1);
        x[i] = xb[i * 128 + tid] * (x[i] - delta[r]);
      }
      if (j + kBufs < n_steps) hopper::named_bar_arrive(3 + buf, 256);
      to_frags(x, a);
      fence_frags(a);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      issue_rs<D, kK>(acc, a, q_addr, kBlock);  // dK += dS^T Q
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + st);  // this warp is done with the stage
  }

  const long long out_rows = (static_cast<long long>(b) * p.hkv + hk) * p.skv + k0;
  if (cw == 0) {
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dv) + out_rows * D, acc, kcount, 1.f, warp, g, t);
  } else {
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dk) + out_rows * D, acc, kcount, p.scale, warp, g,
                  t);
  }
}

// dQ: a CTA owns 128 q rows of one head (the heaviest causal tiles first),
// two consumer warpgroups of 64 rows, and walks the kBK-key tiles that the
// forward visits: S = Q K^T and dP = dO V^T, dS = P (dP - delta) in
// registers, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const Params p) {
  using L = DqSmem<D>;
  constexpr int kBQ = 2 * kWgRows, kBK = L::kBK, kN = kBK / 2, kK = kBK / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + L::kKStages;
  uint64_t* v_full = k_empty + L::kKStages;
  uint64_t* v_empty = v_full + L::kVStages;

  const int nq = (p.s_len + kBQ - 1) / kBQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * kBQ;
  const int rows = min(kBQ, p.s_len - q0);
  const int q_lo = q0 + (p.skv - p.s_len);
  const int q_hi = q_lo + rows - 1;
  int kt_end = (p.skv + kBK - 1) / kBK;
  if (p.causal) kt_end = q_hi >= 0 ? min(kt_end, q_hi / kBK + 1) : 0;
  const int kt_begin = p.window > 0 ? max(0, q_lo - p.window + 1) / kBK : 0;
  const int n_tiles = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < L::kKStages; ++st) {
      hopper::mbar_init(k_full + st, 1);
      hopper::mbar_init(k_empty + st, 8);
    }
    for (int st = 0; st < L::kVStages; ++st) {
      hopper::mbar_init(v_full + st, 1);
      hopper::mbar_init(v_empty + st, 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int hk = h / p.group;
      hopper::mbar_arrive_expect_tx(q_full, 4 * L::kTile);
      for (int half = 0; half < 2; ++half) {
        load_tile<D, kWgRows>(smem + L::kQ + half * L::kTile, &tq, q_full, q0 + half * kWgRows,
                              h, b);
        load_tile<D, kWgRows>(smem + L::kDo + half * L::kTile, &tdo, q_full, q0 + half * kWgRows,
                              h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int k0 = (kt_begin + j) * kBK;
        const int sk = j % L::kKStages, sv = j % L::kVStages;
        hopper::mbar_wait(k_empty + sk, ((j / L::kKStages) & 1u) ^ 1u);
        hopper::mbar_arrive_expect_tx(k_full + sk, L::kKvTile);
        load_tile<D, kBK>(smem + L::kK + sk * L::kKvTile, &tk, k_full + sk, k0, hk, b);
        hopper::mbar_wait(v_empty + sv, ((j / L::kVStages) & 1u) ^ 1u);
        hopper::mbar_arrive_expect_tx(v_full + sv, L::kKvTile);
        load_tile<D, kBK>(smem + L::kV + sv * L::kKvTile, &tv, v_full + sv, k0, hk, b);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<240>();
  const int cw = __shfl_sync(0xffffffffu, (threadIdx.x >> 7) - 1, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = cw * kWgRows + warp * 16 + g;  // this thread's tile rows r0 and r0 + 8
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t q_addr = base + L::kQ + cw * L::kTile;
  const uint32_t do_addr = base + L::kDo + cw * L::kTile;
  const float scale_log2 = p.scale * kLog2e;
  const long long row_base = (static_cast<long long>(b) * p.hq + h) * p.s_len + q0;
  const long long pad_base = (static_cast<long long>(b) * p.hq + h) * p.s_pad + q0;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = r0 + 8 * i < rows;
    lse2[i] = ok ? p.lse_pad[pad_base + r0 + 8 * i] * kLog2e : 0.f;
    dlt[i] = ok ? p.delta[pad_base + r0 + 8 * i] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[kN], dp[kN];
  uint32_t a[kK][4];
  const int wg_rows = rows - cw * kWgRows;            // valid rows of this warpgroup
  const int wg_lo = q_lo + cw * kWgRows, wg_hi = wg_lo + kWgRows - 1;

  hopper::mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = (kt_begin + j) * kBK;
    const int sk = j % L::kKStages, sv = j % L::kVStages;
    const uint32_t k_addr = base + L::kK + sk * L::kKvTile;
    hopper::mbar_wait(k_full + sk, (j / L::kKStages) & 1u);
    hopper::mbar_wait(v_full + sv, (j / L::kVStages) & 1u);
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    issue_ss<D, kBK>(s, q_addr, k_addr);                            // S = Q K^T
    issue_ss<D, kBK>(dp, do_addr, base + L::kV + sv * L::kKvTile);  // dP = dO V^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(v_empty + sv);  // V of this tile is free
    // only tiles that cut the causal diagonal, the window's edge or the end
    // of the keys or rows are masked
    const bool whole = wg_rows >= kWgRows && k0 + kBK <= p.skv &&
                       (!p.causal || k0 + kBK - 1 <= wg_lo) &&
                       (p.window <= 0 || k0 > wg_hi - p.window);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = (i >> 1) & 1;
      const int r = r0 + 8 * e;
      const int c = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const float pv = ex2(fmaf(s[i], scale_log2, -lse2[e]));
      const bool live = whole || (r < rows && kept(q_lo + r, c, p.skv, p.causal, p.window));
      dp[i] = live ? pv * (dp[i] - dlt[e]) : 0.f;
    }
    to_frags(dp, a);
    fence_frags(a);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    issue_rs<D, kK>(acc, a, k_addr, L::kKvBlock);  // dQ += dS K
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(k_empty + sk);  // K of this tile is free
  }

  store_rows<D>(static_cast<__nv_bfloat16*>(p.dq) + (row_base + cw * kWgRows) * D, acc,
                rows - cw * kWgRows, p.scale, warp, g, t);
}

template <int D>
int launch_wgmma(const Params& p, int batch, const long long* st, cudaStream_t stream) {
  const long long n_rows = static_cast<long long>(batch) * p.hq * p.s_pad;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  int rc = hopper::encode_map(&tq, p.q, D, p.s_len, p.hq, batch, st[0], st[1], st[2], kWgRows);
  if (rc == 0)
    rc = hopper::encode_map(&tk, p.k, D, p.skv, p.hkv, batch, st[3], st[4], st[5], kWgRows);
  if (rc == 0)
    rc = hopper::encode_map(&tv, p.v, D, p.skv, p.hkv, batch, st[6], st[7], st[8], kWgRows);
  // (every map's box is 64 rows: a longer tile is loaded as several boxes)
  if (rc == 0)
    rc = hopper::encode_map(&tdo, p.dout, D, p.s_len, p.hq, batch,
                            static_cast<long long>(p.hq) * p.s_len * D,
                            static_cast<long long>(p.s_len) * D, D, kWgRows);
  if (rc == 0) rc = hopper::encode_map_1d(&tlse, p.lse_pad, n_rows, kWgRows);
  if (rc == 0) rc = hopper::encode_map_1d(&tdelta, p.delta, n_rows, kWgRows);
  if (rc != 0) return rc;
  cudaError_t err = launch_preprocess<__nv_bfloat16>(p, batch, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto dkdv = [] {
    if constexpr (DkdvSmem<D>::kSplit) {
      return flash_bwd_dkdv_kernel_wgmma_split<D>;
    } else {
      return flash_bwd_dkdv_kernel_wgmma<D>;
    }
  }();
  auto dq = flash_bwd_dq_kernel_wgmma<D>;
  const int kv_bytes = static_cast<int>(DkdvSmem<D>::kBytes);
  const int q_bytes = static_cast<int>(DqSmem<D>::kBytes);
  if ((err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int nk = (p.skv + DkdvSmem<D>::kBK - 1) / DkdvSmem<D>::kBK;
  dkdv<<<dim3(nk, p.hkv, batch), kWgThreads, kv_bytes, stream>>>(tq, tk, tv, tdo, tlse, tdelta, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int nq = (p.s_len + 2 * kWgRows - 1) / (2 * kWgRows);
  dq<<<dim3(nq, p.hq, batch), kWgThreads, q_bytes, stream>>>(tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

bool uses_wgmma(int dtype, int d) { return dtype == 1 && (d == 64 || d == 128 || d == 256); }

}  // namespace

extern "C" {

// 1 if the backward is compiled for head dimension d
int flash_attention_bwd_supports(int d) {
  return d == 16 || d == 32 || d == 64 || d == 96 || d == 128 || d == 192 || d == 256;
}

// dtype 0 = float32, 1 = bfloat16.  q, k, v: strided with a contiguous last
// dimension (strides[0..8] = q, k, v batch/head/seq strides in elements); o,
// dout, dq [B,Hq,S,D] and dk, dv [B,Hkv,Skv,D] contiguous; lse the forward's
// contiguous f32 [B,Hq,S] log-sum-exp; scratch holds
// flash_attention_bwd_scratch_floats(dtype, d, batch, hq, s_len) floats
// (delta; on the wgmma route delta and a copy of lse, in rows padded to a
// multiple of 64).  Returns a cudaError_t (0 on success), or on the wgmma route a
// tensor-map error code (hopper::kTensorMapError + CUresult,
// hopper::kNoEncoder).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, void* dq, void* dk, void* dv,
                               float* scratch, int dtype, int batch, int hq, int hkv, int s_len,
                               int skv, int d, const long long* strides, float scale, int causal,
                               int window, cudaStream_t stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 || skv <= 0)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  const bool wg = uses_wgmma(dtype, d);
  p.lse = lse;
  p.s_pad = wg ? (s_len + kWgRows - 1) / kWgRows * kWgRows : s_len;
  p.delta = scratch;
  p.lse_pad = wg ? scratch + static_cast<long long>(batch) * hq * p.s_pad : nullptr;
  p.hq = hq;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.s_len = s_len;
  p.skv = skv;
  p.d = d;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  if (wg) {
    switch (d) {
      case 64: return launch_wgmma<64>(p, batch, strides, stream);
      case 128: return launch_wgmma<128>(p, batch, strides, stream);
      case 256: return launch_wgmma<256>(p, batch, strides, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (uses_mma(dtype, d)) return launch_mma_head_dim(d, p, batch, stream);
  if (dtype == 0) return launch_head_dim<float>(d, p, batch, stream);
  if (dtype == 1) return launch_head_dim<__nv_bfloat16>(d, p, batch, stream);
  return cudaErrorInvalidValue;
}

// Floats of the scratch buffer that flash_attention_bwd_launch takes.
long long flash_attention_bwd_scratch_floats(int dtype, int d, int batch, int hq, int s_len) {
  const long long rows = static_cast<long long>(batch) * hq;
  return uses_wgmma(dtype, d) ? 2 * rows * ((s_len + kWgRows - 1) / kWgRows * kWgRows)
                              : rows * s_len;
}

// The byte alignment every q, k, v, o and dout row start needs: 16 on the
// tensor-core routes (16-byte loads; the TMA's rule for addresses and
// strides on the wgmma route), else that of one element.
int flash_attention_bwd_row_align(int dtype, int d) {
  return uses_wgmma(dtype, d) || uses_mma(dtype, d) ? 16 : (dtype == 0 ? 4 : 2);
}

}  // extern "C"
