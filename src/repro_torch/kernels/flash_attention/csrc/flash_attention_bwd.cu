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
// (window > 0).  With P = softmax(scale * Q K^T) over the kept keys, O the
// forward's output and dO the output's gradient:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// each in f32 and returned in the inputs' dtype (bf16 or f32).
//
// Bound: the useful work is 2.5x the forward's (Q K^T and P V, 4 D FLOP a
// kept pair; the backward adds dO V^T, P^T dO, dS^T Q and dS K), so at
// granite-moe's training shape [4, 16, 4096, 64] causal it is 3.4e11 FLOP
// against 0.1 GB of inputs and gradients: bound by operations.
//
// Three kernels a call; none uses atomics, so a gradient has the same bits
// on every run.
//   1. preprocess (one CTA a q tile and head): delta = rowsum(dO * O), and
//      each row's softmax max m and 1 / sum, recomputed from Q K^T over the
//      row's kept key tiles (the forward kernels keep no log-sum-exp, and
//      stay untouched).
//   2. dK/dV (one CTA a key tile and KV head): K and V stay in shared
//      memory; the CTA walks the G query heads of its group and their q
//      tiles that can see the key tile (tiles wholly before the key tile
//      under causality, or past the window, are skipped), recomputing P and
//      dS, and accumulates dK and dV in registers.  Because the CTA owns its
//      KV head's rows, GQA needs no atomics.
//   3. dQ (one CTA a q tile and head, the heaviest causal tiles first):
//      Q and dO stay in shared memory; it walks the key tiles that the
//      forward visits and accumulates dQ in registers.
// Two routes take these three steps:
//   - bf16 with D = 16, 32, 64, 96 or 128 (every training config but
//     recurrentgemma's D = 256): the products on the tensor cores with
//     mma.sync (the `_mma` kernels below; see the comment there);
//   - f32, and bf16 with D = 192 or 256: every product in f32 on the CUDA
//     cores (bf16 widened when staged), whose ceiling is the card's 67
//     TFLOP/s of f32 FMA.  Tiles are 64 rows (32 for D > 128, so the four
//     staged [rows][D] tiles fit in shared memory); 256 threads, thread
//     (rg, cg) owning tile rows rg + 16 i and product columns cg + 16 j, or
//     output columns cg + 16 j of D, so a row's 16 threads are one
//     half-warp and every staged row is read 16 bytes a thread with rows
//     padded by 4 floats (conflict-free).
// Neither uses wgmma or TMA yet (the forward's flash_fwd_kernel_wgmma does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  static constexpr size_t kPreBytes = sizeof(float) * 2 * kStaged;
  static constexpr size_t kKvBytes = sizeof(float) * (4 * kStaged + 2 * kRows * kLdP + 3 * kRows);
  static constexpr size_t kQBytes = sizeof(float) * (4 * kStaged + kRows * kLdP + 3 * kRows);
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
  float* m;          // [B, Hq, S]: each row's softmax max
  float* inv_l;      // [B, Hq, S]: 1 / max(sum, 1e-30)
  float* delta;      // [B, Hq, S]: rowsum(dO * O)
  int hq, hkv, group, s_len, skv;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_preprocess_kernel(Params p) {
  constexpr int kRows = Tile<D>::kRows, kR = Tile<D>::kR, kLd = Tile<D>::kLd;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + Tile<D>::kStaged;

  const int nq = (p.s_len + kRows - 1) / kRows;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = iq * kRows;
  const int rows = min(kRows, p.s_len - q0);
  const int q_lo = q0 + (p.skv - p.s_len);
  const int q_hi = q_lo + rows - 1;
  const long long row_base = (static_cast<long long>(b) * p.hq + h) * p.s_len + q0;

  // delta: a half-warp a row (both half-warps of a warp take every step of
  // the loop, so the shuffles see the whole warp)
  const T* ob = static_cast<const T*>(p.o) + row_base * D;
  const T* gb = static_cast<const T*>(p.dout) + row_base * D;
  for (int r0 = 0; r0 < kRows; r0 += 16) {
    const int r = r0 + rg;
    float s = 0.f;
    if (r < rows)
      for (int d = cg; d < D; d += 16) s = fmaf(to_f32(gb[r * D + d]), to_f32(ob[r * D + d]), s);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (cg == 0 && r < rows) p.delta[row_base + r] = s;
  }

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
  stage<T, D>(qs, qb, p.q_ss, q0, rows);

  float m[kR], l[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  int kt_end = (p.skv + kRows - 1) / kRows;
  if (p.causal) kt_end = q_hi >= 0 ? min(kt_end, q_hi / kRows + 1) : 0;
  const int kt_begin = p.window > 0 ? max(0, q_lo - p.window + 1) / kRows : 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();  // the previous tile's products are done with ks
    stage<T, D>(ks, kb, p.k_ss, k0, min(kRows, p.skv - k0));
    __syncthreads();
    float s[kR][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) s[i][j] = 0.f;
    dot_rows<D>(s, qs, ks, rg, cg);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q_lo + rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const bool live = kept(row, k0 + cg + 16 * j, p.skv, p.causal, p.window);
        s[i][j] = live ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kR; ++j) sum += s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = rg + 16 * i;
      if (r < rows) {
        p.m[row_base + r] = m[i];
        p.inv_l[row_base + r] = 1.f / fmaxf(l[i], 1e-30f);
      }
    }
  }
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
  float* row_m = dst + kRows * kLdP;
  float* row_il = row_m + kRows;
  float* row_delta = row_il + kRows;

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
        row_m[tid] = ok ? p.m[head_rows + q0 + tid] : 0.f;
        row_il[tid] = ok ? p.inv_l[head_rows + q0 + tid] : 0.f;
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
          const float pv = live ? expf(s[i][j] * p.scale - row_m[r]) * row_il[r] : 0.f;
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
  float* row_m = ds + kRows * kLdP;
  float* row_il = row_m + kRows;
  float* row_delta = row_il + kRows;

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
    row_m[tid] = ok ? p.m[row_base + tid] : 0.f;
    row_il[tid] = ok ? p.inv_l[row_base + tid] : 0.f;
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
        const float pv = live ? expf(s[i][j] * p.scale - row_m[r]) * row_il[r] : 0.f;
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
  auto pre = flash_bwd_preprocess_kernel<T, D>;
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dq = flash_bwd_dq_kernel<T, D>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(pre, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(TL::kPreBytes))) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(TL::kKvBytes))) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(TL::kQBytes))) != cudaSuccess) return err;
  const int nq = (p.s_len + TL::kRows - 1) / TL::kRows;
  const int nk = (p.skv + TL::kRows - 1) / TL::kRows;
  pre<<<dim3(nq, p.hq, batch), kThreads, TL::kPreBytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv<<<dim3(nk, p.hkv, batch), kThreads, TL::kKvBytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq<<<dim3(nq, p.hq, batch), kThreads, TL::kQBytes, stream>>>(p);
  return cudaGetLastError();
}

// f32 at every D; bf16 only where the tensor-core path does not reach
// (D = 192, 256), so no other bf16 instantiation is compiled
template <typename T>
cudaError_t launch_head_dim(int d, const Params& p, int batch, cudaStream_t stream) {
  if constexpr (sizeof(T) == sizeof(float)) {
    switch (d) {
      case 16: return launch_typed<T, 16>(p, batch, stream);
      case 32: return launch_typed<T, 32>(p, batch, stream);
      case 64: return launch_typed<T, 64>(p, batch, stream);
      case 96: return launch_typed<T, 96>(p, batch, stream);
      case 128: return launch_typed<T, 128>(p, batch, stream);
      default: break;
    }
  }
  switch (d) {
    case 192: return launch_typed<T, 192>(p, batch, stream);
    case 256: return launch_typed<T, 256>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------ tensor cores (bf16) ---
//
// bfloat16 with D = 16, 32, 64, 96 or 128 runs the same three kernels with
// every product on the tensor cores: mma.sync m16n8k16 (bf16 in, f32
// accumulate), 128 threads a CTA, 4 warps of 16 rows (or keys) against
// tiles of 64, each staged with 16-byte loads into rows padded by 8 bf16.
// A product's A operand comes from shared memory (Q, dO, K, V) or straight
// from the previous product's f32 accumulators (P and dS, rounded to bf16,
// as the forward feeds P into P V), and its B operand from shared memory,
// through ldmatrix.trans where it is row-major in the reduced index (dO and
// Q for dV and dK, K for dQ).  The row statistics and rowsum(dO * O) are
// the CUDA-core path's.

constexpr int kMmaRows = 64;
constexpr int kMmaThreads = 128;

template <int D>
struct MmaTile {
  static constexpr int kLd = D + 8;  // a staged bf16 row: 16-byte aligned, conflict-free fragments
  static constexpr int kTile = kMmaRows * kLd;
  static constexpr size_t kPreBytes = sizeof(__nv_bfloat16) * 2 * kTile;
  static constexpr size_t kBytes = sizeof(__nv_bfloat16) * 4 * kTile + sizeof(float) * 3 * kMmaRows;
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
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_preprocess_kernel_mma(Params p) {
  constexpr int kLd = MmaTile<D>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + MmaTile<D>::kTile;

  const int nq = (p.s_len + kMmaRows - 1) / kMmaRows;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = iq * kMmaRows;
  const int rows = min(kMmaRows, p.s_len - q0);
  const int q_lo = q0 + (p.skv - p.s_len);
  const int q_hi = q_lo + rows - 1;
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the tile
  const long long row_base = (static_cast<long long>(b) * p.hq + h) * p.s_len + q0;

  // delta: a warp a row, 16 rows a warp
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(p.o) + row_base * D;
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(p.dout) + row_base * D;
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    float s = 0.f;
    if (r < rows)
      for (int d = lane; d < D; d += 32)
        s = fmaf(__bfloat162float(gb[r * D + d]), __bfloat162float(ob[r * D + d]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && r < rows) p.delta[row_base + r] = s;
  }

  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb +
                            (h / p.group) * p.k_sh;
  stage_bf16<D>(qs, static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
                q0, rows);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum
  int kt_end = (p.skv + kMmaRows - 1) / kMmaRows;
  if (p.causal) kt_end = q_hi >= 0 ? min(kt_end, q_hi / kMmaRows + 1) : 0;
  const int kt_begin = p.window > 0 ? max(0, q_lo - p.window + 1) / kMmaRows : 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kMmaRows;
    __syncthreads();  // the previous tile's readers are done with ks
    stage_bf16<D>(ks, kb, p.k_ss, k0, min(kMmaRows, p.skv - k0));
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    mma_rows<D>(s, qs, ks, warp * 16, g, t);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = kept(q_lo + r0 + 8 * (e >> 1), k0 + nt * 8 + 2 * t + (e & 1), p.skv,
                               p.causal, p.window);
        s[nt][e] = live ? s[nt][e] * p.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row's 4 threads are one quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      l[i] *= expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s[nt][e] > 0.5f * kNegInf) l[e >> 1] += expf(s[nt][e] - m[e >> 1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + 8 * i;
    if (t == 0 && r < rows) {
      p.m[row_base + r] = m[i];
      p.inv_l[row_base + r] = 1.f / fmaxf(l[i], 1e-30f);
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
  float* row_m = reinterpret_cast<float*>(gs + MmaTile<D>::kTile);
  float* row_il = row_m + kMmaRows;
  float* row_delta = row_il + kMmaRows;

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
        row_m[tid] = ok ? p.m[head_rows + q0 + tid] : 0.f;
        row_il[tid] = ok ? p.inv_l[head_rows + q0 + tid] : 0.f;
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
          const float pv = live ? expf(s[nt][e] * p.scale - row_m[r]) * row_il[r] : 0.f;
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
  float rm[2], ril[2], rdelta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = r0 + 8 * i < rows;
    rm[i] = ok ? p.m[row_base + r0 + 8 * i] : 0.f;
    ril[i] = ok ? p.inv_l[row_base + r0 + 8 * i] : 0.f;
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
        const float pv = live ? expf(s[nt][e] * p.scale - rm[i]) * ril[i] : 0.f;
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
  auto pre = flash_bwd_preprocess_kernel_mma<D>;
  auto dkdv = flash_bwd_dkdv_kernel_mma<D>;
  auto dq = flash_bwd_dq_kernel_mma<D>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(pre, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(TL::kPreBytes))) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(TL::kBytes))) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(TL::kBytes))) != cudaSuccess) return err;
  const int nq = (p.s_len + kMmaRows - 1) / kMmaRows;
  const int nk = (p.skv + kMmaRows - 1) / kMmaRows;
  pre<<<dim3(nq, p.hq, batch), kMmaThreads, TL::kPreBytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv<<<dim3(nk, p.hkv, batch), kMmaThreads, TL::kBytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq<<<dim3(nq, p.hq, batch), kMmaThreads, TL::kBytes, stream>>>(p);
  return cudaGetLastError();
}

bool uses_mma(int dtype, int d) {
  return dtype == 1 && (d == 16 || d == 32 || d == 64 || d == 96 || d == 128);
}

cudaError_t launch_mma_head_dim(int d, const Params& p, int batch, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_mma<16>(p, batch, stream);
    case 32: return launch_mma<32>(p, batch, stream);
    case 64: return launch_mma<64>(p, batch, stream);
    case 96: return launch_mma<96>(p, batch, stream);
    case 128: return launch_mma<128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// 1 if the backward is compiled for head dimension d
int flash_attention_bwd_supports(int d) {
  return d == 16 || d == 32 || d == 64 || d == 96 || d == 128 || d == 192 || d == 256;
}

// dtype 0 = float32, 1 = bfloat16.  q, k, v: strided with a contiguous last
// dimension (strides[0..8] = q, k, v batch/head/seq strides in elements); o,
// dout, dq [B,Hq,S,D] and dk, dv [B,Hkv,Skv,D] contiguous; scratch holds
// 3 * B * Hq * S floats.  Returns a cudaError_t (0 on success).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, void* dq, void* dk, void* dv, float* scratch,
                               int dtype, int batch, int hq, int hkv, int s_len, int skv, int d,
                               const long long* strides, float scale, int causal, int window,
                               cudaStream_t stream) {
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
  const long long rows = static_cast<long long>(batch) * hq * s_len;
  p.m = scratch;
  p.inv_l = scratch + rows;
  p.delta = scratch + 2 * rows;
  p.hq = hq;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.s_len = s_len;
  p.skv = skv;
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
  if (uses_mma(dtype, d)) return launch_mma_head_dim(d, p, batch, stream);
  if (dtype == 0) return launch_head_dim<float>(d, p, batch, stream);
  if (dtype == 1) return launch_head_dim<__nv_bfloat16>(d, p, batch, stream);
  return cudaErrorInvalidValue;
}

// The byte alignment every q, k, v, o and dout row start needs: 16 on the
// tensor-core path (16-byte loads), else that of one element.
int flash_attention_bwd_row_align(int dtype, int d) {
  return uses_mma(dtype, d) ? 16 : (dtype == 0 ? 4 : 2);
}

}  // extern "C"
