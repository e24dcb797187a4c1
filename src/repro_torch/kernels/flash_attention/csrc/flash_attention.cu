// Causal / sliding-window GQA flash attention, forward, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// :_flash_kernel (entry point flash_attention_pallas).  Semantics are those of
// ref.attention_ref: q [B,Hq,S,D] against k/v [B,Hkv,Skv,D], KV head
// h / (Hq/Hkv), q rows right-aligned to the end of the KV (row position
// i + Skv - S), a key col kept when col < Skv, col <= row (causal) and
// col > row - window (window > 0); softmax and accumulation in f32; out in
// q's dtype.  As in the TPU kernel, masked scores are -1e30 and
// out = acc / max(l, 1e-30).  Unlike the TPU kernel, `col < Skv` is masked
// without causality too (the Pallas kernel attends to its zero-padded keys
// there).
//
// Bound: at the serving shape (B=4, H=32, S=Skv=4096, D=128, causal) the two
// products are 4*B*H*S^2*D/2 = 0.55 TFLOP against 0.54 GB of q, k, v and o,
// so the work, not the bytes, bounds it: 0.56 ms at the card's 989 TFLOP/s of
// dense bf16.
//
// Both kernels launch one CTA per (q tile of 64 rows, head, batch), the
// heaviest causal tiles first.  The TPU grid's sequential KV axis is a loop
// inside the CTA that carries the running max m, sum l and the accumulator in
// registers; KV tiles of 64 keys are staged through shared memory, and tiles
// wholly in the future or behind the window are never visited.  No atomics:
// every run gives the same bits.
//
// flash_fwd_kernel_mma (bfloat16, D <= 128, the serving path): 4 warps of 16
// q rows each, the products on the tensor cores with mma.sync m16n8k16 (bf16
// in, f32 accumulate).  Q K^T multiplies the bf16 inputs exactly and scales
// the f32 product (as attention_ref does; the TPU kernel scales q first, the
// same value up to the last f32 bit).  P stays f32 for the softmax and enters
// P V as two bf16 halves, hi = bf16(p) and lo = bf16(p - hi), so P V keeps
// ~16 bits of p (error ~2^-17 of p) at twice the P V tensor work.  Score
// fragments become P's A fragments in registers (the accumulator layout of
// two n-tiles is the A layout of one k-step); V's B fragments come from
// ldmatrix.trans.  q, k and v rows must start on 16 bytes (the wrapper
// copies a tensor that does not).
//
// flash_fwd_kernel (float32, and bfloat16 with D > 128): every product in f32
// on the CUDA cores (bf16 widened when staged), so its ceiling is the card's
// 67 TFLOP/s of f32 FMA.  256 threads; thread (rg, cg) owns rows 4rg..4rg+3,
// score columns 4cg..4cg+3 and D/16 output columns; a row's 16 threads are
// one half-warp, so row max and sum are shuffle reductions.  K is staged
// transposed (kt[d][col]) for Q K^T, then V (v[col][d]) in the same buffer;
// q is scaled in f32 before the product, as in the TPU kernel.
//
// Shared memory is dynamic (above the 48 KB static limit at D=128), after
// cudaFuncSetAttribute: 52 KB for the tensor-core kernel at D=128, 87 KB for
// the f32 one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLd = kBlockQ + 4;  // padded row of the transposed tiles; keeps float4 alignment
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
struct Smem {
  static constexpr int kQt = D * kLd;                                      // qt[d][row]
  static constexpr int kKv = D * kLd > kBlockK * D ? D * kLd : kBlockK * D;  // kt[d][col], then v[col][d]
  static constexpr int kPt = kBlockK * kLd;                                // pt[col][row]
  static constexpr size_t kBytes = sizeof(float) * (kQt + kKv + kPt);
};

// Output column of accumulator slot j of column group cg: float4 runs of a
// 64-wide stripe when D is a multiple of 64, else a stride of 16.
template <int D>
__device__ __forceinline__ int out_col(int j, int cg) {
  if constexpr (D % 64 == 0) {
    return (j / 4) * 64 + cg * 4 + (j % 4);
  } else {
    return j * 16 + cg;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int hq, int group, int s_len, int skv,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 float scale, int causal, int window) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kv = smem + Smem<D>::kQt;
  float* pt = kv + Smem<D>::kKv;

  const int nq = (s_len + kBlockQ - 1) / kBlockQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows 4rg .. 4rg+3
  const int cg = tid & 15;  // score columns 4cg .. 4cg+3

  const int q0 = iq * kBlockQ;
  const int rows = min(kBlockQ, s_len - q0);
  const int q_lo = q0 + (skv - s_len);  // absolute position of the tile's first row
  const int q_hi = q_lo + rows - 1;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / group) * k_sh;
  const T* vb = v + b * v_sb + (h / group) * v_sh;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    qt[d * kLd + r] = r < rows ? to_f32(qb[(q0 + r) * q_ss + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  int kt_end = (skv + kBlockK - 1) / kBlockK;
  if (causal) kt_end = q_hi >= 0 ? min(kt_end, q_hi / kBlockK + 1) : 0;
  const int kt_begin = window > 0 ? max(0, q_lo - window + 1) / kBlockK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's P V is done with kv and pt
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      kv[d * kLd + c] = k0 + c < skv ? to_f32(kb[(k0 + c) * k_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * kLd + rg * 4);
      const float4 ka = *reinterpret_cast<const float4*>(kv + d * kLd + cg * 4);
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kc[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

    // mask and online softmax; a row's 16 threads are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_lo + rg * 4 + i;
      bool live[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg * 4 + j;
        live[j] = col < skv && (!causal || col <= row) && (window <= 0 || col > row - window);
        s[i][j] = live[j] ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading K
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (cg * 4 + j) * kLd + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      kv[c * D + d] = k0 + c < skv ? to_f32(vb[(k0 + c) * v_ss + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + c * kLd + rg * 4);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
      const float* vr = kv + c * D;
      if constexpr (D % 64 == 0) {
#pragma unroll
        for (int jj = 0; jj < D / 64; ++jj) {
          const float4 va = *reinterpret_cast<const float4*>(vr + jj * 64 + cg * 4);
          const float vc[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][jj * 4 + e] = fmaf(pr[i], vc[e], acc[i][jj * 4 + e]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float vc = vr[j * 16 + cg];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vc, acc[i][j]);
        }
      }
    }
  }

  T* ob = o + (static_cast<long long>(b) * hq + h) * s_len * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (r >= rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = ob + static_cast<long long>(q0 + r) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(orow + out_col<D>(j, cg), acc[i][j] / den);
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o, int batch, int hq,
                         int hkv, int s_len, int skv, const long long* st, float scale, int causal,
                         int window, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const int bytes = static_cast<int>(Smem<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + kBlockQ - 1) / kBlockQ, hq, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hq / hkv, s_len, skv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_head_dim(int d, const void* q, const void* k, const void* v, void* o, int batch,
                            int hq, int hkv, int s_len, int skv, const long long* st, float scale,
                            int causal, int window, cudaStream_t stream) {
#define FLASH_CASE(DIM)                                                                      \
  case DIM:                                                                                  \
    return launch_typed<T, DIM>(q, k, v, o, batch, hq, hkv, s_len, skv, st, scale, causal, \
                                window, stream);
  switch (d) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(96)
    FLASH_CASE(128)
    FLASH_CASE(192)
    FLASH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}


// ---------------------------------------------------- tensor-core (bf16) ---

constexpr int kMmaThreads = 128;  // 4 warps x 16 q rows

template <int D>
struct MmaSmem {
  static constexpr int kLd = D + 8;  // bf16 a staged row: 16-byte aligned, conflict-free fragments
  static constexpr size_t kBytes = sizeof(__nv_bfloat16) * (kBlockQ + 2 * kBlockK) * kLd;
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

// (x, y) as bf16x2 hi and the bf16x2 of what hi leaves: hi + lo carries ~16
// bits of each value
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// rows [row0, row0 + valid) of a [*, D] bf16 matrix into a [64][D + 8] tile,
// 16 bytes a thread a step; rows past `valid` are zero
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride, int row0, int valid) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kBlockQ * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + ch * 8);
    *reinterpret_cast<uint4*>(dst + r * MmaSmem<D>::kLd + ch * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_kernel_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int hq,
                     int group, int s_len, int skv, long long q_sb, long long q_sh,
                     long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
                     int window) {
  constexpr int kLd = MmaSmem<D>::kLd;
  constexpr int kKSteps = D / 16;  // k-steps of Q K^T
  constexpr int kDTiles = D / 8;   // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * kLd;
  __nv_bfloat16* vs = ks + kBlockK * kLd;

  const int nq = (s_len + kBlockQ - 1) / kBlockQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair

  const int q0 = iq * kBlockQ;
  const int rows = min(kBlockQ, s_len - q0);
  const int q_lo = q0 + (skv - s_len);
  const int q_hi = q_lo + rows - 1;
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the tile
  const int row_pos[2] = {q_lo + r0, q_lo + r0 + 8};

  const __nv_bfloat16* kb = k + b * k_sb + (h / group) * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + (h / group) * v_sh;

  stage_tile<D>(qs, q + b * q_sb + h * q_sh, q_ss, q0, rows);
  __syncthreads();
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const __nv_bfloat16* qr = qs + r0 * kLd + kk * 16 + 2 * t;
    qf[kk][0] = ld32(qr);
    qf[kk][1] = ld32(qr + 8 * kLd);
    qf[kk][2] = ld32(qr + 8);
    qf[kk][3] = ld32(qr + 8 * kLd + 8);
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum

  int kt_end = (skv + kBlockK - 1) / kBlockK;
  if (causal) kt_end = q_hi >= 0 ? min(kt_end, q_hi / kBlockK + 1) : 0;
  const int kt_begin = window > 0 ? max(0, q_lo - window + 1) / kBlockK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done with ks and vs
    stage_tile<D>(ks, kb, k_ss, k0, min(kBlockK, skv - k0));
    stage_tile<D>(vs, vb, v_ss, k0, min(kBlockK, skv - k0));
    __syncthreads();

    float s[8][4];  // 8 n-tiles of 8 keys: rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    uint32_t live = 0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_pos[e >> 1];
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = col < skv && (!causal || col <= row) && (window <= 0 || col > row - window);
        live |= static_cast<uint32_t>(ok) << (nt * 4 + e);
        s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row's 4 threads are one quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new[i]);
      m[i] = m_new[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = (live >> (nt * 4 + e)) & 1u ? expf(s[nt][e] - m_new[e >> 1]) : 0.f;
        l[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: this lane's row of matrix `mat`
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const __nv_bfloat16* vr = vs + (kk * 16 + mrow + (mat & 1) * 8) * kLd + (mat >> 1) * 8;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vr + dp * 16);
        mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
  }

  __nv_bfloat16* ob = o + (static_cast<long long>(b) * hq + h) * s_len * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + 8 * i;
    if (r >= rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = ob + static_cast<long long>(q0 + r) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int batch, int hq,
                       int hkv, int s_len, int skv, const long long* st, float scale, int causal,
                       int window, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel_mma<D>;
  const int bytes = static_cast<int>(MmaSmem<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + kBlockQ - 1) / kBlockQ, hq, batch);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), hq, hq / hkv, s_len,
      skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal, window);
  return cudaGetLastError();
}

bool uses_mma(int dtype, int d) {
  return dtype == 1 && (d == 16 || d == 32 || d == 64 || d == 96 || d == 128);
}

cudaError_t launch_mma_head_dim(int d, const void* q, const void* k, const void* v, void* o,
                                int batch, int hq, int hkv, int s_len, int skv,
                                const long long* st, float scale, int causal, int window,
                                cudaStream_t stream) {
#define FLASH_MMA_CASE(DIM)                                                                  \
  case DIM:                                                                                  \
    return launch_mma<DIM>(q, k, v, o, batch, hq, hkv, s_len, skv, st, scale, causal, window, \
                           stream);
  switch (d) {
    FLASH_MMA_CASE(16)
    FLASH_MMA_CASE(32)
    FLASH_MMA_CASE(64)
    FLASH_MMA_CASE(96)
    FLASH_MMA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_MMA_CASE
}

}  // namespace

// 1 when the kernel is compiled for head dimension d.
extern "C" int flash_attention_supports(int d) {
  return d == 16 || d == 32 || d == 64 || d == 96 || d == 128 || d == 192 || d == 256;
}

// Byte alignment that every row start of q, k and v needs (base pointer and
// every batch, head and seq stride): 16 on the tensor-core path, else the
// element size.
extern "C" int flash_attention_row_align(int dtype, int d) {
  return uses_mma(dtype, d) ? 16 : (dtype == 0 ? 4 : 2);
}

// Launch on `stream`.  dtype 0 is float32, 1 is bfloat16 (q, k, v and o alike).
// strides holds (batch, head, seq) element strides of q, k and v in that order;
// the last dimension of each is contiguous.  o is a contiguous [B, Hq, S, D].
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int batch, int hq, int hkv, int s_len, int skv,
                                      int d, const long long* strides, float scale, int causal,
                                      int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || hq == 0 || s_len == 0) return static_cast<int>(cudaSuccess);
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      uses_mma(dtype, d)
      ? launch_mma_head_dim(d, q, k, v, o, batch, hq, hkv, s_len, skv, strides, scale, causal,
                            window, st)
      : dtype == 0
      ? launch_head_dim<float>(d, q, k, v, o, batch, hq, hkv, s_len, skv, strides, scale, causal,
                               window, st)
      : launch_head_dim<__nv_bfloat16>(d, q, k, v, o, batch, hq, hkv, s_len, skv, strides, scale,
                                       causal, window, st);
  return static_cast<int>(err);
}
