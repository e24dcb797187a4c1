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
// The log-sum-exp contract with the backward (flash_attention_bwd.cu): when
// the caller passes an lse pointer (training), every route also stores each
// row's log-sum-exp of the scaled, masked scores, m + log(l) in natural-log
// units, as f32 [B,Hq,S]; a row that keeps no key (causal with S > Skv)
// gets +inf, so that the backward's exp(s - lse) is 0 there.  It is one
// store a row in each epilogue: the output keeps the same bits with or
// without it.  Serving passes no pointer and nothing more is written.
//
// Bound: at the serving shape (B=4, H=32, S=Skv=4096, D=128, causal) the two
// products are 4*B*H*S^2*D/2 = 0.55 TFLOP against 0.54 GB of q, k, v and o,
// so the work, not the bytes, bounds it: 0.56 ms at the card's 989 TFLOP/s of
// dense bf16.  recurrentgemma's [4, 10, 4096, 256] with a 2048-key window:
// 0.26 TFLOP of kept pairs, 0.26 ms.
//
// Three kernels, one per route; none uses atomics, so every run gives the
// same bits.  Each CTA owns one (q tile, head, batch), the heaviest causal
// tiles first.  The TPU grid's sequential KV axis is a loop inside the CTA
// that carries the running max m, sum l and the accumulator in registers;
// tiles wholly in the future or behind the window are never visited.
//
// flash_fwd_kernel_wgmma (bfloat16, D = 64, 128 or 256: every family's
// attention): Hopper's asynchronous path.
//   Tiles: 128 q rows a CTA against KV tiles of 128 keys (64 at D = 256).
//   384 threads: warpgroup 0 is the producer, of which one thread issues the
//   loads; warpgroups 1 and 2 are consumers of 64 q rows each.
//   Loads: the TMA (cp.async.bulk.tensor, 4-D maps over (D, seq, head,
//   batch) built on the host per call from the tensors' own pointers and
//   strides, so the transposed projection views are read without a copy)
//   loads Q once and K and V into rings of 2 stages.  Each stage has a full
//   barrier (mbarrier transaction bytes) and an empty barrier, which the 8
//   consumer warps release, for K and for V apart.  A box is 64 columns
//   (128 bytes) x the tile's rows in the 128-byte swizzle, so a row of D is
//   D/64 boxes.  Rows past S or Skv load as zeros.
//   Products: S = Q K^T is wgmma m64n128k16 (m64n64k16 at D = 256) with Q
//   and K from shared memory (both K-major); O += P V is wgmma m64n{D}k16
//   (two m64n128k16 at D = 256) with P from registers (the S accumulator of
//   16 keys is the A fragment of one k-step) and V from shared memory in the
//   transpose-B (MN-major) form.  P is split into bf16 hi and lo halves as
//   below, so P V runs twice: 1.5x the tensor work of the useful 4*S*Skv*D
//   FLOP a head (the bound counts only the useful).
//   Schedule: a consumer issues Q K^T of tile j and P V of tile j - 1 as one
//   block, waits for it, then runs tile j's softmax.  The two consumers take
//   turns through named barriers (ping-pong), so one's softmax on the CUDA
//   cores runs while the other's block keeps the tensor cores busy.  Within
//   a warpgroup the softmax does not overlap its own products (that would
//   keep the next tile's P live through the softmax and spill), and the
//   output goes from registers to global memory (no TMA store).
//   Softmax: f32, the product scaled after Q K^T by scale * log2(e), and
//   exponentials in base 2 (one MUFU ex2.approx each, relative error
//   ~2^-22, far below the ~2^-17 at which P enters P V).  Only tiles that cut
//   the causal diagonal, the window's edge or the end of the KV compute and
//   apply a mask; the ~94% of visited tiles wholly inside skip it.
//   Registers: setmaxnreg gives the producer warpgroup 24 registers and each
//   consumer 240 (128 x 24 + 256 x 240 = 64,512 of the SM's 65,536): a
//   consumer holds BK/2 f32 scores, D/2 f32 outputs and BK/2 bf16x2 words of
//   P.  At D = 256 the output alone is 128 registers, which is why the key
//   tile drops to 64 there: 128 + 32 + 32 leave room for the rest.
//   Shared memory: one CTA an SM, 81 KB at D = 64, 161 KB at D = 128, 193 KB
//   at D = 256 (Q 64 KB, two stages of 64-key K and V tiles 128 KB).
//   cuTensorMapEncodeTiled is fetched through cudaGetDriverEntryPoint
//   (hopper.cuh), so the library links no libcuda and the build flags stay
//   those of every source.  At the serving shape the work bounds it: the
//   tensor cores' time for 1.5x the useful FLOP is 0.83 ms; the f32 softmax
//   and the split of P on the CUDA cores, which the ping-pong hides only in
//   part, and each CTA's unoverlapped first and last blocks keep it above that.
//
// flash_fwd_kernel_mma (bfloat16, D = 16, 32 or 96): 64 q rows a CTA, 4
// warps of 16 rows each, the products on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulate), KV tiles of 64 keys staged with plain
// 16-byte loads.
//
// Both tensor-core kernels multiply the bf16 inputs of Q K^T exactly and
// scale the f32 product (as attention_ref does; the TPU kernel scales q
// first, the same value up to the last f32 bit).  P stays f32 for the
// softmax and enters P V as two bf16 halves, hi = bf16(p) and
// lo = bf16(p - hi), so P V keeps ~16 bits of p (error ~2^-17 of p) at twice
// the P V tensor work.  q, k and v rows must start on 16 bytes (the wrapper
// copies a tensor that does not).
//
// flash_fwd_kernel (float32 at every D, and bfloat16 at D = 192): every
// product in f32 on the CUDA cores (bf16 widened when staged), so its
// ceiling is the card's 67 TFLOP/s of f32 FMA.  256 threads; thread (rg, cg)
// owns rows 4rg..4rg+3, score columns 4cg..4cg+3 and D/16 output columns; a
// row's 16 threads are one half-warp, so row max and sum are shuffle
// reductions.  K is staged transposed (kt[d][col]) for Q K^T, then V
// (v[col][d]) in the same buffer; q is scaled in f32 before the product, as
// in the TPU kernel.
//
// Shared memory is dynamic (above the 48 KB static limit), after
// cudaFuncSetAttribute: at most 39 KB for the mma.sync kernel, 87 KB for the
// f32 one at D = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// The log-sum-exp of a row from its max m and sum l of exp(s - m), natural
// units; +inf for a row that keeps no key, so that exp(s - lse) is 0.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : INFINITY;
}

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
                 T* __restrict__ o, float* __restrict__ lse, int hq, int group, int s_len,
                 int skv, long long q_sb, long long q_sh, long long q_ss,
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

  const long long row_base = (static_cast<long long>(b) * hq + h) * s_len + q0;
  T* ob = o + row_base * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (r >= rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = ob + static_cast<long long>(r) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(orow + out_col<D>(j, cg), acc[i][j] / den);
    if (lse != nullptr && cg == 0) lse[row_base + r] = row_lse(m[i], l[i]);
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o, float* lse,
                         int batch, int hq, int hkv, int s_len, int skv, const long long* st,
                         float scale, int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const int bytes = static_cast<int>(Smem<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + kBlockQ - 1) / kBlockQ, hq, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, hq, hq / hkv, s_len, skv, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, causal, window);
  return cudaGetLastError();
}

// f32 at every D; bf16 only at D = 192, where no tensor-core kernel reaches,
// so no other bf16 instantiation is compiled
template <typename T>
cudaError_t launch_head_dim(int d, const void* q, const void* k, const void* v, void* o,
                            float* lse, int batch, int hq, int hkv, int s_len, int skv,
                            const long long* st, float scale, int causal, int window,
                            cudaStream_t stream) {
#define FLASH_CASE(DIM)                                                                        \
  case DIM:                                                                                    \
    return launch_typed<T, DIM>(q, k, v, o, lse, batch, hq, hkv, s_len, skv, st, scale, causal, \
                                window, stream);
  if constexpr (sizeof(T) == sizeof(float)) {
    switch (d) {
      FLASH_CASE(16)
      FLASH_CASE(32)
      FLASH_CASE(64)
      FLASH_CASE(96)
      FLASH_CASE(128)
      FLASH_CASE(256)
      default:
        break;
    }
  }
  switch (d) {
    FLASH_CASE(192)
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
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int hq, int group, int s_len, int skv, long long q_sb, long long q_sh,
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

  const long long row_base = (static_cast<long long>(b) * hq + h) * s_len + q0;
  __nv_bfloat16* ob = o + row_base * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + 8 * i;
    if (r >= rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = ob + static_cast<long long>(r) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
    }
    if (lse != nullptr && t == 0) lse[row_base + r] = row_lse(m[i], l[i]);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int batch, int hq, int hkv, int s_len, int skv, const long long* st,
                       float scale, int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel_mma<D>;
  const int bytes = static_cast<int>(MmaSmem<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + kBlockQ - 1) / kBlockQ, hq, batch);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, hq, hq / hkv,
      s_len, skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal, window);
  return cudaGetLastError();
}

bool uses_mma(int dtype, int d) { return dtype == 1 && (d == 16 || d == 32 || d == 96); }

cudaError_t launch_mma_head_dim(int d, const void* q, const void* k, const void* v, void* o,
                                float* lse, int batch, int hq, int hkv, int s_len, int skv,
                                const long long* st, float scale, int causal, int window,
                                cudaStream_t stream) {
#define FLASH_MMA_CASE(DIM)                                                                   \
  case DIM:                                                                                   \
    return launch_mma<DIM>(q, k, v, o, lse, batch, hq, hkv, s_len, skv, st, scale, causal,    \
                           window, stream);
  switch (d) {
    FLASH_MMA_CASE(16)
    FLASH_MMA_CASE(32)
    FLASH_MMA_CASE(96)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_MMA_CASE
}


// ------------------------------------- Hopper tensor-core (bf16, wgmma) ---

constexpr int kWgBlockQ = 128;       // q rows a CTA: two consumer warpgroups of 64
constexpr int kWgThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kWgStages = 2;         // K/V ring depth
constexpr float kLn2 = 0.6931471805599453f;

// The tiles of the wgmma kernel at head dimension D.  A tile of R rows is
// stored as D/64 column blocks of R rows x 128 bytes (one TMA box each, in
// the 128-byte swizzle), so a column block of Q is 16 KB and one of a K or V
// tile kBK * 128 bytes.
template <int D>
struct WgSmem {
  static constexpr int kBK = D == 256 ? 64 : 128;   // keys a KV tile
  static constexpr int kS = kBK / 2;                // f32 scores a consumer thread holds
  static constexpr int kPSteps = kBK / 16;          // k-steps of P V
  static constexpr int kQBlock = kWgBlockQ * 128;
  static constexpr int kKvBlock = kBK * 128;
  static constexpr int kQTile = (D / 64) * kQBlock;
  static constexpr int kKvTile = (D / 64) * kKvBlock;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kWgStages * kKvTile;
  static constexpr int kBar = kV + kWgStages * kKvTile;
  static constexpr int kBars = 1 + 4 * kWgStages;  // q_full, k_full[], v_full[], k_empty[], v_empty[]
  static constexpr size_t kBytes = kBar + 8 * kBars + 1024;  // + room to align the base
};

// 2^x in one MUFU instruction (relative error ~2^-22; flushes to 0 below
// 2^-126, which is what the -1e30 of a masked score gives).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scale the scores of one KV tile and take each row's max; with kMask, also
// mask them (bit j of `live` says whether score j is kept).
template <bool kMask, int N>
__device__ __forceinline__ void scale_and_max(float (&s)[N], uint64_t& live, float (&mx)[2],
                                              float scale, int pos0, int col0, int skv,
                                              int causal, int window) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if constexpr (kMask) {
      const int row = pos0 + 8 * ((j >> 1) & 1);
      const int col = col0 + (j >> 2) * 8 + (j & 1);
      const bool ok = col < skv && (!causal || col <= row) && (window <= 0 || col > row - window);
      live |= static_cast<uint64_t>(ok) << j;
      s[j] = ok ? s[j] * scale : kNegInf;
    } else {
      s[j] *= scale;
    }
    mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
  }
}

template <bool kMask, int N>
__device__ __forceinline__ void exp_and_sum(float (&s)[N], uint64_t live, const float (&m)[2],
                                            float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = (j >> 1) & 1;
    if constexpr (kMask) {
      s[j] = (live >> j) & 1u ? ex2(s[j] - m[i]) : 0.f;
    } else {
      s[j] = ex2(s[j] - m[i]);
    }
    l[i] += s[j];
  }
}

// Online-softmax step of one KV tile in f32: scale (and, unless the tile is
// whole, mask) the scores, update the row max m and this thread's share of
// the row sum l, and leave p = exp(s - m) in s; alpha rescales the output.
// The scale carries log2(e), so m is in base 2 and p = 2^(s - m).
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], bool whole, float scale,
                                               int pos0, int col0, int skv, int causal,
                                               int window) {
  uint64_t live = 0;
  float mx[2] = {kNegInf, kNegInf};
  if (whole) {
    scale_and_max<false>(s, live, mx, scale, pos0, col0, skv, causal, window);
  } else {
    scale_and_max<true>(s, live, mx, scale, pos0, col0, skv, causal, window);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // a row's 4 threads are one quad
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
  if (whole) {
    exp_and_sum<false>(s, live, m, l);
  } else {
    exp_and_sum<true>(s, live, m, l);
  }
}

// P as bf16 hi and lo halves in the A fragment layout: the accumulator of
// keys 16kk..16kk+15 is k-step kk's A fragment.
template <int K>
__device__ __forceinline__ void split_p(const float (&s)[8 * K], uint32_t (&ph)[K][4],
                                        uint32_t (&pl)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);
    }
  }
}

template <int K>
__device__ __forceinline__ void fence_p(uint32_t (&ph)[K][4], uint32_t (&pl)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    hopper::fence_regs(ph[kk]);
    hopper::fence_regs(pl[kk]);
  }
}

// S = Q K^T of one warpgroup's 64 rows: D/16 k-steps, a k-step 32 bytes into
// a 128-byte swizzled row, each further 64 columns of D one column block on.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[WgSmem<D>::kS], uint32_t q_addr,
                                         uint32_t k_addr) {
  using L = WgSmem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t dq = hopper::make_desc(q_addr + (kk / 4) * L::kQBlock + (kk % 4) * 32, 16, 1024);
    const uint64_t dk = hopper::make_desc(k_addr + (kk / 4) * L::kKvBlock + (kk % 4) * 32, 16, 1024);
    if constexpr (L::kBK == 128) {
      hopper::wgmma_m64n128k16_ss(s, dq, dk, kk > 0);
    } else {
      hopper::wgmma_m64n64k16_ss(s, dq, dk, kk > 0);
    }
  }
}

// acc[64 x N] += A B with A the register fragment `a` (16 of the reduced
// index) and B from shared memory, MN-major (the transpose-B form): N = 64,
// 128, or 256 as two products of 128 columns.  `b_addr` is the k-step's first
// row, `block` the bytes between B's 64-column blocks.
template <int N>
__device__ __forceinline__ void mma_rs(float (&acc)[N / 2], const uint32_t (&a)[4],
                                       uint32_t b_addr, uint32_t block) {
  if constexpr (N == 64) {
    hopper::wgmma_m64n64k16_rs(acc, a, hopper::make_desc(b_addr, block, 1024));
  } else if constexpr (N == 128) {
    hopper::wgmma_m64n128k16_rs(acc, a, hopper::make_desc(b_addr, block, 1024));
  } else {
    static_assert(N == 256, "mma_rs takes N = 64, 128 or 256");
    hopper::wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[64]>(&acc[0]), a,
                                hopper::make_desc(b_addr, block, 1024));
    hopper::wgmma_m64n128k16_rs(*reinterpret_cast<float(*)[64]>(&acc[64]), a,
                                hopper::make_desc(b_addr + 2 * block, block, 1024));
  }
}

// O += P V, P as hi and lo halves: V is [keys, D], MN-major for the
// product; a k-step is 16 keys (2 KB).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&ph)[WgSmem<D>::kPSteps][4],
                                         const uint32_t (&pl)[WgSmem<D>::kPSteps][4],
                                         uint32_t v_addr) {
  using L = WgSmem<D>;
#pragma unroll
  for (int kk = 0; kk < L::kPSteps; ++kk) {
    mma_rs<D>(acc, ph[kk], v_addr + kk * 16 * 128, L::kKvBlock);
    mma_rs<D>(acc, pl[kk], v_addr + kk * 16 * 128, L::kKvBlock);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int hq, int group, int s_len, int skv,
                       float scale, int causal, int window) {
  using L = WgSmem<D>;
  constexpr int kBoxes = D / 64;
  constexpr int kBK = L::kBK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kWgStages;
  uint64_t* k_empty = v_full + kWgStages;
  uint64_t* v_empty = k_empty + kWgStages;

  const int nq = (s_len + kWgBlockQ - 1) / kWgBlockQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = iq * kWgBlockQ;
  const int rows = min(kWgBlockQ, s_len - q0);
  const int q_lo = q0 + (skv - s_len);  // absolute position of the tile's first row
  const int q_hi = q_lo + rows - 1;
  int kt_end = (skv + kBK - 1) / kBK;
  if (causal) kt_end = q_hi >= 0 ? min(kt_end, q_hi / kBK + 1) : 0;
  const int kt_begin = window > 0 ? max(0, q_lo - window + 1) / kBK : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < kWgStages; ++st) {
      hopper::mbar_init(k_full + st, 1);
      hopper::mbar_init(v_full + st, 1);
      hopper::mbar_init(k_empty + st, 8);  // one arrival from each consumer warp
      hopper::mbar_init(v_empty + st, 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the TMA loads ahead ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int hk = h / group;
      hopper::mbar_arrive_expect_tx(q_full, L::kQTile);
      for (int c = 0; c < kBoxes; ++c)
        hopper::tma_load_4d(smem + L::kQ + c * L::kQBlock, &tq, q_full, c * 64, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * kBK;
        unsigned char* ks = smem + L::kK + stage * L::kKvTile;
        unsigned char* vs = smem + L::kV + stage * L::kKvTile;
        hopper::mbar_wait(k_empty + stage, phase ^ 1u);  // the first round passes at once
        hopper::mbar_arrive_expect_tx(k_full + stage, L::kKvTile);
        for (int c = 0; c < kBoxes; ++c)
          hopper::tma_load_4d(ks + c * L::kKvBlock, &tk, k_full + stage, c * 64, k0, hk, b);
        hopper::mbar_wait(v_empty + stage, phase ^ 1u);
        hopper::mbar_arrive_expect_tx(v_full + stage, L::kKvTile);
        for (int c = 0; c < kBoxes; ++c)
          hopper::tma_load_4d(vs + c * L::kKvBlock, &tv, v_full + stage, c * 64, k0, hk, b);
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 q rows each ----
    hopper::setmaxnreg_inc<240>();
    // shuffled from lane 0 so that the compiler sees them warp-uniform and
    // keeps the shared-memory descriptors in uniform registers
    const int cw = __shfl_sync(0xffffffffu, (threadIdx.x >> 7) - 1, 0);
    const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;          // accumulator row group and column pair
    const int r0 = cw * 64 + warp * 16 + g;         // this thread's tile rows r0 and r0 + 8
    const int pos0 = q_lo + r0;
    const int wg_lo = q_lo + cw * 64, wg_hi = wg_lo + 63;
    // this warpgroup's 64 rows start 64 rows (8 KB, a whole number of swizzle atoms) into a block
    const uint32_t q_addr = hopper::smem_addr(smem + L::kQ) + cw * 64 * 128;

    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float s[L::kS];
    uint32_t ph[L::kPSteps][4], pl[L::kPSteps][4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum
    float alpha[2];
    const float scale_log2 = scale * 1.4426950408889634f;  // exponentials in base 2
    auto stage_addr = [&](int base, int st) {
      return hopper::smem_addr(smem + base + st * L::kKvTile);
    };
    // only tiles that cut the causal diagonal, the window's edge or the end
    // of the KV are masked
    auto whole = [&](int k0) {
      return k0 + kBK <= skv && (!causal || k0 + kBK - 1 <= wg_lo) &&
             (window <= 0 || k0 > wg_hi - window);
    };

    // A warpgroup's work on tile j is a block of products, Q K^T of tile j
    // and P V of tile j - 1 (issued together, then waited for), followed by
    // the softmax of tile j on the CUDA cores.  The two warpgroups take turns
    // through named barriers 1 and 2: one issues its block only after the
    // other has issued its own, so one's softmax runs while the other's
    // products keep the tensor cores busy.  Warpgroup 0 goes first; every
    // warpgroup runs n_tiles + 1 blocks (the first holds only Q K^T, the last
    // only P V), and the last arrival of warpgroup 1, which no one would
    // wait for, is left out.
    const int n_tiles = max(kt_end - kt_begin, 0);
    const int my_turn = 1 + cw, their_turn = 2 - cw;
    hopper::mbar_wait(q_full, 0);
    if (n_tiles > 0 && cw == 1) hopper::named_bar_arrive(their_turn, 256);
    for (int j = 0; j <= n_tiles && n_tiles > 0; ++j) {
      const bool qk = j < n_tiles, pv = j > 0;
      const int stage = j % kWgStages, prev = (j + kWgStages - 1) % kWgStages;
      if (qk) hopper::mbar_wait(k_full + stage, (j / kWgStages) & 1u);
      if (pv) hopper::mbar_wait(v_full + prev, ((j - 1) / kWgStages) & 1u);
      hopper::named_bar_sync(my_turn, 256);
      hopper::fence_regs(s);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      if (qk) issue_qk<D>(s, q_addr, stage_addr(L::kK, stage));
      if (pv) issue_pv<D>(acc, ph, pl, stage_addr(L::kV, prev));
      hopper::wgmma_commit();
      if (cw == 0 || j < n_tiles) hopper::named_bar_arrive(their_turn, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(acc);
      fence_p(ph, pl);
      __syncwarp();
      if (lane == 0) {  // K of tile j and V of tile j - 1 are free
        if (qk) hopper::mbar_arrive(k_empty + stage);
        if (pv) hopper::mbar_arrive(v_empty + prev);
      }
      if (qk) {
        const int k0 = (kt_begin + j) * kBK;
        online_softmax(s, m, l, alpha, whole(k0), scale_log2, pos0, k0 + 2 * t, skv, causal,
                       window);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        split_p(s, ph, pl);
      }
    }

    const long long row_base = (static_cast<long long>(b) * hq + h) * s_len + q0;
    __nv_bfloat16* ob = o + row_base * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int r = r0 + 8 * i;
      if (r >= rows) continue;
      const float den = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = ob + static_cast<long long>(r) * D + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) = __floats2bfloat162_rn(
            acc[dt * 4 + 2 * i] / den, acc[dt * 4 + 2 * i + 1] / den);
      }
      // m is in base 2: lse = (m + log2 l) ln 2; a row that keeps no key gets +inf
      if (lse != nullptr && t == 0)
        lse[row_base + r] = l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : INFINITY;
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                 int hq, int hkv, int s_len, int skv, const long long* st, float scale,
                 int causal, int window, cudaStream_t stream) {
  using L = WgSmem<D>;
  CUtensorMap tq, tk, tv;
  int rc = hopper::encode_map(&tq, q, D, s_len, hq, batch, st[0], st[1], st[2], kWgBlockQ);
  if (rc == 0) rc = hopper::encode_map(&tk, k, D, skv, hkv, batch, st[3], st[4], st[5], L::kBK);
  if (rc == 0) rc = hopper::encode_map(&tv, v, D, skv, hkv, batch, st[6], st[7], st[8], L::kBK);
  if (rc != 0) return rc;
  auto kernel = flash_fwd_kernel_wgmma<D>;
  const int bytes = static_cast<int>(L::kBytes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_len + kWgBlockQ - 1) / kWgBlockQ, hq, batch);
  kernel<<<grid, kWgThreads, bytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse,
                                              hq, hq / hkv, s_len, skv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

bool uses_wgmma(int dtype, int d) { return dtype == 1 && (d == 64 || d == 128 || d == 256); }

}  // namespace

// 1 when the kernel is compiled for head dimension d.
extern "C" int flash_attention_supports(int d) {
  return d == 16 || d == 32 || d == 64 || d == 96 || d == 128 || d == 192 || d == 256;
}

// Byte alignment that every row start of q, k and v needs (base pointer and
// every batch, head and seq stride): 16 on the tensor-core paths (the TMA's
// rule for global addresses and strides on the wgmma path), else the
// element size.
extern "C" int flash_attention_row_align(int dtype, int d) {
  return uses_wgmma(dtype, d) || uses_mma(dtype, d) ? 16 : (dtype == 0 ? 4 : 2);
}

// Dynamic shared memory, in bytes, of a CTA of the wgmma kernel at head
// dimension d; 0 where bf16 at d does not run it.
extern "C" int flash_attention_wgmma_smem_bytes(int d) {
  return d == 256   ? static_cast<int>(WgSmem<256>::kBytes)
         : d == 128 ? static_cast<int>(WgSmem<128>::kBytes)
         : d == 64  ? static_cast<int>(WgSmem<64>::kBytes)
                    : 0;
}

// Launch on `stream`.  dtype 0 is float32, 1 is bfloat16 (q, k, v and o alike).
// strides holds (batch, head, seq) element strides of q, k and v in that order;
// the last dimension of each is contiguous.  o is a contiguous [B, Hq, S, D].
// lse, when not null, is a contiguous f32 [B, Hq, S] that receives each row's
// log-sum-exp of the scaled, masked scores (natural log; +inf for a row that
// keeps no key); with null nothing more is written.  Returns cudaGetLastError()
// after the launch, or a tensor-map error code (kTensorMapError + CUresult,
// kNoEncoder) from the wgmma path.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int dtype, int batch, int hq, int hkv,
                                      int s_len, int skv, int d, const long long* strides,
                                      float scale, int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || hq == 0 || s_len == 0) return static_cast<int>(cudaSuccess);
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (uses_wgmma(dtype, d)) {
#define FLASH_WG_CASE(DIM)                                                                    \
  case DIM:                                                                                   \
    return launch_wgmma<DIM>(q, k, v, o, lse, batch, hq, hkv, s_len, skv, strides, scale,     \
                             causal, window, st);
    switch (d) {
      FLASH_WG_CASE(64)
      FLASH_WG_CASE(128)
      FLASH_WG_CASE(256)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FLASH_WG_CASE
  }
  cudaError_t err =
      uses_mma(dtype, d)
      ? launch_mma_head_dim(d, q, k, v, o, lse, batch, hq, hkv, s_len, skv, strides, scale,
                            causal, window, st)
      : dtype == 0
      ? launch_head_dim<float>(d, q, k, v, o, lse, batch, hq, hkv, s_len, skv, strides, scale,
                               causal, window, st)
      : launch_head_dim<__nv_bfloat16>(d, q, k, v, o, lse, batch, hq, hkv, s_len, skv, strides,
                                       scale, causal, window, st);
  return static_cast<int>(err);
}
