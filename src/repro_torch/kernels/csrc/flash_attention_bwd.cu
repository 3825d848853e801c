// Flash-attention backward for Hopper (sm_90a): the FlashAttention-2
// gradient of the unsegmented causal / sliding-window attention.
//
// Replaces the two Pallas TPU kernels of the JAX package's
// src/repro/kernels/flash_attention_bwd.py::_flash_bwd:
//   * _dq_kernel  -> the dq kernels:  dq = sum_kv ds k;
//   * _dkv_kernel -> the dkv kernels: dv = sum p^T dO, dk = sum ds^T q,
//     summed over the q tiles and over every q head of the kv head's GQA
//     group, so dk and dv land in the kv-head layout.
// With p = exp(s * scale - lse) inside the mask (0 outside: the mask is
// applied before the multiply, so a row whose lse is NEG_INF gives
// p = 0), ds = p (dO v^T - D) scale and D = rowsum(dO o), fp32. D is the
// jnp reduction outside the TPU kernels; here the dq kernel computes it in
// its prologue (it reads dO for the same rows anyway) and writes it for
// the dkv kernel, launched after it on the same stream.
//
// The dtype picks the body; there is no switch and no fallback between
// the two:
//   * bfloat16 -> attn_bwd_dq_wgmma, attn_bwd_dkv_wgmma: all four tile
//     products on the tensor cores (wgmma), operands fed by TMA (below);
//   * float32  -> attn_bwd_dq_kernel, attn_bwd_dkv_kernel: scalar fp32
//     FMA. wgmma has no fp32 operands, only TF32 (about 3 decimal
//     digits), which would not hold the fp32 gradient checks (2e-5).
//
// What bounds it on the card. At the training main path (B=2, S=512,
// H=16, KV=8, hd=128, causal, bf16) each kernel moves ~17-21 MB and does
// 6 (dq) or 8 (dkv) FLOPs per valid (q, k) pair and head dimension, ~4 GFLOP:
// the bound is the memory (~5-6 us at 3.35 TB/s), a little above the
// tensor-core FLOP bound (~3-4 us). Every body stages its fixed operand
// (the q and dO tile for dq; the k and v tile for dkv) in shared memory
// once and streams the other side's tiles past it; scores, p and ds never
// touch device memory; tiles wholly past the causal frontier or outside
// the window are never loaded (the TPU kernels visit them and mask);
// tensors are read in the JAX layout (B, S, heads, hd) through strides,
// so no transpose copy is made. Each output element is owned by one
// thread of one block: no atomics, so the result is deterministic.
//
// The bf16 bodies: one warpgroup (128 threads) per block, every tile 64
// rows; TMA tensor maps over (hd, heads, S, B) with the caller's strides
// (hopper.cuh), a 2-stage mbarrier ring for the streamed tiles, thread 0
// issuing the next step's loads while the current step's first two
// products run. In the accumulator fragment a thread holds rows 16w +
// l/4 (+8) and columns 8j + 2(l%4) + {0,1} (hopper.cuh); p and ds are
// formed there in fp32, rounded to bf16 pairs and fed as the register A
// operand of the next products, so neither touches shared memory. The
// exponentials run on the SFU (ex2.approx.ftz, the scale folded into log2
// units). Only tiles on the causal diagonal, a window edge or the ragged
// edge test the mask, branch-free per element; the others skip it.
//   dq:  one block per (64-row q tile, b*h), longest q tiles first. TMA
//        loads the q and dO tiles once; the prologue computes D for the
//        tile's rows from dO and o (global, 16-byte loads) and writes it.
//        Per kv tile: S = Q K^T and dP = dO V^T (m64n64k16, both operands
//        K-major), P and dS on the fragment, dQ += dS K with k read
//        MN-major (m64n{hd}k16). dq = scale * dQ, rows < Sq stored.
//   dkv: one block per (64-row kv tile, b*kv head), kv tiles in order
//        (under causal, tile 0 sees every q tile). TMA loads the k and v
//        tiles once; per (q head of the group, q tile) step the ring
//        brings the q and dO tiles, and the block stages that tile's 64
//        lse and D values in shared memory. S^T = K Q^T and dP^T = V dO^T
//        (K-major), P^T and dS^T on the fragment (lse and D per column),
//        dV += P^T dO and dK += dS^T Q with the dO and q tiles read
//        MN-major from the same shared tiles. dk = scale * dK.
//
// The fp32 bodies, 128 threads laid out 16 (ty) x 8 (tx), fp32 scalar
// FMA:
//   dq:  one block per (64-row q tile, b*h); kv tiles of 32 columns. A
//        thread owns 4 q rows x 4 kv columns of the score tile and 4 q rows
//        x hd/8 columns (tx + 8j) of dq, in registers.
//   dkv: one block per (64-row kv tile, b*kv); for each q head of the
//        group, q tiles of 32 columns. A thread owns 4 kv rows x 4 q
//        columns of the (transposed) score tile and 4 kv rows x hd/8
//        columns of dk and dv, in registers.
// Rows past S and columns past S are masked (the TPU wrappers need S to
// be a multiple of the block; TMA reads rows past S as zeros). Positions
// are implicit and top-left aligned: q row i is position i, kv row j
// position j.
//
// C entry points: flash_attention_bwd_dq(...) and
// flash_attention_bwd_dkv(...) launch on the given stream and return
// cudaGetLastError() as an int (0 = launched).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 128;
constexpr int RPT = 4;        // rows per thread (16 ty x 4 = 64 rows)
constexpr int BR = 16 * RPT;  // rows of the block's fixed tile
constexpr int BC = 32;        // columns of each streamed tile
constexpr int CPT = BC / 8;   // score columns per thread
constexpr int CP = BC + 1;    // pitch of a transposed streamed tile
constexpr int PP = BC + 2;    // pitch of the p / ds tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // dq only
  const void* dO;
  const float* lse;  // (B, H, Sq) contiguous
  float* D;          // (B, H, Sq) contiguous: written by dq, read by dkv
  void* dq;          // (B, Sq, H, hd) contiguous
  void* dk;          // (B, Sk, KV, hd) contiguous
  void* dv;
  int B, Sq, Sk, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  float scale;
  int causal;
  int window;
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ bool visible(int qp, int kp, const Params& p) {
  return (!p.causal || kp <= qp) && (p.window <= 0 || qp - kp < p.window);
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// ---------------------------------------------------------------------------
// float32, dq: one block per (q tile, b * H + h)
// ---------------------------------------------------------------------------

template <int HD>
constexpr int dq_smem_bytes() {
  return (2 * HD * BR + 2 * HD * CP + BR * PP + 2 * BR) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) attn_bwd_dq_kernel(Params p) {
  constexpr int CJ = HD / 8;   // dq columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                // [HD][BR]  q tile, transposed
  float* sDO = sQ + HD * BR;       // [HD][BR]  dO tile, transposed
  float* sKT = sDO + HD * BR;      // [HD][CP]  k tile, transposed
  float* sVT = sKT + HD * CP;      // [HD][CP]  v tile, transposed
  float* sDS = sVT + HD * CP;      // [BR][PP]  ds
  float* sL = sDS + BR * PP;       // [BR]      lse
  float* sD = sL + BR;             // [BR]      D

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int q0 = blockIdx.x * BR;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int g = h / (p.H / p.KV);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dO = static_cast<const T*>(p.dO) + b * p.do_sb + h * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;

  for (int i = tid; i < BR * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int qr = q0 + r;
    const bool in = qr < p.Sq;
    sQ[d * BR + r] = in ? to_f(q[qr * p.q_ss + d]) : 0.f;
    sDO[d * BR + r] = in ? to_f(dO[qr * p.do_ss + d]) : 0.f;
  }
  __syncthreads();

  // prologue: D = rowsum(dO o) for this tile's rows; the 8 lanes of a row
  // split its columns
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int rl = ty * RPT + i;
    const int r = q0 + rl;
    float s = 0.f;
    if (r < p.Sq) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int d = tx + 8 * j;
        s = fmaf(sDO[d * BR + rl], to_f(o[r * p.o_ss + d]), s);
      }
    }
    s = row_sum8(s);
    if (tx == 0) {
      sD[rl] = s;
      sL[rl] = r < p.Sq ? p.lse[row0 + r] : 0.f;
      if (r < p.Sq) p.D[row0 + r] = s;
    }
  }

  float acc[RPT][CJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  // kv range this q tile can see: from the window's first column to the
  // causal frontier of its last real row
  const int q_last = min(q0 + BR, p.Sq) - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;   // exclusive
  const int t_lo = k_lo / BC;
  const int t_hi = (k_hi + BC - 1) / BC;
  __syncthreads();

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BC;
    for (int i = tid; i < BC * HD; i += NT) {
      const int c = i / HD, d = i % HD;
      const int kc = k0 + c;
      const bool in = kc < p.Sk;
      sKT[d * CP + c] = in ? to_f(k[kc * p.k_ss + d]) : 0.f;
      sVT[d * CP + c] = in ? to_f(v[kc * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // s = q k^T and dp = dO v^T for 4 rows x 4 columns a thread
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&sQ[d * BR + ty * RPT]);
      const float4 ov = *reinterpret_cast<const float4*>(&sDO[d * BR + ty * RPT]);
      const float qa[RPT] = {qv.x, qv.y, qv.z, qv.w};
      const float oa[RPT] = {ov.x, ov.y, ov.z, ov.w};
      float kv[CPT], vv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = sKT[d * CP + tx + 8 * j];
        vv[j] = sVT[d * CP + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int rl = ty * RPT + i;
      const int r = q0 + rl;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int cl = tx + 8 * j;
        const int c = k0 + cl;
        const bool ok = r < p.Sq && c < p.Sk && visible(r, c, p);
        const float pij = ok ? expf(s[i][j] * p.scale - sL[rl]) : 0.f;
        sDS[rl * PP + cl] = pij * (dp[i][j] - sD[rl]) * p.scale;
      }
    }
    __syncthreads();

    // dq += ds k
#pragma unroll 4
    for (int c = 0; c < BC; ++c) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = sDS[(ty * RPT + i) * PP + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float kk = sKT[(tx + 8 * j) * CP + c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* dq = static_cast<T*>(p.dq) +
          (static_cast<long long>(b) * p.Sq * p.H + h) * HD;
  const long long dq_ss = static_cast<long long>(p.H) * HD;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    if (r >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      dq[r * dq_ss + tx + 8 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// float32, dk and dv: one block per (kv tile, b * KV + kv head)
// ---------------------------------------------------------------------------

template <int HD>
constexpr int dkv_smem_bytes() {
  return (2 * HD * BR + 2 * HD * CP + 2 * BR * PP + 2 * BC) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) attn_bwd_dkv_kernel(Params p) {
  constexpr int CJ = HD / 8;   // dk / dv columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                // [HD][BR]  k tile, transposed
  float* sV = sK + HD * BR;        // [HD][BR]  v tile, transposed
  float* sQT = sV + HD * BR;       // [HD][CP]  q tile, transposed
  float* sOT = sQT + HD * CP;      // [HD][CP]  dO tile, transposed
  float* sP = sOT + HD * CP;       // [BR][PP]  p^T
  float* sDS = sP + BR * PP;       // [BR][PP]  ds^T
  float* sL = sDS + BR * PP;       // [BC]      lse
  float* sD = sL + BC;             // [BC]      D

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int k0 = blockIdx.x * BR;
  const int b = blockIdx.y / p.KV;
  const int g = blockIdx.y % p.KV;
  const int group = p.H / p.KV;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;

  for (int i = tid; i < BR * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int kr = k0 + r;
    const bool in = kr < p.Sk;
    sK[d * BR + r] = in ? to_f(k[kr * p.k_ss + d]) : 0.f;
    sV[d * BR + r] = in ? to_f(v[kr * p.v_ss + d]) : 0.f;
  }

  float dk[RPT][CJ], dv[RPT][CJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // q range that can see this kv tile: from the causal frontier of its
  // first column to the window's edge past its last real column
  const int k_last = min(k0 + BR, p.Sk) - 1;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
  const int t_lo = q_lo / BC;
  const int t_hi = (q_hi + BC - 1) / BC;

  for (int hh = 0; hh < group; ++hh) {
    const int h = g * group + hh;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dO = static_cast<const T*>(p.dO) + b * p.do_sb + h * p.do_sh;
    const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * BC;
      __syncthreads();   // the previous step's tiles are consumed
      for (int i = tid; i < BC * HD; i += NT) {
        const int c = i / HD, d = i % HD;
        const int qc = q0 + c;
        const bool in = qc < p.Sq;
        sQT[d * CP + c] = in ? to_f(q[qc * p.q_ss + d]) : 0.f;
        sOT[d * CP + c] = in ? to_f(dO[qc * p.do_ss + d]) : 0.f;
      }
      for (int c = tid; c < BC; c += NT) {
        const bool in = q0 + c < p.Sq;
        sL[c] = in ? p.lse[row0 + q0 + c] : 0.f;
        sD[c] = in ? p.D[row0 + q0 + c] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v dO^T for 4 kv rows x 4 q columns a thread
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float4 kv4 = *reinterpret_cast<const float4*>(&sK[d * BR + ty * RPT]);
        const float4 vv4 = *reinterpret_cast<const float4*>(&sV[d * BR + ty * RPT]);
        const float ka[RPT] = {kv4.x, kv4.y, kv4.z, kv4.w};
        const float va[RPT] = {vv4.x, vv4.y, vv4.z, vv4.w};
        float qv[CPT], ov[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qv[j] = sQT[d * CP + tx + 8 * j];
          ov[j] = sOT[d * CP + tx + 8 * j];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            s[i][j] = fmaf(ka[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(va[i], ov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int rl = ty * RPT + i;
        const int kr = k0 + rl;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int cl = tx + 8 * j;
          const int qc = q0 + cl;
          const bool ok = kr < p.Sk && qc < p.Sq && visible(qc, kr, p);
          const float pij = ok ? expf(s[i][j] * p.scale - sL[cl]) : 0.f;
          sP[rl * PP + cl] = pij;
          sDS[rl * PP + cl] = pij * (dp[i][j] - sD[cl]) * p.scale;
        }
      }
      __syncthreads();

      // dv += p^T dO, dk += ds^T q
#pragma unroll 2
      for (int c = 0; c < BC; ++c) {
        float pv[RPT], dsv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = sP[(ty * RPT + i) * PP + c];
          dsv[i] = sDS[(ty * RPT + i) * PP + c];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const float oo = sOT[(tx + 8 * j) * CP + c];
          const float qq = sQT[(tx + 8 * j) * CP + c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            dv[i][j] = fmaf(pv[i], oo, dv[i][j]);
            dk[i][j] = fmaf(dsv[i], qq, dk[i][j]);
          }
        }
      }
    }
  }

  const long long base = (static_cast<long long>(b) * p.Sk * p.KV + g) * HD;
  const long long ss = static_cast<long long>(p.KV) * HD;
  T* dkp = static_cast<T*>(p.dk) + base;
  T* dvp = static_cast<T*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kr = k0 + ty * RPT + i;
    if (kr >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      dkp[kr * ss + tx + 8 * j] = from_f<T>(dk[i][j]);
      dvp[kr * ss + tx + 8 * j] = from_f<T>(dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 launch
// ---------------------------------------------------------------------------

template <typename T, int HD>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BR - 1) / BR, p.B * p.H);
  attn_bwd_dq_kernel<T, HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + BR - 1) / BR, p.B * p.KV);
  attn_bwd_dkv_kernel<T, HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Params& p, int hd, bool dkv, cudaStream_t s) {
  switch (hd) {
    case 32: return dkv ? launch_dkv<T, 32>(p, s) : launch_dq<T, 32>(p, s);
    case 64: return dkv ? launch_dkv<T, 64>(p, s) : launch_dq<T, 64>(p, s);
    case 128: return dkv ? launch_dkv<T, 128>(p, s) : launch_dq<T, 128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int BT = 64;        // rows of every tile: one m64 wgmma tile
constexpr int NT = 128;       // one warpgroup
constexpr int STAGES = 2;     // ring depth of the streamed tiles
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Geo : Swz<HD> {
  static constexpr int TILE = BT * HD * 2;   // one 64-row bf16 tile
  // 1024 bytes of slack to align the tiles to the swizzle atom, the two
  // fixed tiles, the ring (two tiles a stage), the 1 + STAGES mbarriers,
  // and (dkv) each stage's 64 lse and 64 D values
  static constexpr int SMEM =
      1024 + 2 * TILE + STAGES * 2 * TILE + 64 + STAGES * 2 * BT * 4;
};

// s + a . b over 8 bf16 pairs (two 16-byte loads)
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b,
                                      float s) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]);
    const float2 fy = __bfloat1622float2(y[i]);
    s = fmaf(fx.x, fy.x, s);
    s = fmaf(fx.y, fy.y, s);
  }
  return s;
}

template <int HD>
__global__ void __launch_bounds__(NT, 1) attn_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tmq,
    const __grid_constant__ CUtensorMap tmk,
    const __grid_constant__ CUtensorMap tmv,
    const __grid_constant__ CUtensorMap tmdo, const Params p) {
  using G = Geo<HD>;
  constexpr int NA = HD / 2;    // dq accumulator floats per thread
  constexpr int NS = BT / 2;    // S and dP floats per thread
  constexpr int KS = BT / 16;   // k16 slices of dS K
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sDO = sQ + G::TILE;
  const uint32_t sKV = sDO + G::TILE;    // stage s: k, then v
  const uint32_t bars = sKV + STAGES * 2 * G::TILE;  // q and dO, stage 0, 1

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;   // longest tiles first
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int g = h / (p.H / p.KV);

  // kv range this q tile can see: from the window's first column to the
  // causal frontier of its last real row
  const int q_last = min(q0 + BT, p.Sq) - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;   // exclusive
  const int t_lo = k_lo / BT;
  const int t_hi = (k_hi + BT - 1) / BT;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_map(&tmq);
    prefetch_map(&tmk);
    prefetch_map(&tmv);
    prefetch_map(&tmdo);
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, 2 * G::TILE);
    load_tile<HD>(sQ, &tmq, bars, h, q0, b, BT);
    load_tile<HD>(sDO, &tmdo, bars, h, q0, b, BT);
    if (t_lo < t_hi) {
      mbar_expect_tx(bars + 8, 2 * G::TILE);
      load_tile<HD>(sKV, &tmk, bars + 8, g, t_lo * BT, b, BT);
      load_tile<HD>(sKV + G::TILE, &tmv, bars + 8, g, t_lo * BT, b, BT);
    }
  }

  // prologue, while the tiles load: D = rowsum(dO o) and lse (log2 units)
  // of this thread's rows rl and rl + 8; the 4 lanes of a quad split the
  // columns
  const int rl = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
  const __nv_bfloat16* o =
      static_cast<const __nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const __nv_bfloat16* dO =
      static_cast<const __nv_bfloat16*>(p.dO) + b * p.do_sb + h * p.do_sh;
  float dr[2], lr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = q0 + rl + 8 * rr;
    float d = 0.f;
    if (r < p.Sq) {
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) {
        const int c = 32 * i + 4 * cq;
        d = dot8(*reinterpret_cast<const uint4*>(o + r * p.o_ss + c),
                 *reinterpret_cast<const uint4*>(dO + r * p.do_ss + c), d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    dr[rr] = d;
    lr[rr] = r < p.Sq ? p.lse[row0 + r] * LOG2E : 0.f;
    if ((lane & 3) == 0 && r < p.Sq) p.D[row0 + r] = d;
  }

  float acc[NA], s[NS], dp[NS];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
  const float sl2 = p.scale * LOG2E;   // scores in log2 units
  mbar_wait(bars, 0);

  for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
    const int st = it % STAGES;
    mbar_wait(bars + 8 * (1 + st), (it / STAGES) & 1);
    const uint32_t sK = sKV + st * 2 * G::TILE;
    const uint32_t sV = sK + G::TILE;

    // S = Q K^T and dP = dO V^T
    reg_fence(s);
    reg_fence(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<HD, BT>(sQ, kk),
                   kmajor_desc<HD, BT>(sK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc<HD, BT>(sDO, kk),
                   kmajor_desc<HD, BT>(sV, kk), kk > 0);
    wg_commit();
    if (tid == 0 && t + 1 < t_hi) {
      // tile t + 1 into the stage tile t - 1 used: every warp left it at
      // the barrier that ended that step
      const int sn = (it + 1) % STAGES;
      const uint32_t bar = bars + 8 * (1 + sn);
      const uint32_t dst = sKV + sn * 2 * G::TILE;
      mbar_expect_tx(bar, 2 * G::TILE);
      load_tile<HD>(dst, &tmk, bar, g, (t + 1) * BT, b, BT);
      load_tile<HD>(dst + G::TILE, &tmv, bar, g, (t + 1) * BT, b, BT);
    }
    wg_wait0();
    reg_fence(s);
    reg_fence(dp);

    // P = exp(S scale - lse), then 0 where masked (only where the tile
    // needs it): a select, so an inf from a row whose lse is NEG_INF
    // never reaches a product
    const int k0 = t * BT;
    const bool need_mask = k0 + BT > p.Sk ||
                           (p.causal && k0 + BT - 1 > q0) ||
                           (p.window > 0 && q0 + BT - 1 - k0 >= p.window);
#pragma unroll
    for (int x = 0; x < NS; ++x)
      s[x] = exp2_ftz(fmaf(s[x], sl2, -lr[(x >> 1) & 1]));
    if (need_mask) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = q0 + rl + 8 * rr;
        const int hi = p.causal ? min(p.Sk - 1, r) : p.Sk - 1;
        const int lo = p.window > 0 ? r - p.window + 1 : INT_MIN;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = k0 + 8 * j + cq + e;
            const int x = 4 * j + 2 * rr + e;
            s[x] = (c >= lo) & (c <= hi) ? s[x] : 0.f;
          }
      }
    }

    // dS / scale = P (dP - D), packed to bf16 as the A operand of
    // dQ += dS K: slice kk takes columns 16kk..16kk+15, s[8kk .. 8kk+7]
    uint32_t da[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = 8 * kk + 2 * i;
        const float d = dr[i & 1];
        da[kk][i] = pack_bf16(s[x] * (dp[x] - d), s[x + 1] * (dp[x + 1] - d));
      }
    reg_fence(acc);
    reg_fence(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_pv<HD>(acc, da[kk], vdesc<HD, BT>(sK, kk));
    wg_commit();
    wg_wait0();
    reg_fence(acc);
    reg_fence(da);
    __syncthreads();   // the stage is free for the load of tile t + 2
  }

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.dq) +
                      (static_cast<long long>(b) * p.Sq * p.H + h) * HD;
  const long long dq_ss = static_cast<long long>(p.H) * HD;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = q0 + rl + 8 * rr;
    if (r >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < NA / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq + r * dq_ss + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * rr] * p.scale,
                                acc[4 * j + 2 * rr + 1] * p.scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 1) attn_bwd_dkv_wgmma(
    const __grid_constant__ CUtensorMap tmq,
    const __grid_constant__ CUtensorMap tmk,
    const __grid_constant__ CUtensorMap tmv,
    const __grid_constant__ CUtensorMap tmdo, const Params p) {
  using G = Geo<HD>;
  constexpr int NA = HD / 2;    // dk, dv accumulator floats per thread
  constexpr int NS = BT / 2;    // S^T and dP^T floats per thread
  constexpr int KS = BT / 16;   // k16 slices of the second products
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + G::TILE;
  const uint32_t sQD = sV + G::TILE;     // stage s: q, then dO
  const uint32_t bars = sQD + STAGES * 2 * G::TILE;  // k and v, stage 0, 1
  // stage s: lse (log2 units) [BT], then D [BT]
  float* sLD = reinterpret_cast<float*>(smem_raw + (bars + 64 -
                                                    smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * BT;
  const int b = blockIdx.y / p.KV;
  const int g = blockIdx.y % p.KV;
  const int group = p.H / p.KV;

  // q range that can see this kv tile: from the causal frontier of its
  // first column to the window's edge past its last real column; the
  // block's steps walk (q head of the group, q tile) in that range
  const int k_last = min(k0 + BT, p.Sk) - 1;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
  const int t_lo = q_lo / BT;
  const int nt = max(0, (q_hi + BT - 1) / BT - t_lo);
  const int n = group * nt;
  auto step = [&](int it, int& h, int& q0) {
    h = g * group + it / nt;
    q0 = (t_lo + it % nt) * BT;
  };
  // lse and D of step it into its stage's slot: threads 0-63 lse, 64-127
  // D, 0 past Sq
  auto stage_rows = [&](int it) {
    int h, q0;
    step(it, h, q0);
    const int c = tid & (BT - 1);
    const long long i = (static_cast<long long>(b) * p.H + h) * p.Sq + q0 + c;
    float x = 0.f;
    if (q0 + c < p.Sq) x = tid < BT ? p.lse[i] * LOG2E : p.D[i];
    sLD[(it % STAGES) * 2 * BT + tid] = x;
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_map(&tmq);
    prefetch_map(&tmk);
    prefetch_map(&tmv);
    prefetch_map(&tmdo);
  }
  if (n > 0) stage_rows(0);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, 2 * G::TILE);
    load_tile<HD>(sK, &tmk, bars, g, k0, b, BT);
    load_tile<HD>(sV, &tmv, bars, g, k0, b, BT);
    if (n > 0) {
      int h, q0;
      step(0, h, q0);
      mbar_expect_tx(bars + 8, 2 * G::TILE);
      load_tile<HD>(sQD, &tmq, bars + 8, h, q0, b, BT);
      load_tile<HD>(sQD + G::TILE, &tmdo, bars + 8, h, q0, b, BT);
    }
  }

  const int rl = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float dk[NA], dv[NA], s[NS], dp[NS];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
  const float sl2 = p.scale * LOG2E;   // scores in log2 units
  mbar_wait(bars, 0);

  for (int it = 0; it < n; ++it) {
    int h, q0;
    step(it, h, q0);
    const int st = it % STAGES;
    mbar_wait(bars + 8 * (1 + st), (it / STAGES) & 1);
    const uint32_t sQ = sQD + st * 2 * G::TILE;
    const uint32_t sDO = sQ + G::TILE;

    // S^T = K Q^T and dP^T = V dO^T
    reg_fence(s);
    reg_fence(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<HD, BT>(sK, kk),
                   kmajor_desc<HD, BT>(sQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc<HD, BT>(sV, kk),
                   kmajor_desc<HD, BT>(sDO, kk), kk > 0);
    wg_commit();
    if (it + 1 < n) {
      // step it + 1 into the stage step it - 1 used: every warp left it
      // (and its lse / D slot) at the barrier that ended that step
      if (tid == 0) {
        int hn, qn;
        step(it + 1, hn, qn);
        const int sn = (it + 1) % STAGES;
        const uint32_t bar = bars + 8 * (1 + sn);
        const uint32_t dst = sQD + sn * 2 * G::TILE;
        mbar_expect_tx(bar, 2 * G::TILE);
        load_tile<HD>(dst, &tmq, bar, hn, qn, b, BT);
        load_tile<HD>(dst + G::TILE, &tmdo, bar, hn, qn, b, BT);
      }
      stage_rows(it + 1);
    }
    wg_wait0();
    reg_fence(s);
    reg_fence(dp);

    // P^T = exp(S^T scale - lse), lse per column (q row q0 + 8j + cq + e),
    // then 0 where masked (only where the tile needs it), by a select
    const float* L = sLD + st * 2 * BT;
    const float* Dv = L + BT;
    const bool need_mask = q0 + BT > p.Sq ||
                           (p.causal && k0 + BT - 1 > q0) ||
                           (p.window > 0 && q0 + BT - 1 - k0 >= p.window);
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(L + 8 * j + cq);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int x = 4 * j + 2 * rr;
        s[x] = exp2_ftz(fmaf(s[x], sl2, -l2.x));
        s[x + 1] = exp2_ftz(fmaf(s[x + 1], sl2, -l2.y));
      }
    }
    if (need_mask) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int kr = k0 + rl + 8 * rr;
        const int lo = p.causal ? kr : INT_MIN;
        const int hi =
            min(p.Sq - 1, p.window > 0 ? kr + p.window - 1 : INT_MAX);
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = q0 + 8 * j + cq + e;
            const int x = 4 * j + 2 * rr + e;
            s[x] = (c >= lo) & (c <= hi) ? s[x] : 0.f;
          }
      }
    }

    // P^T and dS^T / scale = P^T (dP^T - D) packed to bf16: the A
    // operands of dV += P^T dO and dK += dS^T Q, slice kk the q rows
    // 16kk..16kk+15, read MN-major from the dO and q tiles
    uint32_t pa[KS][4], da[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = 8 * kk + 2 * i;
        const float2 d2 = *reinterpret_cast<const float2*>(
            Dv + 8 * (2 * kk + (i >> 1)) + cq);
        pa[kk][i] = pack_bf16(s[x], s[x + 1]);
        da[kk][i] = pack_bf16(s[x] * (dp[x] - d2.x),
                              s[x + 1] * (dp[x + 1] - d2.y));
      }
    reg_fence(dv);
    reg_fence(dk);
    reg_fence(pa);
    reg_fence(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_pv<HD>(dv, pa[kk], vdesc<HD, BT>(sDO, kk));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_pv<HD>(dk, da[kk], vdesc<HD, BT>(sQ, kk));
    wg_commit();
    wg_wait0();
    reg_fence(dv);
    reg_fence(dk);
    reg_fence(pa);
    reg_fence(da);
    __syncthreads();   // the stage is free for the loads of step it + 2
  }

  const long long base = (static_cast<long long>(b) * p.Sk * p.KV + g) * HD;
  const long long ss = static_cast<long long>(p.KV) * HD;
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + base;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + base;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kr = k0 + rl + 8 * rr;
    if (kr >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < NA / 4; ++j) {
      const int x = 4 * j + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(dkp + kr * ss + 8 * j + cq) =
          __floats2bfloat162_rn(dk[x] * p.scale, dk[x + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + kr * ss + 8 * j + cq) =
          __floats2bfloat162_rn(dv[x], dv[x + 1]);
    }
  }
}

template <int HD>
cudaError_t launch(const Params& p, bool dkv, cudaStream_t stream) {
  using G = Geo<HD>;
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map<HD>(encode, &mq, p.q, p.Sq, p.H, p.B, p.q_sb, p.q_ss,
                    p.q_sh, BT) ||
      !make_map<HD>(encode, &mdo, p.dO, p.Sq, p.H, p.B, p.do_sb, p.do_ss,
                    p.do_sh, BT) ||
      !make_map<HD>(encode, &mk, p.k, p.Sk, p.KV, p.B, p.k_sb, p.k_ss,
                    p.k_sh, BT) ||
      !make_map<HD>(encode, &mv, p.v, p.Sk, p.KV, p.B, p.v_sb, p.v_ss,
                    p.v_sh, BT))
    return cudaErrorInvalidValue;
  const auto kernel = dkv ? attn_bwd_dkv_wgmma<HD> : attn_bwd_dq_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(((dkv ? p.Sk : p.Sq) + BT - 1) / BT,
                  p.B * (dkv ? p.KV : p.H));
  kernel<<<grid, NT, G::SMEM, stream>>>(mq, mk, mv, mdo, p);
  return cudaGetLastError();
}

cudaError_t launch_hd(const Params& p, int hd, bool dkv, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<32>(p, dkv, s);
    case 64: return launch<64>(p, dkv, s);
    case 128: return launch<128>(p, dkv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

int launch(const Params& p, int hd, int dtype, bool dkv, void* stream) {
  if (p.B <= 0 || p.Sq <= 0 || p.Sk <= 0 || p.H <= 0 || p.KV <= 0 ||
      p.H % p.KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(p, hd, dkv, s);
  else if (dtype == 1)
    err = wg::launch_hd(p, hd, dkv, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32 (the scalar bodies), 1 = bfloat16 (the wgmma
// bodies; q, k, v, o, dO and the gradients alike; lse and D float32).
// Strides are in elements; lse, D and the gradients are contiguous. Each
// returns the launch's cudaError_t.

// dq and D (B, H, Sq) from q, k, v, o, dO and lse.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const float* lse, float* D, void* dq,
    int B, int Sq, int Sk, int H, int KV, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int window, int dtype, void* stream) {
  Params p{q, k, v, o, dO, lse, D, dq, nullptr, nullptr, B, Sq, Sk, H, KV,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, scale, causal, window};
  return launch(p, hd, dtype, false, stream);
}

// dk and dv from q, k, v, dO, lse and the D that flash_attention_bwd_dq
// wrote.
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dO,
    const float* lse, const float* D, void* dk, void* dv,
    int B, int Sq, int Sk, int H, int KV, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int window, int dtype, void* stream) {
  Params p{q, k, v, nullptr, dO, lse, const_cast<float*>(D), nullptr, dk, dv,
           B, Sq, Sk, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, 0, 0, 0, do_sb, do_ss, do_sh,
           scale, causal, window};
  return launch(p, hd, dtype, true, stream);
}
