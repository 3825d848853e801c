// Flash-attention backward for Hopper (sm_90a): the FlashAttention-2
// gradient of the unsegmented causal / sliding-window attention.
//
// Replaces the two Pallas TPU kernels of the JAX package's
// src/repro/kernels/flash_attention_bwd.py::_flash_bwd:
//   * _dq_kernel  -> attn_bwd_dq_kernel:  dq = sum_kv ds k;
//   * _dkv_kernel -> attn_bwd_dkv_kernel: dv = sum p^T dO, dk = sum ds^T q,
//     summed over the q tiles and over every q head of the kv head's GQA
//     group, so dk and dv land in the kv-head layout.
// With p = exp(s * scale - lse) inside the mask (0 outside: the mask is
// applied before the exponential, so a row whose lse is NEG_INF gives
// p = 0), ds = p (dO v^T - D) scale and D = rowsum(dO o), fp32. D is the
// jnp reduction outside the TPU kernels; here the dq kernel computes it in
// its prologue (it reads dO for the same rows anyway) and writes it for
// the dkv kernel, launched after it on the same stream.
//
// What bounds it on the card. At the training main path (B=2, S=512,
// H=16, KV=8, hd=128, causal, bf16) each kernel moves ~17-21 MB and does
// 6 (dq) or 8 (dkv) FLOPs per valid (q, k) pair and head dimension, ~4 GFLOP:
// the bound is the memory (~5-6 us at 3.35 TB/s), a little above the
// tensor-core FLOP bound (~3-4 us). As written, with scalar fp32 FMA and
// no tensor cores, it runs far above both (PERF.md).
// What the design does about it: each block stages its fixed operand (the
// q and dO tile for dq; the k and v tile for dkv) in shared memory once
// and streams the other side's tiles past it; scores, p and ds never touch
// device memory; tiles wholly past the causal frontier or outside the
// window are never loaded (the TPU kernels visit them and mask); tensors
// are read in the JAX layout (B, S, heads, hd) through strides, so no
// transpose copy is made. Each output element is owned by one thread of
// one block: no atomics, so the result is deterministic.
//
// Blocking, 128 threads laid out 16 (ty) x 8 (tx), fp32 scalar FMA:
//   dq:  one block per (64-row q tile, b*h); kv tiles of 32 columns. A
//        thread owns 4 q rows x 4 kv columns of the score tile and 4 q rows
//        x hd/8 columns (tx + 8j) of dq, in registers.
//   dkv: one block per (64-row kv tile, b*kv); for each q head of the
//        group, q tiles of 32 columns. A thread owns 4 kv rows x 4 q
//        columns of the (transposed) score tile and 4 kv rows x hd/8
//        columns of dk and dv, in registers.
// Rows past S and columns past S are masked (the TPU wrappers need S to
// be a multiple of the block). Positions are implicit and top-left
// aligned: q row i is position i, kv row j position j.
//
// C entry points: flash_attention_bwd_dq(...) and
// flash_attention_bwd_dkv(...) launch on the given stream and return
// cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
// dq: one block per (q tile, b * H + h)
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
// dk, dv: one block per (kv tile, b * KV + kv head)
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
// launch
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

int launch(const Params& p, int hd, int dtype, bool dkv, void* stream) {
  if (p.B <= 0 || p.Sq <= 0 || p.Sk <= 0 || p.H <= 0 || p.KV <= 0 ||
      p.H % p.KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(p, hd, dkv, s);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(p, hd, dkv, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO and the gradients
// alike; lse and D float32). Strides are in elements; lse, D and the
// gradients are contiguous. Each returns the launch's cudaError_t.

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
