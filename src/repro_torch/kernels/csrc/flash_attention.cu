// Flash-attention forward for Hopper (sm_90a), prefill / packed fragments.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/flash_attention.py::flash_attention (_attn_kernel):
//     causal / sliding-window / per-token segment-id masks, fully-masked
//     rows give 0;
//   * src/repro/kernels/flash_attention_bwd.py::_flash_fwd (_fwd_kernel):
//     the same forward without segments, plus the per-row logsumexp.
// One template serves both: the segment pointer and the lse pointer are
// optional (null = off).
//
// What bounds it on the card. At the main-path shapes (a packed buffer of
// ~2048 tokens, H=16, KV=8, hd=128, bf16) q, k, v and o are ~12 KiB per
// token, and the segment mask confines each row to its own request, so
// the work per byte is low: its bound is the memory, not the FLOPs. (As
// written, with scalar fp32 FMA, it runs far above that bound: PERF.md.)
// What the design does about it: each input element is read from device
// memory once per (q tile, head) and staged through shared memory; the
// (m, l, acc) online-softmax state lives in registers, so scores and
// probabilities never touch device memory; kv tiles before the sliding
// window's first tile and past the causal frontier are never loaded, nor
// are kv tiles that share no segment id with the q tile (in a packed
// batch, the other requests' tokens); q, k and v are read in the JAX
// layout (B, S, H, hd) through strides, so no transpose copy is made; GQA
// reads the kv head h / (H / KV) directly.
//
// Blocking (one thread block per (q tile, b*h), the kv loop inside the
// block): BQ=64 query rows x BK=32 kv columns per step, 128 threads laid
// out 16 (ty) x 8 (tx). A thread owns 4 query rows and, for the scores, 4
// kv columns (tx + 8j); for the output, hd/8 columns (tx + 8j). The eight
// lanes that share a row reduce its max and sum with warp shuffles.
// Arithmetic is fp32 scalar FMA (no tensor cores yet; wgmma and TMA are
// later work). Masked entries get p = 0 explicitly, so a row whose first
// kv tiles are all masked adds nothing to l or acc before its first valid
// tile, and l == 0 at the end (a row with no valid kv) gives 0.
//
// C entry point: flash_attention_fwd(...) launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int NT = 128;
constexpr int RPT = BQ / 16;   // query rows per thread
constexpr int CPT = BK / 8;    // score columns per thread
constexpr int KP = BK + 1;     // pitch of the transposed k tile
constexpr int PP = BK + 2;     // pitch of the probability tile
constexpr float NEG_INF = -1e30f;

static_assert(RPT == 4, "the q tile is read as float4 per thread");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;   // (B, S) int32 or null
  void* o;
  float* lse;       // (B, H, Sq) fp32 or null
  int B, Sq, Sk, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long seg_sb;
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

template <int HD>
constexpr int smem_bytes() {
  return (HD * BQ + HD * KP + BK * HD + BQ * PP) * 4 + (BQ + BK) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) attn_fwd_kernel(Params p) {
  constexpr int CJ = HD / 8;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                  // [HD][BQ]   q tile, transposed
  float* sKT = sQ + HD * BQ;         // [HD][KP]   k tile, transposed
  float* sV = sKT + HD * KP;         // [BK][HD]
  float* sP = sV + BK * HD;          // [BQ][PP]   probabilities
  int* sSegQ = reinterpret_cast<int*>(sP + BQ * PP);   // [BQ]
  int* sSegK = sSegQ + BQ;                             // [BK]

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int g = h / (p.H / p.KV);
  const bool has_seg = p.seg != nullptr;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  const int* seg = has_seg ? p.seg + b * p.seg_sb : nullptr;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int qr = q0 + r;
    sQ[d * BQ + r] = qr < p.Sq ? to_f(q[qr * p.q_ss + d]) : 0.f;
  }
  if (has_seg) {
    for (int r = tid; r < BQ; r += NT)
      sSegQ[r] = q0 + r < p.Sq ? seg[q0 + r] : -1;
  }

  float m[RPT], l[RPT], acc[RPT][CJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  // kv range this q tile can see: from the window's first column to the
  // causal frontier of its last real row
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;   // exclusive
  const int t_lo = k_lo / BK;
  const int t_hi = (k_hi + BK - 1) / BK;
  __syncthreads();

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    if (has_seg) {
      // skip a kv tile that shares no segment id with the q tile: in a
      // packed batch most tiles belong to other requests
      for (int c = tid; c < BK; c += NT)
        sSegK[c] = k0 + c < p.Sk ? seg[k0 + c] : -1;
      __syncthreads();
      int hit = 0;
      for (int i = tid; i < BQ * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        hit |= q0 + r < p.Sq && k0 + c < p.Sk && sSegQ[r] == sSegK[c];
      }
      if (!__syncthreads_or(hit)) continue;
    }
    for (int i = tid; i < BK * HD; i += NT) {
      const int c = i / HD, d = i % HD;
      const int kc = k0 + c;
      const bool in = kc < p.Sk;
      sKT[d * KP + c] = in ? to_f(k[kc * p.k_ss + d]) : 0.f;
      sV[c * HD + d] = in ? to_f(v[kc * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&sQ[d * BQ + ty * RPT]);
      const float qa[RPT] = {qv.x, qv.y, qv.z, qv.w};
      float kv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sKT[d * KP + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int rl = ty * RPT + i;
      const int r = q0 + rl;
      bool ok[CPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int cl = tx + 8 * j;
        const int c = k0 + cl;
        ok[j] = c < p.Sk && (!p.causal || c <= r) &&
                (p.window <= 0 || r - c < p.window) &&
                (!has_seg || sSegQ[rl] == sSegK[cl]);
        s[i][j] *= p.scale;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pij = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[rl * PP + tx + 8 * j] = pij;
        rs += pij;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty * RPT + i) * PP + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float vv = sV[c * HD + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    if (r >= p.Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      o[r * p.o_ss + tx + 8 * j] = from_f<T>(acc[i][j] / li);
    if (p.lse != nullptr && tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + r] = m[i] + logf(li);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  attn_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// launch's cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const int* seg, void* o,
    float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long seg_sb, float scale, int causal, int window, int dtype,
    void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, seg, o, lse, B, Sq, Sk, H, KV,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, seg_sb, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(p, hd, s);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(p, hd, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
