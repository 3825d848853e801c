// RWKV6 (Finch) WKV scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
// src/repro/kernels/rwkv6_scan.py::wkv6_scan (pallas_call ->
// _wkv6_kernel): for each (batch row b, head h), with r/k/v (B,T,H,hd) in
// the model dtype, the decay w (B,T,H,hd) and the bonus u (H,hd) in fp32,
// and a state S (hd x hd, k index by v index) in fp32,
//
//   w_t = exp(clip(log(clip(w_t, 1e-12, 1)), -2.5, -1e-6))
//   o_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t
//
// returning o (B,T,H,hd) in r's dtype and the final state (B,H,hd,hd)
// fp32. u adds on the diagonal only: the current token's own k v^T.
//
// Order: the TPU kernel carries S in VMEM scratch across a time-chunk grid
// axis that the TPU runs in order. CUDA blocks run in no order, so one
// block owns one (b, h) and walks time itself, running the per-token
// recurrence (the oracle's order), not the TPU's chunked matmul form: the
// matmul form divides by cumulative decays, which the -2.5 clamp keeps in
// fp32 range only for chunks of 32; the per-token form has no such limit,
// and strong decays stay finite. The clamp is applied as part of the
// function.
//
// Work split: the 64 x 64 fp32 state (16 KB) lives in registers. Thread
// (j, q) holds column j (a v index) for the R = 8 rows i = q + P*r,
// r < R, with P = hd / R threads per column in adjacent lanes; per step it
// does R multiply-adds for its part of o_t[j], a P-lane shuffle reduction
// finishes o_t[j], and R updates of its state. Interleaving the rows (i =
// q + P*r, not q*R + r) keeps the P lanes of a column on distinct
// shared-memory banks when they read r_t, k_t and w_t.
//
// Staging: each CT-step chunk of r, k, v (this head) and the clamped
// decay is loaded into shared memory in fp32 by the whole block; the
// serial loop then reads only shared memory (broadcast reads), and o is
// collected in shared memory and stored coalesced after the chunk. Inputs
// are read through strides in the JAX layout (no transpose copy). A ragged
// tail runs only its real steps: a step past T never decays or updates
// the state, so any T works (the TPU wrapper asserts T % chunk == 0).
//
// What bounds it on the card: at the rwkv6-7b main-path shape (B=1,
// T=512, H=64, hd=64; r/k/v bf16, w fp32) it moves ~25 MB, ~7.5 us at
// 3.35 TB/s, and does ~0.5 GFLOP in the chunked form; so bytes bound it
// in principle. In practice the serial time loop does: T dependent steps
// per block, and only B*H = 64 blocks for 132 SMs. Splitting T across
// blocks (chunk states in a second pass) and tensor cores for the
// intra-chunk products are later work.
//
// C entry point: wkv6_scan_fwd(...) launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int R = 8;                   // state rows per thread
constexpr int STAGE = 2048;            // CT * hd: 40 KB of fp32 staging

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;        // (H, hd), contiguous
  const float* s0;       // (B, H, hd, hd), contiguous
  void* o;
  float* s_out;          // (B, H, hd, hd), contiguous
  int B, T, H;
  long long r_sb, r_st, r_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long w_sb, w_st, w_sh;
  long long o_sb, o_st, o_sh;
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

template <typename T, int HD>
__global__ void __launch_bounds__(HD / R * HD) wkv6_scan_kernel(Params p) {
  constexpr int P = HD / R;            // threads per column
  constexpr int NT = P * HD;
  constexpr int CT = STAGE / HD;       // time steps staged per chunk
  __shared__ float sr[CT][HD], sk[CT][HD], sv[CT][HD], sw[CT][HD],
      so[CT][HD];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = tid / P, q = tid % P;
  const long long st = (static_cast<long long>(b) * p.H + h) * HD * HD;

  float s[R], u[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q + P * i;
    s[i] = p.s0[st + row * HD + j];
    u[i] = p.u[h * HD + row];
  }

  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* w = p.w + b * p.w_sb + h * p.w_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int t0 = 0; t0 < p.T; t0 += CT) {
    const int len = min(CT, p.T - t0);
    for (int i = tid; i < len * HD; i += NT) {
      const int t = i / HD, e = i % HD;
      sr[t][e] = to_f(r[(t0 + t) * p.r_st + e]);
      sk[t][e] = to_f(k[(t0 + t) * p.k_st + e]);
      sv[t][e] = to_f(v[(t0 + t) * p.v_st + e]);
      const float wt = fminf(fmaxf(w[(t0 + t) * p.w_st + e], 1e-12f), 1.f);
      sw[t][e] = expf(fminf(fmaxf(logf(wt), -2.5f), -1e-6f));
    }
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      const float vj = sv[t][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = q + P * i;
        const float kv = sk[t][row] * vj;
        acc += sr[t][row] * (s[i] + u[i] * kv);
        s[i] = sw[t][row] * s[i] + kv;
      }
#pragma unroll
      for (int off = P / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (q == 0) so[t][j] = acc;
    }
    __syncthreads();
    for (int i = tid; i < len * HD; i += NT) {
      const int t = i / HD, e = i % HD;
      o[(t0 + t) * p.o_st + e] = from_f<T>(so[t][e]);
    }
    // the next chunk's staging writes sr/sk/sv/sw, last read before the
    // barrier above; so is written again only after the next chunk's
    // first barrier, which every thread reaches after its stores here
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    p.s_out[st + (q + P * i) * HD + j] = s[i];
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.H, p.B);
  wkv6_scan_kernel<T, HD><<<grid, HD / R * HD, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and o); w, u and the states
// are fp32 always. Strides are in elements; r, k, v, w and o are
// contiguous along hd; u and the states are contiguous. hd must be 16, 32
// or 64. Returns the launch's cudaError_t (0 = launched).
extern "C" int wkv6_scan_fwd(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* s0, void* o, float* s_out,
    int B, int T, int H, int hd,
    long long r_sb, long long r_st, long long r_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long w_sb, long long w_st, long long w_sh,
    long long o_sb, long long o_st, long long o_sh,
    int dtype, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{r, k, v, w, u, s0, o, s_out, B, T, H,
           r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           w_sb, w_st, w_sh, o_sb, o_st, o_sh};
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
