// Selective state-space scan for Hopper (sm_90a): the mamba2-style
// scalar-decay heads of hymba's hybrid blocks.
//
// Replaces the Pallas TPU kernel of the JAX package
// src/repro/kernels/ssm_scan.py::ssm_scan (pallas_call -> _ssm_kernel):
// for each (batch row b, head h), with x (B,T,H,hd), dt (B,T,H) fp32,
// A (H,) fp32, Bm/Cm (B,T,N) shared by every head of a row, and a state
// h (hd x N) in fp32,
//
//   a_t = exp(clip(dt_t * A, -2.5, 0))
//   h_t = a_t h_{t-1} + (dt_t x_t) B_t^T,    y_t = h_t C_t
//
// returning y (B,T,H,hd) in x's dtype and the final state (B,H,hd,N) fp32.
//
// Order: the TPU kernel carries h in VMEM scratch across a time-chunk grid
// axis that the TPU runs in order. CUDA blocks run in no order, so one
// block owns one (b, h) and walks time itself. It runs the per-token
// recurrence, not the TPU's chunked matmul form: with N = 16 the state is
// 64 x 16 = 1024 fp32 values, one per thread, so each step is one FMA per
// thread plus a reduction over N of 16 lanes (warp shuffles) for y_t. The
// matmul form would divide by cumulative decays and needs the -2.5 clamp
// to stay in range; the per-token form needs neither (the clamp is kept
// because it is part of the function), and it is the oracle's own order.
//
// Staging: each CT-step chunk of x (this head), dt (this head), Bm and Cm
// is loaded into shared memory in fp32 by the whole block, with a_t
// computed once per step there; the serial loop then reads only shared
// memory, and y is collected in shared memory and stored coalesced after
// the chunk. Inputs are read through strides in the JAX layout (no
// transpose copy). A ragged tail (T not a multiple of CT) runs only its
// real steps: a step past T never decays or updates the state, so any T
// works (the TPU wrapper asserts T % chunk == 0).
//
// What bounds it on the card: at the hymba main-path shape (B=1, T=512,
// H=50, hd=64, N=16, bf16) it moves ~6.6 MB (x and y dominate), ~2 us at
// 3.35 TB/s, and does ~2.6 MFLOP; so bytes bound it in principle. In
// practice the serial time loop bounds it: T dependent steps per block,
// and only B*H = 50 blocks for 132 SMs. Splitting T across blocks (a
// chunked scan with a second pass over chunk states) is later work.
//
// C entry point: ssm_scan_fwd(...) launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CT = 64;                 // time steps staged per chunk
constexpr int MAX_THREADS = 1024;      // hd * N
constexpr float LOG_DECAY_MIN = -2.5f;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* s0;       // (B, H, hd, N), contiguous
  void* y;
  float* s_out;          // (B, H, hd, N), contiguous
  int B, T, H, hd;
  long long x_sb, x_st, x_sh;
  long long dt_sb, dt_st, dt_sh;
  long long b_sb, b_st;
  long long c_sb, c_st;
  long long y_sb, y_st, y_sh;
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

// One block per (h, b); thread tid holds state element (d, n) with
// d = tid / N, n = tid % N, so the N lanes of one d are adjacent and
// aligned within a warp (N divides 32, hd * N is a multiple of 32).
template <typename T, int N>
__global__ void __launch_bounds__(MAX_THREADS) ssm_scan_kernel(Params p) {
  extern __shared__ float smem[];
  const int hd = p.hd;
  float* sx = smem;                    // [CT][hd]
  float* sy = sx + CT * hd;            // [CT][hd]
  float* sb = sy + CT * hd;            // [CT][N]
  float* sc = sb + CT * N;             // [CT][N]
  float* sa = sc + CT * N;             // [CT] decay a_t
  float* sdt = sa + CT;                // [CT] dt_t

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int d = tid / N, n = tid % N;
  const float A = p.A[h];
  const long long st = (static_cast<long long>(b) * p.H + h) * hd * N + tid;
  float state = p.s0[st];

  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* Bm = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* Cm = static_cast<const T*>(p.Cm) + b * p.c_sb;
  T* y = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;

  for (int t0 = 0; t0 < p.T; t0 += CT) {
    const int len = min(CT, p.T - t0);
    for (int i = tid; i < len * hd; i += nthr) {
      const int t = i / hd, e = i % hd;
      sx[i] = to_f(x[(t0 + t) * p.x_st + e]);
    }
    for (int i = tid; i < len * N; i += nthr) {
      const int t = i / N, e = i % N;
      sb[i] = to_f(Bm[(t0 + t) * p.b_st + e]);
      sc[i] = to_f(Cm[(t0 + t) * p.c_st + e]);
    }
    for (int t = tid; t < len; t += nthr) {
      const float dtt = dt[(t0 + t) * p.dt_st];
      sdt[t] = dtt;
      sa[t] = expf(fminf(fmaxf(dtt * A, LOG_DECAY_MIN), 0.f));
    }
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      const float upd = sdt[t] * sx[t * hd + d];
      state = sa[t] * state + upd * sb[t * N + n];
      float part = state * sc[t * N + n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (n == 0) sy[t * hd + d] = part;
    }
    __syncthreads();
    for (int i = tid; i < len * hd; i += nthr) {
      const int t = i / hd, e = i % hd;
      y[(t0 + t) * p.y_st + e] = from_f<T>(sy[i]);
    }
    // the next chunk's staging writes sx/sb/sc/sa/sdt, whose last reads
    // were before the barrier above; sy is written again only after the
    // next chunk's first barrier, which every thread reaches after its
    // stores of this chunk
  }
  p.s_out[st] = state;
}

size_t smem_bytes(int hd, int N) {
  return sizeof(float) * (2 * CT * hd + 2 * CT * N + 2 * CT);
}

template <typename T, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.hd, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  ssm_scan_kernel<T, N><<<grid, p.hd * N, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const Params& p, int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<T, 4>(p, stream);
    case 8: return launch<T, 8>(p, stream);
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y); dt, A and the
// states are fp32 always. Strides are in elements; x, dt's head axis, Bm,
// Cm and y are contiguous along their last axis; the states are
// contiguous (B, H, hd, N). N must be 4, 8, 16 or 32 and hd * N a
// multiple of 32 up to 1024. Returns the launch's cudaError_t (0 =
// launched).
extern "C" int ssm_scan_fwd(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* s0, void* y, float* s_out,
    int B, int T, int H, int hd, int N,
    long long x_sb, long long x_st, long long x_sh,
    long long dt_sb, long long dt_st, long long dt_sh,
    long long b_sb, long long b_st, long long c_sb, long long c_st,
    long long y_sb, long long y_st, long long y_sh,
    int dtype, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || hd <= 0 ||
      hd * N > MAX_THREADS || (hd * N) % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dt, A, Bm, Cm, s0, y, s_out, B, T, H, hd,
           x_sb, x_st, x_sh, dt_sb, dt_st, dt_sh, b_sb, b_st, c_sb, c_st,
           y_sb, y_st, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_n<float>(p, N, s);
  else if (dtype == 1)
    err = launch_n<__nv_bfloat16>(p, N, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
