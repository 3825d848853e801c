// Flash-decoding for Hopper (sm_90a): one query token per batch row
// against a KV cache that may be a ring buffer.
//
// Replaces the Pallas TPU kernel of the JAX package
// src/repro/kernels/decode_attention.py::decode_attention (pallas_call ->
// _decode_kernel): q (B,1,H,hd) against k/v (B,Sk,KV,hd); a slot is
// masked where kv_pos < 0 (unwritten), kv_pos > q_pos, or, with a window,
// q_pos - kv_pos >= window; online softmax in fp32; q head h reads kv
// head h / (H / KV). A row with no valid slot gives 0, as the plain
// version does (the TPU kernel gives the mean of v there: while its
// running max is still -1e30, every masked entry adds p = exp(0) = 1).
//
// What bounds it on the card: bytes. Every k and v element is read once
// and used for one multiply-add per q head of its GQA group (2 to 16), so
// at the main-path shape (B=4, Sk=512, H=16, KV=8, hd=128, bf16: ~8.4 MB
// of k and v) the FLOPs are negligible and the least time is the bytes
// over the memory rate (~2.5 us). The TPU grid walks (B, KV, Sk/bk) in
// order and carries (m, l, acc) across kv blocks in VMEM scratch; CUDA
// blocks run in no order, so the design here is:
//
// * one block per (split, kv head, batch row) handles the whole GQA group:
//   each k/v row is loaded once for all q heads that read it;
// * Sk is cut into splits of SPLIT = 64 positions (flash-decoding): at the
//   main-path shape 8 splits x 8 kv heads x 4 rows = 256 blocks for 132
//   SMs, where one block per (b, kv head) would give 32. Each split writes
//   its partial (m, l, acc) in fp32 to scratch the wrapper allocates, and
//   decode_combine_kernel merges them. With one split the main kernel
//   writes the output itself;
// * inside a block, each of the NW warps takes U consecutive positions at
//   a time (positions split0 + warp*U .. +U-1, then +NW*U), its 32 lanes
//   splitting hd (hd/32 elements each); the U rows' loads are issued
//   before any of them is used, and each score is a warp all-reduce. The
//   warps' states merge through shared memory;
// * k, v and kv_pos are read through strides straight from the cache's
//   (B, Sc, KV, hd) layer view: no transpose copy;
// * the ragged edge (Sk not a multiple of SPLIT) is masked by the split's
//   end, and masked slots are skipped (p = 0): nothing masked ever enters
//   l or acc.
//
// The split length is fixed, so which positions a block, a warp and a
// lane handle depends on neither B nor Sk: a row's result is the same,
// bit for bit, whether it runs alone or in a batch, and whatever the
// cache capacity past its last valid slot (extra splits merge as exact
// zeros). Greedy decode served in a batch of 4 then sees the attention
// of the unbatched reference exactly.
//
// Arithmetic is fp32 scalar FMA with warp shuffles (no tensor cores, no
// TMA yet: later work).
//
// C entry point: decode_attention_fwd(...) launches on the given stream
// and returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;          // warps per block
constexpr int NT = NW * 32;
constexpr int SPLIT = 64;      // kv positions per split (kept in step with
                               // kernels/decode_attention.py::SPLIT)
constexpr int U = 4;           // positions a warp loads before using them
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;      // (B,)
  const int* kv_pos;     // (B, Sk), contiguous along Sk
  void* o;
  float* part_m;         // (B, H, n_split), null with one split
  float* part_l;         // (B, H, n_split)
  float* part_acc;       // (B, H, n_split, hd)
  int B, Sk, H, KV, n_split;
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long kvp_sb;
  long long o_sb, o_sh;
  float scale;
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// MAXG: the GQA group size rounded up to a power of two (the per-head
// state lives in registers, indexed by unrolled loops).
template <typename T, int HD, int MAXG>
__global__ void __launch_bounds__(NT) decode_attn_kernel(Params p) {
  constexpr int EPL = HD / 32;   // hd elements per lane
  __shared__ float sm_m[NW][MAXG];
  __shared__ float sm_l[NW][MAXG];
  __shared__ float sm_acc[NW][MAXG][HD];

  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h0 = g * G;
  const int qpos = p.q_pos[b];

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h0 * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  const int* kvp = p.kv_pos + b * p.kvp_sb;

  float qr[MAXG][EPL], m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int h = 0; h < MAXG; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[h][e] = h < G ? to_f(q[h * p.q_sh + lane * EPL + e]) : 0.f;
      acc[h][e] = 0.f;
    }
  }

  const int s0 = split * SPLIT;
  const int s1 = min(s0 + SPLIT, p.Sk);
  for (int j0 = s0 + warp * U; j0 < s1; j0 += NW * U) {
    float kr[U][EPL], vr[U][EPL];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      ok[u] = false;
      if (j < s1) {
        const int kp = kvp[j];
        ok[u] = kp >= 0 && kp <= qpos &&
                (p.window <= 0 || qpos - kp < p.window);
      }
      if (ok[u]) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kr[u][e] = to_f(k[j * p.k_ss + lane * EPL + e]);
          vr[u][e] = to_f(v[j * p.v_ss + lane * EPL + e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;   // uniform across the warp
#pragma unroll
      for (int h = 0; h < MAXG; ++h) {
        if (h < G) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s = fmaf(qr[h][e], kr[u][e], s);
          s = warp_sum(s) * p.scale;
          const float m_new = fmaxf(m[h], s);
          const float alpha = expf(m[h] - m_new);
          const float pj = expf(s - m_new);
          l[h] = l[h] * alpha + pj;
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[h][e] = fmaf(pj, vr[u][e], acc[h][e] * alpha);
          m[h] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < MAXG; ++h) {
    if (h < G) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        sm_acc[warp][h][lane * EPL + e] = acc[h][e];
      if (lane == 0) {
        sm_m[warp][h] = m[h];
        sm_l[warp][h] = l[h];
      }
    }
  }
  __syncthreads();

  // merge the warps: a warp that saw no valid slot has l = 0 and acc = 0,
  // so whatever its weight it adds exactly nothing
  for (int i = threadIdx.x; i < G * HD; i += NT) {
    const int h = i / HD, d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][h]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][h] - mx);
      ls = fmaf(sm_l[w][h], c, ls);
      a = fmaf(sm_acc[w][h][d], c, a);
    }
    const int hh = h0 + h;
    if (p.n_split == 1) {
      T* o = static_cast<T*>(p.o) + b * p.o_sb + hh * p.o_sh;
      o[d] = from_f<T>(a / (ls == 0.f ? 1.f : ls));
    } else {
      const long long r = (static_cast<long long>(b) * p.H + hh) * p.n_split
                          + split;
      p.part_acc[r * HD + d] = a;
      if (d == 0) {
        p.part_m[r] = mx;
        p.part_l[r] = ls;
      }
    }
  }
}

// One block per (b, q head), one thread per hd element: merges the splits'
// partial states in split order.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) decode_combine_kernel(Params p) {
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int d = threadIdx.x;
  const long long r0 = static_cast<long long>(bh) * p.n_split;
  float mx = NEG_INF;
  for (int s = 0; s < p.n_split; ++s) mx = fmaxf(mx, p.part_m[r0 + s]);
  float ls = 0.f, a = 0.f;
  for (int s = 0; s < p.n_split; ++s) {
    const float c = expf(p.part_m[r0 + s] - mx);
    ls = fmaf(p.part_l[r0 + s], c, ls);
    a = fmaf(p.part_acc[(r0 + s) * HD + d], c, a);
  }
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  o[d] = from_f<T>(a / (ls == 0.f ? 1.f : ls));
}

template <typename T, int HD, int MAXG>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.n_split, p.KV, p.B);
  decode_attn_kernel<T, HD, MAXG><<<grid, NT, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  decode_combine_kernel<T, HD><<<p.B * p.H, HD, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_g(const Params& p, cudaStream_t stream) {
  const int G = p.H / p.KV;
  if (G <= 2) return launch<T, HD, 2>(p, stream);
  if (G <= 4) return launch<T, HD, 4>(p, stream);
  if (G <= 8) return launch<T, HD, 8>(p, stream);
  if (G <= 16) return launch<T, HD, 16>(p, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_g<T, 32>(p, stream);
    case 64: return launch_g<T, 64>(p, stream);
    case 128: return launch_g<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; q, k, v and o
// are contiguous along hd, kv_pos along Sk. n_split must be
// ceil(Sk / 64); with n_split > 1 the three scratch pointers hold
// (B, H, n_split) and (B, H, n_split, hd) fp32 each. Returns the launches'
// cudaError_t (0 = launched).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* o, float* part_m, float* part_l,
    float* part_acc, int B, int Sk, int H, int KV, int hd, int n_split,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long kvp_sb, long long o_sb, long long o_sh,
    float scale, int window, int dtype, void* stream) {
  if (B <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      n_split != (Sk + SPLIT - 1) / SPLIT ||
      (n_split > 1 && (part_m == nullptr || part_l == nullptr ||
                       part_acc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, q_pos, kv_pos, o, part_m, part_l, part_acc,
           B, Sk, H, KV, n_split, q_sb, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, kvp_sb, o_sb, o_sh, scale, window};
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
