// RWKV6 (Finch) WKV scan for Hopper (sm_90a), parallel over time chunks.
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
// fp32.
//
// What bounds it on the card: bytes. At the rwkv6-7b main-path shape
// (B=1, T=512, H=64, hd=64; r/k/v bf16, w fp32) it moves 27.3 MB, 8.1 us
// at 3.35 TB/s, against ~0.5 GFLOP of the chunked form. The TPU kernel
// carries S in VMEM across a time-chunk grid axis that runs in order; a
// CUDA block that walks all T steps itself leaves T dependent steps in
// each of only B H blocks (64 for 132 SMs). So time is cut into chunks of
// C = 64 steps on a fixed grid from t = 0 (the ragged last chunk masked),
// and with cum_t the chunk's inclusive sum of log decays per channel i
// and ex_t = cum_{t-1} (0 at the chunk's first step):
//
//   o_t  = (r_t o exp(ex_t)) S_{c-1}                                 (inter)
//        + sum_{s<t} [sum_i r_t[i] k_s[i] exp(ex_t[i] - cum_s[i])] v_s (intra)
//        + (sum_i r_t[i] u[i] k_t[i]) v_t                            (bonus)
//   dS_c = sum_s (k_s o exp(cum_C - cum_s))^T v_s,
//   S_c  = diag(exp(cum_C)) S_{c-1} + dS_c                           (carry)
//
// The decay sits inside the contraction over i, so it is folded into the
// operands against a reference, and decays are never divided: the TPU
// kernel's r P_{t-1} and k / P_s stay in fp32 range only for chunks of 32
// (32 x 2.5 < 88.7); at 64 the quotient overflows. The reference is taken
// per 16-step sub-chunk, the mma tile: for t in sub-chunk a and s in an
// earlier sub-chunk b, with ref = cum at a step from b's last to the one
// before a (the bf16 body: the one before a, so a warp's r~ serves every
// b; the fp32 body: b's last, so k~ is shared),
//   r~_t = r_t o exp(ex_t - ref),  k~_s = k_s o exp(ref - cum_s),
// both exponents <= 0, and that block of scores is r~ k~^T on the tensor
// cores. In the 16 x 16 blocks on the diagonal, the lower-left 8 x 8
// quadrant (every s before every t) is the same with ref = cum at the
// quadrant's last s (bf16 body), and the rest, s < t, takes its decays
// channel by channel, exp(ex_t[i] - cum_s[i]), also <= 0, beside the
// bonus on the diagonal. A step past T has log-decay 0 and r = k = v = 0:
// it neither decays nor updates anything, so any T works.
//
// Design: three launches, the last two with programmatic dependent
// launch, each starting while the one before it runs and waiting on it
// (griddepcontrol.wait) only where it reads what that one writes.
//   wkv6_chunk_state_kernel, one block per (chunk, head, row): dS_c and
//     exp(cum_C) into scratch, warp w on rows 16 w of dS.
//   wkv6_chunk_carry_kernel: S_c = diag(exp(cum_C)) S_{c-1} + dS_c in
//     chunk order, element by element (a row's decay is the same for all
//     its columns), each dS_c replaced by the state entering chunk c and
//     the final state written out; a thread per 4 values of a state, with
//     8 chunks' loads in flight. csrc/ssm_scan.cu carries in the last
//     block of each (row, head) to finish, found by an atomic ticket; for
//     the 4x larger state here that serial carrier was the critical path
//     at T = 2048, and this form was faster at T = 512 and 2048 alike
//     (PERF.md).
//   wkv6_chunk_out_kernel, one block per (chunk, head, row), warp a on
//     sub-chunk a: the intra and bonus terms, then griddepcontrol.wait
//     and the inter term from the entering state.
// Also measured and slower at both lengths: one launch per (row, head,
// 16 columns of S) walking its chunks with its columns of S in registers
// (every chunk's scores computed once per 16 columns; no scratch).
// Scratch: dS_c, hd x hd fp32 per (b, h, chunk), 16 KB at hd 64, and hd
// decays per (b, h, chunk); the wrapper allocates it once per device and
// grows it; one launch may use it at a time, that is, one stream.
//
// Products. bf16 body: the scores r~ k~^T (16 x 16 x hd per block pair),
// scores x v (16 x 64 x hd per warp), r~ S (16 x hd x hd) and k~^T v (16
// x 64 x hd) on mma.sync m16n8k16 bf16 with fp32 accumulation. Every fp32
// operand (r~, k~, the scores, the state) is split into a bf16 high part
// and the bf16 of the remainder (three products for two split operands,
// the low-by-low one dropped; two for one): rounded to one bf16 such an
// operand fails the multi-chunk extreme-decay case (PERF.md, row 6). r,
// k and v are bf16 already. The fp32 body runs the same kernels with fp32
// FMA in place of each product. Decays are exp2 of log2-scaled sums
// (ex2.approx.ftz).
//
// A row's output at step t depends on neither T nor B: the chunk grid
// starts at t = 0 whatever T is, a block reads only its own (b, h) chunk,
// masks are selects, and every sum runs in a fixed order (the per-channel
// prefix sums too: a step's cum depends on the steps before it alone).
//
// C entry point: wkv6_scan_fwd(...) launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int C = 64;                  // time steps per chunk
constexpr int SUB = 16;                // steps per sub-chunk: the mma tile
constexpr int NSUB = C / SUB;
constexpr int NW = 4;                  // warps per block
constexpr int NT = NW * 32;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;        // (H, hd), contiguous
  const float* s0;       // (B, H, hd, hd), contiguous
  void* o;               // (B, T, H, hd), contiguous
  float* s_out;          // (B, H, hd, hd), contiguous
  float* ds;             // (B, H, n_chunk, hd, hd): dS_c, then S_{c-1}
  float* decay;          // (B, H, n_chunk, hd): exp(cum_C)
  int B, T, H, n_chunk;
  long long r_sb, r_st, r_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long w_sb, w_st, w_sh;
  int rkv_vec;           // r, k, v: base and strides whole 16-byte units
  int w_vec;             // the same of w
};

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// 8 consecutive values as fp32 (16-byte aligned)
__device__ __forceinline__ void ld8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[c]));
    x[2 * c] = f.x;
    x[2 * c + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the plain version's clamp of the decay, in log2 units
__device__ __forceinline__ float log2_decay(float w) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y) : "f"(fminf(fmaxf(w, 1e-12f), 1.f)));
  return fminf(fmaxf(y, -2.5f * LOG2E), -1e-6f * LOG2E);
}

// 16 bytes from global to shared; src_bytes 0 writes zeros and reads
// nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// two fp32 values as one register of two bf16 (the lower index low)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// a and b as bf16 high parts (hi) and the bf16 of what they leave (lo):
// a - hi is exact in fp32, so hi + lo keeps 16 of a's 24 bits
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// four 8x8 bf16 matrices from shared memory, transposed: lanes 8i..8i+7
// give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// D (16x8, fp32) += A (16x16, bf16) B (16x8, bf16). Fragments (g = lane/4,
// q = lane%4): A {(g, 2q..2q+1), (g+8, 2q..), (g, 2q+8..), (g+8, 2q+8..)},
// B {(k 2q..2q+1, n g), (k 2q+8.., n g)}, D {(g, 2q), (g, 2q+1), (g+8, 2q),
// (g+8, 2q+1)}
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of both kernels. Row strides: r, k, v padded by 16 bytes
// (RS), so the 8 rows an ldmatrix or fragment load touches fall in
// distinct banks; fp32 rows read as float2 fragments by (row g, column
// 2q) padded to 8 mod 32 words (CS).
template <typename T, int HD>
struct Layout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int RS = HD + 16 / int(sizeof(T));
  static constexpr int CS = HD + 8;
  static constexpr int SS = C + 1;               // fp32 scores (fp32 body)
  static constexpr int DS = SUB + 1;             // a warp's diagonal block
  // the state kernel: k, v, cum, prefix totals
  static constexpr size_t s_k = 0;
  static constexpr size_t s_v = s_k + sizeof(T) * C * RS;
  static constexpr size_t s_cum = s_v + sizeof(T) * C * RS;
  static constexpr size_t s_tot = s_cum + sizeof(float) * (C + 1) * CS;
  static constexpr size_t state_bytes = s_tot + sizeof(float) * NT;
  // the output kernel: r, k, v, cum, (the fp32 body) k~ of sub-chunks
  // 0..NSUB-2, scores (the fp32 body: all C x C; the bf16 body: each
  // warp's diagonal block), u, prefix totals
  static constexpr size_t o_r = 0;
  static constexpr size_t o_k = o_r + sizeof(T) * C * RS;
  static constexpr size_t o_v = o_k + sizeof(T) * C * RS;
  static constexpr size_t o_cum = o_v + sizeof(T) * C * RS;
  static constexpr size_t o_kb = o_cum + sizeof(float) * (C + 1) * CS;
  static constexpr size_t o_sc =
      o_kb + (F32 ? sizeof(float) * (C - SUB) * CS : 0);
  static constexpr size_t o_u =
      o_sc + sizeof(float) * (F32 ? C * SS : NW * SUB * DS);
  static constexpr size_t o_tot = o_u + sizeof(float) * HD;
  static constexpr size_t out_bytes = o_tot + sizeof(float) * NT;
};

// Rows [0, C) of a strided (rows, CP) slice into shared-memory rows of ss
// elements: zero past len rows. Where vec says the slice allows it, in
// 16-byte cp.async pieces, all in flight at once (cp_async_wait_all and a
// barrier complete them); else element by element.
template <typename T, int CP>
__device__ __forceinline__ void stage_rows(T* dst, int ss, const T* src,
                                           long long st, int len, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
#pragma unroll
    for (int i = threadIdx.x; i < C * (CP / VEC); i += NT) {
      const int r = i / (CP / VEC), c = (i % (CP / VEC)) * VEC;
      cp_async16(dst + r * ss + c, src + (r < len ? r * st + c : 0),
                 r < len ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < C * CP; i += NT) {
      const int r = i / CP, c = i % CP;
      dst[r * ss + c] = r < len ? src[r * st + c] : from_f<T>(0.f);
    }
  }
}

// The chunk's decays w into cum rows 1..C (row 0 zeros),
// by stage_rows: raw where vec (cum_decays converts them), else already
// as log2 decays, 0 past len.
template <int HD, int CS>
__device__ __forceinline__ void stage_w(const float* w, long long w_st,
                                        int len, bool vec, float* cum) {
  const int tid = threadIdx.x;
  if (vec) {
    stage_rows<float, HD>(cum + CS, CS, w, w_st, len, true);
  } else {
    for (int e = tid; e < C * HD; e += NT) {
      const int t = e / HD, i = e % HD;
      cum[(t + 1) * CS + i] = t < len ? log2_decay(w[t * w_st + i]) : 0.f;
    }
  }
  if (tid < HD) cum[tid] = 0.f;
}

// After stage_w and the barrier that completes the staging: the log2
// decays (0 past len) and their inclusive prefix sums by channel, in
// place: row t + 1 holds cum_t and row 0 zeros, so row t is ex_t. NT / HD
// threads per channel each sum C HD / NT consecutive steps, then add the
// totals of the parts before theirs in order: a step's sum depends on the
// steps before it alone. Ends with a barrier.
template <int HD, int CS>
__device__ __forceinline__ void cum_decays(int len, bool raw, float* cum,
                                           float* tot) {
  const int tid = threadIdx.x;
  constexpr int P = NT / HD, L = C / P;
  const int i = tid % HD, part = tid / HD;
  float x[L];
  float run = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int t = part * L + l;
    float lw = cum[(t + 1) * CS + i];
    if (raw) lw = t < len ? log2_decay(lw) : 0.f;
    run += lw;
    x[l] = run;
  }
  tot[tid] = run;
  __syncthreads();
  float off = 0.f;
  for (int p = 0; p < part; ++p) off += tot[p * HD + i];
#pragma unroll
  for (int l = 0; l < L; ++l) cum[(part * L + l + 1) * CS + i] = off + x[l];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// kernel 1: chunk states
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT) wkv6_chunk_state_kernel(Params p) {
  using L = Layout<T, HD>;
  extern __shared__ __align__(16) unsigned char sm[];
  // the carry kernel may start now: it waits for this grid before it
  // reads what this one writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = chunk * C, len = min(C, p.T - t0);
  T* ks = reinterpret_cast<T*>(sm + L::s_k);
  T* vs = reinterpret_cast<T*>(sm + L::s_v);
  float* cum = reinterpret_cast<float*>(sm + L::s_cum);
  stage_rows<T, HD>(ks, L::RS,
                    static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh +
                        t0 * p.k_st,
                    p.k_st, len, p.rkv_vec);
  stage_rows<T, HD>(vs, L::RS,
                    static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh +
                        t0 * p.v_st,
                    p.v_st, len, p.rkv_vec);
  stage_w<HD, L::CS>(p.w + b * p.w_sb + h * p.w_sh + t0 * p.w_st, p.w_st,
                     len, p.w_vec, cum);
  cp_async_wait_all();
  __syncthreads();
  cum_decays<HD, L::CS>(len, p.w_vec, cum,
                        reinterpret_cast<float*>(sm + L::s_tot));

  // dS = k~^T v with k~_s = k_s exp(cum_C - cum_s) (0 past T)
  const float* last = cum + C * L::CS;
  const long long bh = static_cast<long long>(b) * p.H + h;
  float* slot = p.ds + (bh * p.n_chunk + chunk) * (HD * HD);
  if constexpr (L::F32) {
    // thread (i, j0) owns row i, columns j0 .. j0 + NJ - 1
    constexpr int NJ = HD * HD / NT;
    const int i = tid % HD, j0 = (tid / HD) * NJ;
    float acc[NJ] = {};
    for (int s = 0; s < C; ++s) {
      const float a = ks[s * L::RS + i] * ex2(last[i] - cum[(s + 1) * L::CS + i]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[j] = fmaf(a, vs[s * L::RS + j0 + j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) slot[i * HD + j0 + j] = acc[j];
  } else {
    // warp w takes rows i0 = 16 w of dS; k~ split into bf16 high (a) and
    // low (al) parts, v bf16 already
    const int g = lane >> 2, q = lane & 3, r8 = lane & 7, mi = lane >> 3;
    const int i0 = 16 * warp;
    if (i0 < HD) {
      float acc[HD / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        // A = k~^T (rows i, columns s): element (i0 + g + 8 (e & 1),
        // 16 kk + 2q + 8 (e >> 1)) and the next s
        uint32_t a[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + g + 8 * (e & 1), s = 16 * kk + 2 * q + 8 * (e >> 1);
          split_bf16(__bfloat162float(ks[s * L::RS + i]) *
                         ex2(last[i] - cum[(s + 1) * L::CS + i]),
                     __bfloat162float(ks[(s + 1) * L::RS + i]) *
                         ex2(last[i] - cum[(s + 2) * L::CS + i]),
                     a[e], al[e]);
        }
        // B = v (rows s, columns j), two n-tiles of j per ldmatrix
#pragma unroll
        for (int d0 = 0; d0 < HD; d0 += 16) {
          uint32_t bb[4];
          ldsm_x4_t(bb, vs + (16 * kk + r8 + (mi & 1) * 8) * L::RS + d0 +
                            (mi >> 1) * 8);
          mma_bf16(acc[d0 / 8], a, bb[0], bb[1]);
          mma_bf16(acc[d0 / 8], al, bb[0], bb[1]);
          mma_bf16(acc[d0 / 8 + 1], a, bb[2], bb[3]);
          mma_bf16(acc[d0 / 8 + 1], al, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int jt = 0; jt < HD / 8; ++jt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<float2*>(slot + (i0 + g + 8 * rr) * HD + 8 * jt +
                                     2 * q) =
              make_float2(acc[jt][2 * rr], acc[jt][2 * rr + 1]);
    }
  }
  if (tid < HD) p.decay[(bh * p.n_chunk + chunk) * HD + tid] = ex2(last[tid]);
}

// ---------------------------------------------------------------------------
// kernel 2: the carry, parallel over each state's elements
// ---------------------------------------------------------------------------

// Thread tid of block x owns the 4 values from element 4 (x NT + tid) of
// the (b, h) state, all in one row; CB chunks' loads are issued before any
// of them is used.
template <int HD>
__global__ void __launch_bounds__(NT) wkv6_chunk_carry_kernel(Params p) {
  constexpr int CB = 8;
  // the output kernel may start now: it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int e = 4 * (blockIdx.x * NT + threadIdx.x);
  const long long bh = static_cast<long long>(blockIdx.z) * p.H + blockIdx.y;
  // dS and the decays, once the state kernel has written them
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (e >= HD * HD) return;
  float4* base = reinterpret_cast<float4*>(p.ds + bh * p.n_chunk * (HD * HD) +
                                           e);
  const float* dec = p.decay + bh * p.n_chunk * HD + e / HD;
  float4 st = *reinterpret_cast<const float4*>(p.s0 + bh * HD * HD + e);
  for (int c0 = 0; c0 < p.n_chunk; c0 += CB) {
    float4 dv[CB];
    float av[CB];
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      const int c = c0 + i;
      if (c < p.n_chunk) {
        av[i] = __ldcg(dec + c * HD);
        dv[i] = __ldcg(base + static_cast<long long>(c) * (HD * HD / 4));
      }
    }
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      const int c = c0 + i;
      if (c >= p.n_chunk) break;
      base[static_cast<long long>(c) * (HD * HD / 4)] = st;
      st.x = fmaf(av[i], st.x, dv[i].x);
      st.y = fmaf(av[i], st.y, dv[i].y);
      st.z = fmaf(av[i], st.z, dv[i].z);
      st.w = fmaf(av[i], st.w, dv[i].w);
    }
  }
  *reinterpret_cast<float4*>(p.s_out + bh * HD * HD + e) = st;
}

// ---------------------------------------------------------------------------
// kernel 3: outputs, intra-chunk first, then (after kernel 2) inter-chunk
// ---------------------------------------------------------------------------

// Scores element by element, block-wide: in each sub-chunk a's diagonal
// block (at out + a bs, row stride os), the lower triangles (s <= t) of
// its SUB / N blocks of N x N on the diagonal: sum_i r_t[i] k_s[i]
// exp(ex_t[i] - cum_s[i]) for s < t, and the bonus sum_i r_t[i] u[i]
// k_t[i] for s = t. The strict pairs of all sub-chunks are dealt to the
// threads first and the cheaper bonus pairs last; channels are summed in
// a fixed order in four interleaved partial sums.
template <typename T, int HD, int N>
__device__ __forceinline__ void tri_pairs(const T* rs, const T* ks,
                                          const float* cum, const float* us,
                                          float* out, int bs, int os) {
  using L = Layout<T, HD>;
  constexpr int NS = N * (N - 1) / 2;            // strict pairs a triangle
  constexpr int TS = SUB / N * NS;               // a sub-chunk's
  for (int it = threadIdx.x; it < NSUB * (TS + SUB); it += NT) {
    int a, t, s;
    if (it < NSUB * TS) {
      a = it / TS;
      const int tri = it % TS / NS, lp = it % NS;
      t = static_cast<int>((sqrtf(8.f * lp + 1.f) + 1.f) * 0.5f);
      if (t * (t - 1) / 2 > lp) --t;
      if ((t + 1) * t / 2 <= lp) ++t;
      s = lp - t * (t - 1) / 2 + tri * N;
      t += tri * N;
    } else {
      a = (it - NSUB * TS) / SUB;
      t = s = (it - NSUB * TS) % SUB;
    }
    const T* rt = rs + (SUB * a + t) * L::RS;
    const T* kv = ks + (SUB * a + s) * L::RS;
    const float* ct = s == t ? us : cum + (SUB * a + t) * L::CS;
    const float* cs = cum + (SUB * a + s + 1) * L::CS;
    float acc[4] = {};
#pragma unroll
    for (int i = 0; i < HD; i += 8) {
      float x[8], y[8], d[8];
      ld8(rt + i, x);
      ld8(kv + i, y);
      ld8(ct + i, d);
      if (s != t) {
        float f[8];
        ld8(cs + i, f);
#pragma unroll
        for (int c = 0; c < 8; ++c) d[c] = ex2(d[c] - f[c]);
      }
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc[c & 3] = fmaf(x[c] * y[c], d[c], acc[c & 3]);
    }
    out[a * bs + t * os + s] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
}

// A fragments (bf16 high and low parts, k-steps over channels) of
// r~_t = r_t exp(ex_t - cum row ref) for this lane's rows tl and tl + 8;
// with upper_zero, rows tl are zero
template <typename T, int HD>
__device__ __forceinline__ void r_frags(const T* rs, const float* cum,
                                        int tl, int ref,
                                        uint32_t (&rh)[HD / 16][4],
                                        uint32_t (&rl)[HD / 16][4],
                                        bool upper_zero = false) {
  using L = Layout<T, HD>;
  const int q = threadIdx.x & 3;
  const float* cr = cum + ref * L::CS;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 16 * kk + 2 * q + 8 * half;
      const float2 c0 = *reinterpret_cast<const float2*>(cr + i);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (rr == 0 && upper_zero) {
          rh[kk][2 * half] = rl[kk][2 * half] = 0u;
          continue;
        }
        const int t = tl + 8 * rr;
        const float2 x = ld2(rs + t * L::RS + i);
        const float2 e = *reinterpret_cast<const float2*>(cum + t * L::CS + i);
        split_bf16(x.x * ex2(e.x - c0.x), x.y * ex2(e.y - c0.y),
                   rh[kk][2 * half + rr], rl[kk][2 * half + rr]);
      }
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) wkv6_chunk_out_kernel(Params p) {
  using L = Layout<T, HD>;
  extern __shared__ __align__(16) unsigned char sm[];
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = chunk * C, len = min(C, p.T - t0);
  T* rs = reinterpret_cast<T*>(sm + L::o_r);
  T* ks = reinterpret_cast<T*>(sm + L::o_k);
  T* vs = reinterpret_cast<T*>(sm + L::o_v);
  float* cum = reinterpret_cast<float*>(sm + L::o_cum);
  float* sc = reinterpret_cast<float*>(sm + L::o_sc);
  float* us = reinterpret_cast<float*>(sm + L::o_u);
  stage_rows<T, HD>(rs, L::RS,
                    static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh +
                        t0 * p.r_st,
                    p.r_st, len, p.rkv_vec);
  stage_rows<T, HD>(ks, L::RS,
                    static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh +
                        t0 * p.k_st,
                    p.k_st, len, p.rkv_vec);
  stage_rows<T, HD>(vs, L::RS,
                    static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh +
                        t0 * p.v_st,
                    p.v_st, len, p.rkv_vec);
  stage_w<HD, L::CS>(p.w + b * p.w_sb + h * p.w_sh + t0 * p.w_st, p.w_st,
                     len, p.w_vec, cum);
  if (tid < HD) us[tid] = p.u[h * HD + tid];
  cp_async_wait_all();
  __syncthreads();
  cum_decays<HD, L::CS>(len, p.w_vec, cum,
                        reinterpret_cast<float*>(sm + L::o_tot));

  const long long bh = static_cast<long long>(b) * p.H + h;
  const float* sin = p.ds + (bh * p.n_chunk + chunk) * (HD * HD);
  T* o = static_cast<T*>(p.o) +
         (static_cast<long long>(b) * p.T + t0) * p.H * HD + h * HD;
  const long long o_st = static_cast<long long>(p.H) * HD;

  if constexpr (L::F32) {
    // k~ of sub-chunk b against its last step (cum row SUB (b + 1)), for
    // b < NSUB - 1: kb[s][i] = k_s[i] exp(cum_{SUB b + SUB - 1} - cum_s)
    float* kb = reinterpret_cast<float*>(sm + L::o_kb);
    for (int e = tid; e < (C - SUB) * HD; e += NT) {
      const int s = e / HD, i = e % HD, ref = (s / SUB + 1) * SUB;
      kb[s * L::CS + i] = ks[s * L::RS + i] *
                          ex2(cum[ref * L::CS + i] - cum[(s + 1) * L::CS + i]);
    }
    // scores S[t][s] in shared memory: zero for s > t, the diagonal blocks
    // element by element, the earlier blocks (t, b) by a thread each
    for (int e = tid; e < C * C; e += NT) {
      const int t = e / C, s = e % C;
      if (s > t) sc[t * L::SS + s] = 0.f;
    }
    tri_pairs<T, HD, SUB>(rs, ks, cum, us, sc, SUB * (L::SS + 1), L::SS);
    __syncthreads();                  // kb complete
    for (int it = tid; it < C * (NSUB - 1); it += NT) {
      const int t = it % C, bb = it / C;
      if (bb >= t / SUB) continue;
      const float* ct = cum + t * L::CS;
      const float* cr = cum + SUB * (bb + 1) * L::CS;
      const float* kr = kb + SUB * bb * L::CS;
      float acc[SUB] = {};
      for (int i = 0; i < HD; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(rs + t * L::RS + i);
        const float4 e = *reinterpret_cast<const float4*>(ct + i);
        const float4 c0 = *reinterpret_cast<const float4*>(cr + i);
        const float r0 = x.x * ex2(e.x - c0.x), r1 = x.y * ex2(e.y - c0.y);
        const float r2 = x.z * ex2(e.z - c0.z), r3 = x.w * ex2(e.w - c0.w);
#pragma unroll
        for (int s = 0; s < SUB; ++s) {
          const float4 y = *reinterpret_cast<const float4*>(kr + s * L::CS + i);
          acc[s] = fmaf(r3, y.w, fmaf(r2, y.z, fmaf(r1, y.y,
                                                    fmaf(r0, y.x, acc[s]))));
        }
      }
#pragma unroll
      for (int s = 0; s < SUB; ++s) sc[t * L::SS + SUB * bb + s] = acc[s];
    }
    __syncthreads();
    // thread (tr, dc) owns rows tr + 16 i and columns dc + 8 j
    constexpr int NJ = HD / 8;
    const int tr = tid >> 3, dc = tid & 7;
    float acc[4][NJ] = {};
    for (int s = 0; s < C; ++s) {
      float sv[4], xv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sc[(tr + 16 * i) * L::SS + s];
#pragma unroll
      for (int j = 0; j < NJ; ++j) xv[j] = vs[s * L::RS + dc + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
    }
    // r~_t = r_t exp(ex_t) over k (free now)
    for (int e = tid; e < C * HD; e += NT) {
      const int t = e / HD, i = e % HD;
      ks[t * L::RS + i] = rs[t * L::RS + i] * ex2(cum[t * L::CS + i]);
    }
    // the entering state, once the carry kernel has written it, over r
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    __syncthreads();
    constexpr int NV = HD * HD / 4, PER = (NV + NT - 1) / NT;
    float4 x[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * NT;
      if (e < NV) x[k] = __ldcg(reinterpret_cast<const float4*>(sin) + e);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * NT;
      if (e < NV)
        *reinterpret_cast<float4*>(rs + (e / (HD / 4)) * L::RS +
                                   (e % (HD / 4)) * 4) = x[k];
    }
    __syncthreads();
    for (int i2 = 0; i2 < HD; ++i2) {
      float rv[4], sv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) rv[i] = ks[(tr + 16 * i) * L::RS + i2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sv[j] = rs[i2 * L::RS + dc + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(rv[i], sv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tr + 16 * i;
      if (t >= len) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[t * o_st + dc + 8 * j] = acc[i][j];
    }
  } else {
    constexpr int KI = HD / 16, NJ = HD / 8;
    const int g = lane >> 2, q = lane & 3, r8 = lane & 7, mi = lane >> 3;
    const int a = warp, tl = SUB * a + g, th = tl + 8;
    // the diagonal blocks' 8 x 8 triangles, element by element
    float* dg = sc + a * SUB * L::DS;
    tri_pairs<T, HD, 8>(rs, ks, cum, us, sc, SUB * L::DS, L::DS);
    __syncthreads();
    // score fragments (bf16 high sa, low sl) of k-steps kk over s. The
    // earlier sub-chunks: r~ k~^T against cum at the step before this
    // sub-chunk (so r~ is computed once), both exponents <= 0. The
    // diagonal block's lower-left 8 x 8 quadrant (t in its upper half, s
    // in its lower) the same way against cum at step SUB a + 7, the A
    // rows of the lower half zero.
    uint32_t sa[NSUB][4], sl[NSUB][4], rh[KI][4], rl[KI][4];
#pragma unroll
    for (int kk = 0; kk < NSUB; ++kk) {
      if (kk > a) break;
      const bool diag = kk == a;
      const int ref = diag ? SUB * a + 8 : SUB * a;
      if (diag || kk == 0) r_frags<T, HD>(rs, cum, tl, ref, rh, rl, diag);
      float s2[2][4] = {};
      const float* cr = cum + ref * L::CS + 2 * q;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (diag && jj == 1) break;
        // B = k~^T (rows i, columns s): lane's s = SUB kk + 8 jj + g
        const int sg = SUB * kk + 8 * jj + g;
        const T* kr = ks + sg * L::RS + 2 * q;
        const float* cs = cum + (sg + 1) * L::CS + 2 * q;
#pragma unroll
        for (int k2 = 0; k2 < KI; ++k2) {
          uint32_t h[2], l[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 16 * k2 + 8 * half;
            const float2 x = ld2(kr + i);
            const float2 e = *reinterpret_cast<const float2*>(cr + i);
            const float2 f = *reinterpret_cast<const float2*>(cs + i);
            split_bf16(x.x * ex2(e.x - f.x), x.y * ex2(e.y - f.y), h[half],
                       l[half]);
          }
          mma_bf16(s2[jj], rh[k2], h[0], h[1]);
          mma_bf16(s2[jj], rh[k2], l[0], l[1]);
          mma_bf16(s2[jj], rl[k2], h[0], h[1]);
        }
      }
      if (diag) {
        // the triangles from dg (s > t masked by a select); the quadrant
        // from the product (rows g + 8, columns 2q, 2q + 1)
        const float* d0 = dg + g * L::DS + 2 * q;
        const float* d1 = d0 + 8 * L::DS + 8;
        s2[0][0] = 2 * q <= g ? d0[0] : 0.f;
        s2[0][1] = 2 * q + 1 <= g ? d0[1] : 0.f;
        s2[1][0] = 0.f;
        s2[1][1] = 0.f;
        s2[1][2] = 2 * q <= g ? d1[0] : 0.f;
        s2[1][3] = 2 * q + 1 <= g ? d1[1] : 0.f;
      }
      split_bf16(s2[0][0], s2[0][1], sa[kk][0], sl[kk][0]);
      split_bf16(s2[0][2], s2[0][3], sa[kk][1], sl[kk][1]);
      split_bf16(s2[1][0], s2[1][1], sa[kk][2], sl[kk][2]);
      split_bf16(s2[1][2], s2[1][3], sa[kk][3], sl[kk][3]);
    }
    // O = S V: B = V (rows s, columns j), two n-tiles of j per ldmatrix
    float acc[NJ][4] = {};
#pragma unroll
    for (int kk = 0; kk < NSUB; ++kk) {
      if (kk > a) break;
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += 16) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs + (SUB * kk + r8 + (mi & 1) * 8) * L::RS + d0 +
                          (mi >> 1) * 8);
        mma_bf16(acc[d0 / 8], sa[kk], bv[0], bv[1]);
        mma_bf16(acc[d0 / 8], sl[kk], bv[0], bv[1]);
        mma_bf16(acc[d0 / 8 + 1], sa[kk], bv[2], bv[3]);
        mma_bf16(acc[d0 / 8 + 1], sl[kk], bv[2], bv[3]);
      }
    }
    // the inter term: r~_t = r_t exp(ex_t) times the entering state, once
    // the carry kernel has written it, as bf16 high and low parts over r
    // and k, transposed (rows j, columns i)
    r_frags<T, HD>(rs, cum, tl, 0, rh, rl);
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    __syncthreads();
    uint32_t* sth = reinterpret_cast<uint32_t*>(rs);
    uint32_t* stl = reinterpret_cast<uint32_t*>(ks);
    // item (row pair ip, columns 4 jq .. 4 jq + 3); every load issued
    // before any is used
    constexpr int NI = HD * HD / 8, PER = (NI + NT - 1) / NT;
    float4 x0[PER], x1[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * NT, ip = e / (HD / 4), jq = e % (HD / 4);
      if (e < NI) {
        const float4* src = reinterpret_cast<const float4*>(sin) +
                            2 * ip * (HD / 4) + jq;
        x0[k] = __ldcg(src);
        x1[k] = __ldcg(src + HD / 4);
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * NT, ip = e / (HD / 4), jq = e % (HD / 4);
      if (e >= NI) continue;
      const float a0[4] = {x0[k].x, x0[k].y, x0[k].z, x0[k].w};
      const float a1[4] = {x1[k].x, x1[k].y, x1[k].z, x1[k].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t hi, lo;
        split_bf16(a0[c], a1[c], hi, lo);
        const int w2 = (4 * jq + c) * (L::RS / 2) + ip;
        sth[w2] = hi;
        stl[w2] = lo;
      }
    }
    __syncthreads();
#pragma unroll
    for (int jt = 0; jt < NJ; ++jt) {
      const int w0 = (8 * jt + g) * L::RS / 2 + q;
#pragma unroll
      for (int k2 = 0; k2 < KI; ++k2) {
        const uint32_t h0 = sth[w0 + 8 * k2], h1 = sth[w0 + 8 * k2 + 4];
        const uint32_t l0 = stl[w0 + 8 * k2], l1 = stl[w0 + 8 * k2 + 4];
        mma_bf16(acc[jt], rh[k2], h0, h1);
        mma_bf16(acc[jt], rh[k2], l0, l1);
        mma_bf16(acc[jt], rl[k2], h0, h1);
      }
    }
#pragma unroll
    for (int jt = 0; jt < NJ; ++jt) {
      const int d = 8 * jt + 2 * q;
      if (tl < len)
        *reinterpret_cast<uint32_t*>(o + tl * o_st + d) =
            pack_bf16(acc[jt][0], acc[jt][1]);
      if (th < len)
        *reinterpret_cast<uint32_t*>(o + th * o_st + d) =
            pack_bf16(acc[jt][2], acc[jt][3]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// a launch that may start before the one before it on the stream ends
template <typename K>
cudaError_t launch_dependent(K kernel, dim3 grid, size_t smem,
                             cudaStream_t stream, const Params& p) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Layout<T, HD>;
  auto k1 = wkv6_chunk_state_kernel<T, HD>;
  auto k3 = wkv6_chunk_out_kernel<T, HD>;
  // once per device: a host call per launch would add to the enqueueing
  // cost
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(done >> dev & 1u)) {
    if ((err = allow_smem(k1, L::state_bytes)) != cudaSuccess) return err;
    if ((err = allow_smem(k3, L::out_bytes)) != cudaSuccess) return err;
    if (dev < 32) done |= 1u << dev;
  }
  k1<<<dim3(p.n_chunk, p.H, p.B), NT, L::state_bytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_dependent(wkv6_chunk_carry_kernel<HD>,
                         dim3((HD * HD / 4 + NT - 1) / NT, p.H, p.B), 0,
                         stream, p);
  if (err != cudaSuccess) return err;
  return launch_dependent(k3, dim3(p.n_chunk, p.H, p.B), L::out_bytes,
                          stream, p);
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
// are fp32 always. Strides are in elements; r, k, v and w are contiguous
// along hd; o, u and the states are contiguous. hd must be 16, 32 or 64;
// n_chunk must be ceil(T / 64); ds holds B H n_chunk hd hd fp32 and
// decay B H n_chunk hd fp32, both 16-byte aligned, as is s0. rkv_vec: r's, k's and v's bases are 16-byte
// aligned and their strides whole 16-byte units; w_vec: the same of w.
// Returns the launches' cudaError_t (0 = launched).
extern "C" int wkv6_scan_fwd(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* s0, void* o, float* s_out, float* ds,
    float* decay, int B, int T, int H, int hd, int n_chunk,
    long long r_sb, long long r_st, long long r_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long w_sb, long long w_st, long long w_sh,
    int rkv_vec, int w_vec, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535 ||
      n_chunk != (T + C - 1) / C || ds == nullptr || decay == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{r, k, v, w, u, s0, o, s_out, ds, decay, B, T, H, n_chunk,
           r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           w_sb, w_st, w_sh, rkv_vec, w_vec};
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
