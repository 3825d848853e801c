// Selective state-space scan for Hopper (sm_90a): the mamba2-style
// scalar-decay heads of hymba's hybrid blocks, parallel over time chunks.
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
// What bounds it on the card: bytes. At the hymba main-path shape (B=1,
// T=512, H=50, hd=64, N=16, bf16) it moves 7.1 MB (x and y dominate),
// 2.1 us at 3.35 TB/s, against 0.24 GFLOP of the chunked form, 0.24 us on
// the tensor cores. The TPU kernel carries h in VMEM scratch across a
// time-chunk grid axis that the TPU runs in order; a CUDA block that
// walks all T steps itself (the per-token recurrence) leaves T dependent
// steps in every block and only B H blocks (50) for 132 SMs. So time is
// cut into chunks of C = 64 steps on a fixed grid from t = 0 (the ragged
// last chunk masked), and with cum_t the chunk's inclusive sum of log
// decays (cum_C its total),
//
//   y_t = sum_{s<=t} exp(cum_t - cum_s) dt_s (C_t . B_s) x_s      (intra)
//       + exp(cum_t) C_t h_{c-1}^T                                 (inter)
//   dH_c = sum_s exp(cum_C - cum_s) dt_s x_s B_s^T,
//   h_c  = exp(cum_C) h_{c-1} + dH_c                               (carry)
//
// Every exponent is a difference of log cumulative sums that is <= 0
// where it is used: decays are never divided (the reference's L_t / L_s
// is 0 / 0 once a chunk's summed log-decay passes about -104, from step
// 42 of a 64-step chunk at the -2.5 clamp). A step past T has dt = 0 and
// log-decay 0: it neither decays nor updates the state, so any T works.
//
// Design: two launches in the SSD manner.
//   ssm_chunk_state_kernel, one block per (chunk, head, row): dH_c and
//     exp(cum_C) into scratch; then __threadfence() and an atomic ticket
//     per (b, h), and the last block of the row and head to finish
//     carries the state through the chunks in order (hd N FMAs a chunk,
//     the only serial part, a batch of chunks' loads in flight at a
//     time), overwriting each dH_c with the state that enters chunk c,
//     writing the final state, and resetting its ticket.
//   ssm_chunk_out_kernel, one block per (chunk, head, row), launched with
//     programmatic dependent launch: it computes the intra term while the
//     first kernel still runs, then waits on it (griddepcontrol.wait) and
//     adds the inter term from the entering state.
// The other design measured on the card (PERF.md): one kernel whose
// blocks take chunks from an atomic ticket in chunk order, wait on their
// predecessor's published state and publish their own. It was slower at
// T = 512 and at T = 2048: each chunk's hand-off (store, fence, flag,
// poll, load) lies on its critical path, n_chunk of them in a row. The
// two-launch form has no inter-block wait at all. Scratch: a state of
// hd N fp32 per (b, h, chunk), 4 KB at hd 64, N 16: half of x's bytes per
// chunk at C = 64, written twice and read twice while it sits in L2. The
// wrapper allocates it and the tickets once per device and grows them;
// the tickets assume one launch in flight at a time, that is, one stream
// at a time.
//
// Products. bf16 body: CB = C B^T (C x C x N), Y += S X (C x C x hd),
// dH = (w x)^T B (hd x C x N) and Y_inter = C H^T (C x N x hd) on the
// tensor cores, mma.sync m16n8k16 bf16 with fp32 accumulation; one warp
// per 16-row slice. x, B and C are bf16 already. The operands that are
// fp32 (the scores S, causal-masked by a select, never a multiply; the
// weighted x; the entering state H) are each split into a bf16 high part
// and the bf16 of the remainder, two products in place of one: rounded
// to one bf16, a score of a few hundred (dt far past the clamp) carries
// an error of ~1 into a y that cancels to ~0, past the bf16 tolerance
// of chip_smoke.TOL, which the split form holds. The fp32 body runs the
// same two kernels with fp32 FMA in place of each product (no
// tensor-core product takes fp32 operands at fp32 precision), as the
// attention kernels' fp32 bodies do.
//
// A row's output at step t depends on neither T nor B: the chunk grid
// starts at t = 0 whatever T is, a block reads only its own (b, h)
// chunk, and every sum runs in a fixed order (the in-chunk prefix sum of
// log decays too: a step's cum depends on the steps before it alone).
//
// C entry point: ssm_scan_fwd(...) launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int C = 64;                  // time steps per chunk
constexpr int NW = 4;                  // warps per block
constexpr int NT = NW * 32;
constexpr float LOG_DECAY_MIN = -2.5f;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* s0;       // (B, H, hd, N), contiguous
  void* y;               // (B, T, H, hd), contiguous
  float* s_out;          // (B, H, hd, N), contiguous
  float* dh;             // (B, H, n_chunk, hd, N): dH_c, then h_{c-1}
  float* decay;          // (B, H, n_chunk): exp(cum_C)
  int* ticket;           // (B, H), zero between launches
  int B, T, H, hd, N, n_chunk;
  long long x_sb, x_st, x_sh;
  long long dt_sb, dt_st, dt_sh;
  long long b_sb, b_st;
  long long c_sb, c_st;
  int x_vec;             // x's base and strides are whole 16-byte units
  int bc_vec;            // so are Bm's and Cm's, and their rows
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
__device__ __forceinline__ float lo_f(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_f(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
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

// Shared memory of both kernels. HDP: hd rounded up to a power of two
// (16..128); NP: N rounded up to a multiple of 16. Rows of x, B, C and H
// are padded by 16 bytes, so the 8 rows an ldmatrix or fragment load
// touches fall in distinct banks.
template <typename T, int HDP, int NP>
struct Layout {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int XS = HDP + PAD;         // x row stride (elements)
  static constexpr int NS = NP + PAD;          // B, C, H row stride
  static constexpr int SS = C + 1;             // fp32 scores row stride
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr size_t x_off = 0;
  static constexpr size_t b_off = x_off + sizeof(T) * C * XS;
  static constexpr size_t c_off = b_off + sizeof(T) * C * NS;
  static constexpr size_t h_off = c_off + sizeof(T) * C * NS;
  // H: fp32, or its bf16 high and low parts one after the other
  static constexpr size_t s_off = h_off + sizeof(float) * HDP * NS;
  static constexpr size_t v_off = s_off + (F32 ? sizeof(float) * C * SS : 0);
  static constexpr size_t bytes = v_off + sizeof(float) * 3 * C;
};

// Rows [0, C) of a strided (rows, cols) slice into shared-memory rows of
// ss elements, CP of them per row (cols real): zero past len rows and
// cols columns; read in 16-byte pieces when vec says the slice allows it.
template <typename T, int CP>
__device__ __forceinline__ void stage_rows(T* dst, int ss, const T* src,
                                           long long st, int len, int cols,
                                           bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    for (int i = threadIdx.x; i < C * (CP / VEC); i += NT) {
      const int r = i / (CP / VEC), c = (i % (CP / VEC)) * VEC;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (r < len && c < cols)
        u = *reinterpret_cast<const uint4*>(src + r * st + c);
      *reinterpret_cast<uint4*>(dst + r * ss + c) = u;
    }
  } else {
    for (int i = threadIdx.x; i < C * CP; i += NT) {
      const int r = i / CP, c = i % CP;
      dst[r * ss + c] = r < len && c < cols ? src[r * st + c] : from_f<T>(0.f);
    }
  }
}

// Stage one chunk of (b, h): x, B and (WITH_C) C, zero past T and past hd
// or N; dt and the log decay (0 past T); the inclusive prefix sum cum of
// the log decays; all in shared memory. Returns the chunk's valid length.
template <typename T, int HDP, int NP, bool WITH_C>
__device__ __forceinline__ int stage_chunk(const Params& p, unsigned char* sm,
                                           int chunk, int h, int b) {
  using L = Layout<T, HDP, NP>;
  float* sdt = reinterpret_cast<float*>(sm + L::v_off);
  float* scum = sdt + C;
  const int tid = threadIdx.x;
  const int t0 = chunk * C;
  const int len = min(C, p.T - t0);
  stage_rows<T, HDP>(reinterpret_cast<T*>(sm + L::x_off), L::XS,
                     static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh +
                         t0 * p.x_st,
                     p.x_st, len, p.hd, p.x_vec);
  stage_rows<T, NP>(reinterpret_cast<T*>(sm + L::b_off), L::NS,
                    static_cast<const T*>(p.Bm) + b * p.b_sb + t0 * p.b_st,
                    p.b_st, len, p.N, p.bc_vec);
  if constexpr (WITH_C)
    stage_rows<T, NP>(reinterpret_cast<T*>(sm + L::c_off), L::NS,
                      static_cast<const T*>(p.Cm) + b * p.c_sb + t0 * p.c_st,
                      p.c_st, len, p.N, p.bc_vec);
  // dt and the clipped log decay; a step past T: dt = 0, log decay 0
  float la = 0.f;
  if (tid < C) {
    float dtt = 0.f;
    if (tid < len) {
      dtt = p.dt[b * p.dt_sb + (t0 + tid) * p.dt_st + h * p.dt_sh];
      la = fminf(fmaxf(dtt * p.A[h], LOG_DECAY_MIN), 0.f);
    }
    sdt[tid] = dtt;
    scum[tid] = la;
  }
  __syncthreads();
  // inclusive prefix sum by warp 0, two steps a lane; a step's sum
  // depends on the steps before it alone
  if (tid < 32) {
    const float l0 = scum[2 * tid], l1 = scum[2 * tid + 1];
    float inc = l0 + l1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, inc, off);
      if (tid >= off) inc += y;
    }
    float ex = __shfl_up_sync(0xffffffffu, inc, 1);
    if (tid == 0) ex = 0.f;
    const float c0 = ex + l0;
    scum[2 * tid] = c0;
    scum[2 * tid + 1] = c0 + l1;
  }
  __syncthreads();
  return len;
}

// ---------------------------------------------------------------------------
// kernel 1: chunk states, then the carry by the last block of each (b, h)
// ---------------------------------------------------------------------------

template <typename T, int HDP, int NP>
__global__ void __launch_bounds__(NT, 1) ssm_chunk_state_kernel(Params p) {
  using L = Layout<T, HDP, NP>;
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int s_last;
  // the output kernel may start now: it waits for this grid before it
  // reads what this one writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  stage_chunk<T, HDP, NP, false>(p, sm, chunk, h, b);
  const T* xs = reinterpret_cast<const T*>(sm + L::x_off);
  const T* bs = reinterpret_cast<const T*>(sm + L::b_off);
  const float* sdt = reinterpret_cast<const float*>(sm + L::v_off);
  const float* scum = sdt + C;
  float* sw = const_cast<float*>(scum) + C;

  // w_s = exp(cum_C - cum_s) dt_s (0 past T)
  if (tid < C) sw[tid] = expf(scum[C - 1] - scum[tid]) * sdt[tid];
  __syncthreads();

  const long long bh = static_cast<long long>(b) * p.H + h;
  const int hdN = p.hd * p.N;
  float* dh = p.dh + (bh * p.n_chunk + chunk) * hdN;
  if constexpr (L::F32) {
    for (int e = tid; e < hdN; e += NT) {
      const int d = e / p.N, n = e % p.N;
      float acc = 0.f;
      for (int s = 0; s < C; ++s)
        acc = fmaf(xs[s * L::XS + d] * sw[s], bs[s * L::NS + n], acc);
      dh[e] = acc;
    }
  } else {
    // dH (hd x N) = U^T B, U = w x rounded to bf16; warp w takes the
    // 16-row slices d0 = 16 (w + 4 i) of hd
    const int g = lane >> 2, q = lane & 3, r8 = lane & 7, mi = lane >> 3;
    for (int d0 = 16 * warp; d0 < HDP; d0 += 16 * NW) {
      float acc[NP / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        const int s0 = 16 * kk;
        uint32_t x4[4], a[4], al[4];
        // A = U^T (rows d, columns s): matrices (s0, d0), (s0, d0 + 8),
        // (s0 + 8, d0), (s0 + 8, d0 + 8), transposed; U = w x split into
        // bf16 high (a) and low (al) parts
        ldsm_x4_t(x4, xs + (s0 + r8 + (mi >> 1) * 8) * L::XS + d0 +
                          (mi & 1) * 8);
        const float w0 = sw[s0 + 2 * q], w1 = sw[s0 + 2 * q + 1];
        const float w2 = sw[s0 + 8 + 2 * q], w3 = sw[s0 + 9 + 2 * q];
        split_bf16(lo_f(x4[0]) * w0, hi_f(x4[0]) * w1, a[0], al[0]);
        split_bf16(lo_f(x4[1]) * w0, hi_f(x4[1]) * w1, a[1], al[1]);
        split_bf16(lo_f(x4[2]) * w2, hi_f(x4[2]) * w3, a[2], al[2]);
        split_bf16(lo_f(x4[3]) * w2, hi_f(x4[3]) * w3, a[3], al[3]);
#pragma unroll
        for (int n0 = 0; n0 < NP; n0 += 16) {
          uint32_t bb[4];
          // B (rows s, columns n): matrices (s0, n0), (s0 + 8, n0),
          // (s0, n0 + 8), (s0 + 8, n0 + 8), transposed
          ldsm_x4_t(bb, bs + (s0 + r8 + (mi & 1) * 8) * L::NS + n0 +
                            (mi >> 1) * 8);
          mma_bf16(acc[n0 / 8], a, bb[0], bb[1]);
          mma_bf16(acc[n0 / 8], al, bb[0], bb[1]);
          mma_bf16(acc[n0 / 8 + 1], a, bb[2], bb[3]);
          mma_bf16(acc[n0 / 8 + 1], al, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int n = 8 * j + 2 * q;
        if (n >= p.N) continue;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int d = d0 + g + 8 * rr;
          if (d < p.hd)
            *reinterpret_cast<float2*>(dh + d * p.N + n) =
                make_float2(acc[j][2 * rr], acc[j][2 * rr + 1]);
        }
      }
    }
  }
  if (tid == 0) p.decay[bh * p.n_chunk + chunk] = expf(scum[C - 1]);

  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(p.ticket + bh, 1) == p.n_chunk - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block of (b, h): h_c = exp(cum_C) h_{c-1} + dH_c in chunk
  // order, each dH_c replaced by the state entering chunk c; CB chunks'
  // loads are issued before any of them is used
  __threadfence();
  constexpr int EPT = (HDP * NP + NT - 1) / NT;   // elements a thread
  constexpr int CB = EPT >= 64 ? 1 : 64 / EPT;
  float* base = p.dh + bh * p.n_chunk * hdN;
  const float* dec = p.decay + bh * p.n_chunk;
  float st[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int e = tid + k * NT;
    st[k] = e < hdN ? p.s0[bh * hdN + e] : 0.f;
  }
  for (int c0 = 0; c0 < p.n_chunk; c0 += CB) {
    float dv[CB][EPT], av[CB];
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      const int c = c0 + i;
      av[i] = c < p.n_chunk ? __ldcg(dec + c) : 1.f;
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int e = tid + k * NT;
        dv[i][k] = c < p.n_chunk && e < hdN
                       ? __ldcg(base + static_cast<long long>(c) * hdN + e)
                       : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      const int c = c0 + i;
      if (c >= p.n_chunk) break;
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int e = tid + k * NT;
        if (e < hdN) {
          base[static_cast<long long>(c) * hdN + e] = st[k];
          st[k] = fmaf(av[i], st[k], dv[i][k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int e = tid + k * NT;
    if (e < hdN) p.s_out[bh * hdN + e] = st[k];
  }
  if (tid == 0) p.ticket[bh] = 0;
}

// ---------------------------------------------------------------------------
// kernel 2: outputs, intra-chunk first, then (after kernel 1) inter-chunk
// ---------------------------------------------------------------------------

template <typename T, int HDP, int NP>
__global__ void __launch_bounds__(NT, 1) ssm_chunk_out_kernel(Params p) {
  using L = Layout<T, HDP, NP>;
  extern __shared__ __align__(16) unsigned char sm[];
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = stage_chunk<T, HDP, NP, true>(p, sm, chunk, h, b);
  const T* xs = reinterpret_cast<const T*>(sm + L::x_off);
  const T* bs = reinterpret_cast<const T*>(sm + L::b_off);
  const T* cs = reinterpret_cast<const T*>(sm + L::c_off);
  T* hs = reinterpret_cast<T*>(sm + L::h_off);
  const float* sdt = reinterpret_cast<const float*>(sm + L::v_off);
  const float* scum = sdt + C;

  const long long bh = static_cast<long long>(b) * p.H + h;
  const int hdN = p.hd * p.N;
  const float* hin = p.dh + (bh * p.n_chunk + chunk) * hdN;
  T* y = static_cast<T*>(p.y) +
         ((static_cast<long long>(b) * p.T + chunk * C) * p.H + h) * p.hd;
  const long long y_st = static_cast<long long>(p.H) * p.hd;

  if constexpr (L::F32) {
    // scores S[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s, s <= t
    float* ss = reinterpret_cast<float*>(sm + L::s_off);
    for (int i = tid; i < C * C; i += NT) {
      const int t = i / C, s = i % C;
      float v = 0.f;
      if (s <= t) {
        float cb = 0.f;
        for (int n = 0; n < p.N; ++n)
          cb = fmaf(cs[t * L::NS + n], bs[s * L::NS + n], cb);
        v = cb * expf(scum[t] - scum[s]) * sdt[s];
      }
      ss[t * L::SS + s] = v;
    }
    __syncthreads();
    // thread (tr, dc) owns rows tr + 16 i and columns dc + 8 j
    constexpr int NJ = HDP / 8;
    const int tr = tid >> 3, dc = tid & 7;
    float acc[4][NJ] = {};
    for (int s = 0; s < C; ++s) {
      float sv[4], xv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ss[(tr + 16 * i) * L::SS + s];
#pragma unroll
      for (int j = 0; j < NJ; ++j) xv[j] = xs[s * L::XS + dc + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
    }
    // the entering state, once the first kernel has written it
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    float* hf = reinterpret_cast<float*>(hs);    // [HDP][NS] fp32
    for (int i = tid; i < HDP * NP; i += NT) {
      const int d = i / NP, n = i % NP;
      hf[d * L::NS + n] =
          d < p.hd && n < p.N ? __ldcg(hin + d * p.N + n) : 0.f;
    }
    __syncthreads();
    float inter[4][NJ] = {};
    for (int n = 0; n < p.N; ++n) {
      float cv[4], hv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cs[(tr + 16 * i) * L::NS + n];
#pragma unroll
      for (int j = 0; j < NJ; ++j) hv[j] = hf[(dc + 8 * j) * L::NS + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          inter[i][j] = fmaf(cv[i], hv[j], inter[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tr + 16 * i;
      if (t >= len) continue;
      const float et = expf(scum[t]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = dc + 8 * j;
        if (d < p.hd) y[t * y_st + d] = fmaf(et, inter[i][j], acc[i][j]);
      }
    }
  } else {
    const int g = lane >> 2, q = lane & 3, r8 = lane & 7, mi = lane >> 3;
    const int t_lo = 16 * warp + g, t_hi = t_lo + 8;
    // C rows t_lo, t_hi as A fragments (k = n), for CB and the inter term
    uint32_t ca[NP / 16][4];
    const uint32_t* cs32 = reinterpret_cast<const uint32_t*>(cs);
    const uint32_t* bs32 = reinterpret_cast<const uint32_t*>(bs);
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const int c0 = 8 * kk + q;                 // in bf16 pairs
      ca[kk][0] = cs32[t_lo * L::NS / 2 + c0];
      ca[kk][1] = cs32[t_hi * L::NS / 2 + c0];
      ca[kk][2] = cs32[t_lo * L::NS / 2 + c0 + 4];
      ca[kk][3] = cs32[t_hi * L::NS / 2 + c0 + 4];
    }
    // scores: n-tiles j of s (8 each) up to this warp's diagonal, masked
    // by a select, split into bf16 high (sa) and low (sl) parts as the A
    // fragments of S X (k-steps 0..warp)
    uint32_t sa[C / 16][4], sl[C / 16][4];
    const float cum_lo = scum[t_lo], cum_hi = scum[t_hi];
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      if (kk > warp) break;
      float sc[2][4] = {};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int sr = 16 * kk + 8 * jj + g;    // B row of this lane
#pragma unroll
        for (int k2 = 0; k2 < NP / 16; ++k2)
          mma_bf16(sc[jj], ca[k2], bs32[sr * L::NS / 2 + 8 * k2 + q],
                   bs32[sr * L::NS / 2 + 8 * k2 + q + 4]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = 16 * kk + 8 * jj + 2 * q + e;
          const float ws = sdt[s], cs_ = scum[s];
          sc[jj][e] = s <= t_lo ? sc[jj][e] * expf(cum_lo - cs_) * ws : 0.f;
          sc[jj][2 + e] =
              s <= t_hi ? sc[jj][2 + e] * expf(cum_hi - cs_) * ws : 0.f;
        }
      }
      split_bf16(sc[0][0], sc[0][1], sa[kk][0], sl[kk][0]);
      split_bf16(sc[0][2], sc[0][3], sa[kk][1], sl[kk][1]);
      split_bf16(sc[1][0], sc[1][1], sa[kk][2], sl[kk][2]);
      split_bf16(sc[1][2], sc[1][3], sa[kk][3], sl[kk][3]);
    }
    // Y = S X: B = X (rows s, columns d), two n-tiles of d per ldmatrix
    float acc[HDP / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      if (kk > warp) break;
#pragma unroll
      for (int d0 = 0; d0 < HDP; d0 += 16) {
        uint32_t bb[4];
        ldsm_x4_t(bb, xs + (16 * kk + r8 + (mi & 1) * 8) * L::XS + d0 +
                          (mi >> 1) * 8);
        mma_bf16(acc[d0 / 8], sa[kk], bb[0], bb[1]);
        mma_bf16(acc[d0 / 8], sl[kk], bb[0], bb[1]);
        mma_bf16(acc[d0 / 8 + 1], sa[kk], bb[2], bb[3]);
        mma_bf16(acc[d0 / 8 + 1], sl[kk], bb[2], bb[3]);
      }
    }
    // the entering state, once the first kernel has written it, as bf16
    // high and low parts
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    T* hl = hs + HDP * L::NS;
    for (int i = tid; i < HDP * NP / 2; i += NT) {
      const int d = i / (NP / 2), n = 2 * (i % (NP / 2));
      float2 v = make_float2(0.f, 0.f);
      if (d < p.hd && n < p.N) v = __ldcg(reinterpret_cast<const float2*>(
                                   hin + d * p.N + n));
      uint32_t hi, lo;
      split_bf16(v.x, v.y, hi, lo);
      reinterpret_cast<uint32_t*>(hs)[(d * L::NS + n) / 2] = hi;
      reinterpret_cast<uint32_t*>(hl)[(d * L::NS + n) / 2] = lo;
    }
    __syncthreads();
    const uint32_t* hs32 = reinterpret_cast<const uint32_t*>(hs);
    const uint32_t* hl32 = reinterpret_cast<const uint32_t*>(hl);
    const float e_lo = expf(cum_lo), e_hi = expf(cum_hi);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      float it[4] = {};
      const int hr = (8 * j + g) * L::NS / 2;
#pragma unroll
      for (int k2 = 0; k2 < NP / 16; ++k2) {
        mma_bf16(it, ca[k2], hs32[hr + 8 * k2 + q], hs32[hr + 8 * k2 + q + 4]);
        mma_bf16(it, ca[k2], hl32[hr + 8 * k2 + q], hl32[hr + 8 * k2 + q + 4]);
      }
      acc[j][0] = fmaf(e_lo, it[0], acc[j][0]);
      acc[j][1] = fmaf(e_lo, it[1], acc[j][1]);
      acc[j][2] = fmaf(e_hi, it[2], acc[j][2]);
      acc[j][3] = fmaf(e_hi, it[3], acc[j][3]);
    }
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int d = 8 * j + 2 * q;
      if (d >= p.hd) continue;
      if (t_lo < len)
        *reinterpret_cast<uint32_t*>(y + t_lo * y_st + d) =
            pack_bf16(acc[j][0], acc[j][1]);
      if (t_hi < len)
        *reinterpret_cast<uint32_t*>(y + t_hi * y_st + d) =
            pack_bf16(acc[j][2], acc[j][3]);
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

template <typename T, int HDP, int NP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, HDP, NP>::bytes;
  auto k1 = ssm_chunk_state_kernel<T, HDP, NP>;
  auto k2 = ssm_chunk_out_kernel<T, HDP, NP>;
  if (smem > 48 * 1024) {
    // once per device: a host call per launch would add to the
    // enqueueing cost
    static unsigned done = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 32 || !(done >> dev & 1u)) {
      if ((err = allow_smem(k1, smem)) != cudaSuccess) return err;
      if ((err = allow_smem(k2, smem)) != cudaSuccess) return err;
      if (dev < 32) done |= 1u << dev;
    }
  }
  const dim3 grid(p.n_chunk, p.H, p.B);
  k1<<<grid, NT, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
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
  err = cudaLaunchKernelEx(&cfg, k2, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int HDP>
cudaError_t launch_n(const Params& p, cudaStream_t stream) {
  if (p.N <= 16) return launch<T, HDP, 16>(p, stream);
  return launch<T, HDP, 32>(p, stream);
}

template <typename T>
cudaError_t launch_hd(const Params& p, cudaStream_t stream) {
  if (p.hd <= 16) return launch_n<T, 16>(p, stream);
  if (p.hd <= 32) return launch_n<T, 32>(p, stream);
  if (p.hd <= 64) return launch_n<T, 64>(p, stream);
  return launch_n<T, 128>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y); dt, A and the
// states are fp32 always. Strides are in elements; x, dt's head axis, Bm
// and Cm are contiguous along their last axis; y and the states are
// contiguous. hd is a multiple of 8 up to 128; N is 4, 8, 16 or 32.
// n_chunk must be ceil(T / 64); dh holds B H n_chunk hd N fp32, decay
// B H n_chunk fp32, and ticket B H int32 zeros (the kernels leave them
// zero). x_vec: x's base is 16-byte aligned and its strides whole 16-byte
// units; bc_vec: the same of Bm and Cm, whose rows (N values) are whole
// 16-byte units too. Returns the launches' cudaError_t (0 = launched).
extern "C" int ssm_scan_fwd(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* s0, void* y, float* s_out, float* dh,
    float* decay, int* ticket,
    int B, int T, int H, int hd, int N, int n_chunk,
    long long x_sb, long long x_st, long long x_sh,
    long long dt_sb, long long dt_st, long long dt_sh,
    long long b_sb, long long b_st, long long c_sb, long long c_st,
    int x_vec, int bc_vec, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535 || hd <= 0 ||
      hd > 128 || hd % 8 != 0 ||
      !(N == 4 || N == 8 || N == 16 || N == 32) ||
      n_chunk != (T + C - 1) / C || dh == nullptr || decay == nullptr ||
      ticket == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dt, A, Bm, Cm, s0, y, s_out, dh, decay, ticket,
           B, T, H, hd, N, n_chunk,
           x_sb, x_st, x_sh, dt_sb, dt_st, dt_sh, b_sb, b_st, c_sb, c_st,
           x_vec, bc_vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(p, s);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(p, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
