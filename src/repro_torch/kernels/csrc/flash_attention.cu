// Flash-attention forward for Hopper (sm_90a), prefill / packed fragments.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/flash_attention.py::flash_attention (_attn_kernel):
//     causal / sliding-window / per-token segment-id masks, fully-masked
//     rows give 0;
//   * src/repro/kernels/flash_attention_bwd.py::_flash_fwd (_fwd_kernel):
//     the same forward without segments, plus the per-row logsumexp.
// One entry point serves both: the segment pointer and the lse pointer are
// optional (null = off).
//
// The dtype picks the kernel; there is no switch and no fallback between
// the two:
//   * bfloat16 -> attn_fwd_wgmma, both tile products on the tensor cores
//     (wgmma), operands fed by TMA (below);
//   * float32  -> attn_fwd_scalar, scalar fp32 FMA. wgmma has no fp32
//     operands, only TF32 (about 3 decimal digits), which would not hold
//     the fp32 checks (2e-5 against the plain version).
//
// What bounds it on the card. At the main-path shapes (a packed buffer of
// ~2048 tokens, H=16, KV=8, hd=128, bf16) q, k, v and o are ~12 KiB per
// token, and the segment mask confines each row to its own request, so
// the work per byte is low: its bound is the memory, not the FLOPs. Both
// kernels read each input element from device memory once per (q tile,
// head), keep the (m, l, o) online-softmax state in registers (scores and
// probabilities never touch device memory), never load kv tiles before
// the sliding window's first tile, past the causal frontier, or (packed)
// holding no segment id the q tile holds; they read q, k and v in the JAX
// layout (B, S, H, hd) through strides (no transpose copy), and GQA reads
// kv head h / (H / KV) directly.
//
// The bf16 kernel: one warpgroup (128 threads) per (64-row q tile, b*h),
// q tiles taken longest first. TMA loads the q tile once and 64-column k
// and v tiles through a 2-stage ring in shared memory, each stage with
// an mbarrier; thread 0 issues tile t+1's loads while S of tile t runs
// on the tensor cores.
// The tensor maps are 4-D over (hd, heads, S, B) with the caller's
// strides and a 128-byte swizzle (64-byte at hd 32); a 256-byte row (hd
// 128) is two 64-column boxes. S = Q K^T is wgmma m64n64k16 with both
// operands K-major in shared memory; masks and the online softmax run on
// the fp32 accumulator fragment (thread (warp w, lane l) holds rows 16w +
// l/4 and +8, columns 8j + 2(l%4) + {0,1}), rows reduced over the 4 lanes
// of a quad; O += P V is wgmma m64n{hd}k16 with P packed to bf16 pairs in
// registers (the accumulator layout is the A-fragment layout) and V read
// MN-major (transposed) from shared memory. l sums the fp32
// probabilities; the exponentials run on the SFU (ex2.approx.ftz, the
// scale folded into log2 units). Packed batches: per kv tile the (min,
// max) segment id is reduced within each warp (no block barrier) and a
// tile whose range misses the q tile's is not loaded. A tile inside the
// causal frontier, the window and Sk whose ids all equal the q tile's one
// id skips the masks; every other tile applies them exactly, branch-free
// per element. One block's tiles run in sequence (S, softmax, P V), so
// at the main-path shapes a block's time is that chain's latency, not
// the card's FLOP or byte rate; the softmax is the longest link.
//
// The fp32 kernel: BQ=64 query rows x BK=32 kv columns per step, 128
// threads laid out 16 (ty) x 8 (tx), operands staged in shared memory as
// fp32, a block-wide vote per kv tile for segment overlap.
//
// Both: masked entries get p = 0, so a row whose first kv tiles are all
// masked adds nothing to l or o before its first valid tile, and l == 0
// at the end (a row with no valid kv) gives 0 and lse = NEG_INF.
//
// The TMA, mbarrier, descriptor and wgmma helpers are in hopper.cuh,
// shared with the backward (flash_attention_bwd.cu).
//
// C entry point: flash_attention_fwd(...) launches on the given stream and
// returns a cudaError_t as an int (0 = launched). cuTensorMapEncodeTiled
// is reached through cudaGetDriverEntryPoint, so the library links
// against the runtime only.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

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

// ---------------------------------------------------------------------------
// float32: scalar FMA
// ---------------------------------------------------------------------------

namespace scalar {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int NT = 128;
constexpr int RPT = BQ / 16;   // query rows per thread
constexpr int CPT = BK / 8;    // score columns per thread
constexpr int KP = BK + 1;     // pitch of the transposed k tile
constexpr int PP = BK + 2;     // pitch of the probability tile

static_assert(RPT == 4, "the q tile is read as float4 per thread");

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int HD>
constexpr int smem_bytes() {
  return (HD * BQ + HD * KP + BK * HD + BQ * PP) * 4 + (BQ + BK) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) attn_fwd_scalar(Params p) {
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
      attn_fwd_scalar<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  attn_fwd_scalar<T, HD><<<grid, NT, smem, stream>>>(p);
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

}  // namespace scalar

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int BQ = 64;        // q rows per block: one m64 wgmma tile
constexpr int BKV = 64;       // kv columns per tile
constexpr int NT = 128;       // one warpgroup
constexpr int STAGES = 2;     // k/v ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Geo : Swz<HD> {
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;    // one k or v tile
  // 1024 bytes of slack to align the tiles to the swizzle atom, the q
  // tile, the ring, and the 1 + STAGES mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 64;
};

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = max(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int HD>
__global__ void __launch_bounds__(NT, 1) attn_fwd_wgmma(
    const __grid_constant__ CUtensorMap tmq,
    const __grid_constant__ CUtensorMap tmk,
    const __grid_constant__ CUtensorMap tmv, const Params p) {
  using G = Geo<HD>;
  constexpr int NO = HD / 2;     // O accumulator floats per thread
  constexpr int NS = BKV / 2;    // S accumulator floats per thread
  constexpr int KS = BKV / 16;   // k16 slices of P V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + G::Q_BYTES;   // stage s: k, then v
  const uint32_t bars = sKV + STAGES * 2 * G::KV_BYTES;  // q, stage 0, 1...

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest tiles first
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int g = h / (p.H / p.KV);
  const bool has_seg = p.seg != nullptr;
  const int* seg = has_seg ? p.seg + b * p.seg_sb : nullptr;

  // kv range this q tile can see: from the window's first column to the
  // causal frontier of its last real row
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;   // exclusive
  const int t_lo = k_lo / BKV;
  const int t_hi = (k_hi + BKV - 1) / BKV;

  // this thread's rows (local rl and rl + 8) and column offset in each
  // 8-column block of the accumulator fragment
  const int rl = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int qmin = INT_MAX, qmax = INT_MIN, sq[2] = {0, 0};
  if (has_seg) {
    for (int r = q0 + lane; r <= q_last; r += 32) {
      qmin = min(qmin, seg[r]);
      qmax = max(qmax, seg[r]);
    }
    qmin = warp_min(qmin);
    qmax = warp_max(qmax);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      if (q0 + rl + 8 * rr < p.Sq) sq[rr] = seg[q0 + rl + 8 * rr];
  }
  // the first tile at or after t that may hold one of the q tile's
  // segment ids, and its (min, max) id; every warp computes the same
  auto next_tile = [&](int t, int& lo, int& hi) {
    for (; t < t_hi; ++t) {
      if (!has_seg) return t;
      lo = INT_MAX;
      hi = INT_MIN;
      for (int c = t * BKV + lane; c < min((t + 1) * BKV, p.Sk); c += 32) {
        lo = min(lo, seg[c]);
        hi = max(hi, seg[c]);
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      if (lo <= qmax && hi >= qmin) return t;
    }
    return t_hi;
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_map(&tmq);
    prefetch_map(&tmk);
    prefetch_map(&tmv);
  }
  __syncthreads();
  int klo = 0, khi = 0;
  int t = next_tile(t_lo, klo, khi);
  if (tid == 0) {
    mbar_expect_tx(bars, G::Q_BYTES);
    load_tile<HD>(sQ, &tmq, bars, h, q0, b, BQ);
    if (t < t_hi) {
      mbar_expect_tx(bars + 8, 2 * G::KV_BYTES);
      load_tile<HD>(sKV, &tmk, bars + 8, g, t * BKV, b, BKV);
      load_tile<HD>(sKV + G::KV_BYTES, &tmv, bars + 8, g, t * BKV, b, BKV);
    }
  }

  float o[NO], s[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = p.scale * LOG2E;   // scores in log2 units: exp2f
  mbar_wait(bars, 0);

  for (int it = 0; t < t_hi; ++it) {
    int nlo = 0, nhi = 0;
    const int tn = next_tile(t + 1, nlo, nhi);
    const int st = it % STAGES;
    mbar_wait(bars + 8 * (1 + st), (it / STAGES) & 1);
    const uint32_t sK = sKV + st * 2 * G::KV_BYTES;
    const uint32_t sV = sK + G::KV_BYTES;

    // S = Q K^T
    reg_fence(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<HD, BQ>(sQ, kk),
                   kmajor_desc<HD, BKV>(sK, kk), kk > 0);
    wg_commit();
    if (tid == 0 && tn < t_hi) {
      // tile it + 1 into the stage tile it - 1 used: every warp left it
      // at the barrier that ended that iteration
      const int sn = (it + 1) % STAGES;
      const uint32_t bar = bars + 8 * (1 + sn);
      const uint32_t dst = sKV + sn * 2 * G::KV_BYTES;
      mbar_expect_tx(bar, 2 * G::KV_BYTES);
      load_tile<HD>(dst, &tmk, bar, g, tn * BKV, b, BKV);
      load_tile<HD>(dst + G::KV_BYTES, &tmv, bar, g, tn * BKV, b, BKV);
    }
    wg_wait0();
    reg_fence(s);

    // masks (only where the tile needs them), then the online softmax
    const int k0 = t * BKV;
    const bool need_mask =
        k0 + BKV > p.Sk || (p.causal && k0 + BKV - 1 > q0) ||
        (p.window > 0 && q0 + BQ - 1 - k0 >= p.window) ||
        (has_seg && !(klo == khi && qmin == qmax && klo == qmin));
#pragma unroll
    for (int x = 0; x < NS; ++x) s[x] *= sl2;
    if (need_mask) {
      // columns this thread's rows may see: [lo, hi]; then equal ids
      int sk[NS / 4][2];
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 8 * j + cq + e;
          sk[j][e] = has_seg && c < p.Sk ? seg[c] : 0;
        }
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
            const bool ok = (c >= lo) & (c <= hi) & (sq[rr] == sk[j][e]);
            const int x = 4 * j + 2 * rr + e;
            s[x] = ok ? s[x] : -INFINITY;
          }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx = fmaxf(mx, s[4 * j + 2 * rr + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = exp2_ftz(m[rr] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * rr + e;
          s[x] = exp2_ftz(s[x] - m_new);   // masked: exp2(-inf) = 0
          rs += s[x];
        }
      // l stays per thread (its quad's share of the row) until the end
      l[rr] = alpha * l[rr] + rs;
      m[rr] = m_new;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        o[4 * j + 2 * rr] *= alpha;
        o[4 * j + 2 * rr + 1] *= alpha;
      }
    }

    // O += P V, P as the register A operand: slice kk takes accumulator
    // columns 16kk..16kk+15, i.e. s[8kk .. 8kk+7] in A-fragment order
    uint32_t pa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    reg_fence(o);
    reg_fence(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_pv<HD>(o, pa[kk], vdesc<HD>(sV, kk));
    wg_commit();
    wg_wait0();
    reg_fence(o);
    reg_fence(pa);
    __syncthreads();   // the stage is free for the load of tile it + 2
    t = tn;
    klo = nlo;
    khi = nhi;
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                       h * p.o_sh;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lr = l[rr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int r = q0 + rl + 8 * rr;
    if (r >= p.Sq) continue;
    const float inv = lr == 0.f ? 0.f : 1.f / lr;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + r * p.o_ss + 8 * j + cq) =
          __floats2bfloat162_rn(o[4 * j + 2 * rr] * inv,
                                o[4 * j + 2 * rr + 1] * inv);
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + r] =
          lr == 0.f ? NEG_INF : m[rr] * LN2 + logf(lr);
  }
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using G = Geo<HD>;
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map<HD>(encode, &mq, p.q, p.Sq, p.H, p.B, p.q_sb, p.q_ss, p.q_sh,
                    BQ))
    return cudaErrorInvalidValue;
  if (p.Sk == 0) {   // no kv tile is loaded: every row gives 0
    mk = mv = mq;
  } else if (!make_map<HD>(encode, &mk, p.k, p.Sk, p.KV, p.B, p.k_sb, p.k_ss,
                           p.k_sh, BKV) ||
             !make_map<HD>(encode, &mv, p.v, p.Sk, p.KV, p.B, p.v_sb, p.v_ss,
                           p.v_sh, BKV)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  attn_fwd_wgmma<HD><<<grid, NT, G::SMEM, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

cudaError_t launch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(p, stream);
    case 64: return launch<64>(p, stream);
    case 128: return launch<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32 (the scalar kernel), 1 = bfloat16 (the wgmma
// kernel). Strides are in elements. Returns the launch's cudaError_t (0 =
// launched).
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
    err = scalar::launch_hd<float>(p, hd, s);
  else if (dtype == 1)
    err = wg::launch_hd(p, hd, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
