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

constexpr int BQ = 64;        // q rows per block: one m64 wgmma tile
constexpr int BKV = 64;       // kv columns per tile
constexpr int NT = 128;       // one warpgroup
constexpr int STAGES = 2;     // k/v ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Geo {
  static constexpr int SWB = HD >= 64 ? 128 : 64;  // swizzle span: bytes a
                                                   // shared-memory row holds
  static constexpr int CW = SWB / 2;               // columns per TMA box
  static constexpr int NBOX = HD / CW;             // boxes per tile row
  static constexpr int LAYOUT = SWB == 128 ? 1 : 2;  // descriptor: B128, B64
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;    // one k or v tile
  // 1024 bytes of slack to align the tiles to the swizzle atom, the q
  // tile, the ring, and the 1 + STAGES mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// rows x HD of (head, b) from row0 into dst: NBOX boxes of rows x CW, each
// rows x SWB bytes, swizzled
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int row0,
                                          int b, int rows) {
  using G = Geo<HD>;
#pragma unroll
  for (int i = 0; i < G::NBOX; ++i)
    tma_load(dst + i * rows * G::SWB, map, bar, i * G::CW, head, row0, b);
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout
template <int HD>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  using G = Geo<HD>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(((8 * G::SWB) >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(G::LAYOUT) << 62);
}

// K-major operand (ROWS x HD, reduced along HD), k16 slice kk: inside a
// box, a slice starts 32 bytes after the previous one; 8-row groups are
// 8 * SWB bytes apart (SBO); LBO is unused for swizzled K-major
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk) {
  using G = Geo<HD>;
  constexpr int per_box = G::CW / 16;
  return make_desc<HD>(base + (kk / per_box) * ROWS * G::SWB +
                           (kk % per_box) * 32, 16);
}

// V (BKV kv rows x HD), MN-major B operand of O += P V, k16 slice kk (kv
// rows 16kk..16kk+15): 8-row groups SWB * 8 bytes apart (SBO), the next
// CW columns of hd one box (BKV * SWB bytes) on (LBO)
template <int HD>
__device__ __forceinline__ uint64_t vdesc(uint32_t base, int kk) {
  using G = Geo<HD>;
  return make_desc<HD>(base + kk * 16 * G::SWB, BKV * G::SWB);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pin registers an async wgmma reads or writes to this point of the
// program, so the compiler moves no access across the fence or wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// S (+)= A B^T, m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O += P V, m64n{32,64,128}k16, P (A) in registers, V (B) MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (HD == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

// 2^x on the SFU; flushes a denormal result to 0 (p below 2^-126 adds
// nothing next to the row's largest term, 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map over (hd, heads, S, B) with the caller's strides (elements),
// boxes of CW x 1 x rows x 1. A size-1 axis has no stride to honour, so it
// gets the packed one (TMA wants every stride a multiple of 16 bytes).
template <int HD>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int S,
              int heads, int B, long long sb, long long ss, long long sh,
              int rows) {
  using G = Geo<HD>;
  if (heads == 1) sh = HD;
  if (S == 1) ss = sh * heads;
  if (B == 1) sb = ss * S;
  const cuuint64_t dim[4] = {HD, static_cast<cuuint64_t>(heads),
                             static_cast<cuuint64_t>(S),
                             static_cast<cuuint64_t>(B)};
  const cuuint64_t stride[3] = {static_cast<cuuint64_t>(sh) * 2,
                                static_cast<cuuint64_t>(ss) * 2,
                                static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {G::CW, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dim, stride, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                G::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
