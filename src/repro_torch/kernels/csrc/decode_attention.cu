// Flash-decoding for Hopper (sm_90a): one query token per batch row
// against a KV cache that may be a ring buffer, in one launch.
//
// Replaces the Pallas TPU kernel of the JAX package
// src/repro/kernels/decode_attention.py::decode_attention (pallas_call ->
// _decode_kernel): q (B,1,H,hd) against k/v (B,Sk,KV,hd); a slot is
// masked where kv_pos < 0 (unwritten), kv_pos > q_pos, or, with a window,
// q_pos - kv_pos >= window; softmax in fp32; q head h reads kv head
// h / (H / KV). A row with no valid slot gives 0, as the plain version
// does (the TPU kernel gives the mean of v there: while its running max
// is still -1e30, every masked entry adds p = exp(0) = 1).
//
// What bounds it on the card: bytes. Every k and v element is read once
// and used for 2 G FLOPs (G = H / KV, 2 to 16 q heads per kv head), so at
// the main-path shape (B=4, Sk=512, H=16, KV=8, hd=128, bf16: 8.4 MB of k
// and v) the FLOPs are negligible and the least time is the bytes over
// the memory rate (2.5 us). What stands between a kernel and that bound
// is latency: the bytes in flight per SM, the serial steps after they
// land, and launches. The TPU grid walks (B, KV, Sk/bk) in order and
// carries (m, l, acc) across kv blocks in VMEM scratch; CUDA blocks run in
// no order, so the design is:
//
// * one block of 8 warps per (split, kv head, batch row) of SPLIT = 64
//   positions handles the whole GQA group, so each k/v row is read once
//   for all the q heads that use it; 8 splits x 8 kv heads x 4 rows = 256
//   blocks for 132 SMs at the main-path shape. Of 4, 8 and 16 warps and
//   splits of 32, 64 and 128, measured on the card (PERF.md), 8 warps
//   and 64 were the fastest or within noise of it at both decode shapes
//   of the main paths (qwen3 and hymba, 512 slots);
// * the block first reads the split's kv_pos and decides which rows are
//   valid, then issues the whole split's K and V at once: 16-byte
//   cp.async copies into shared memory (32 KB per block in bf16 at hd
//   128), K in one commit group and V in the next, so the scores run
//   while V still lands. Rows that are masked are zero-filled without
//   being read (cp.async with a source size of 0). The cache is read
//   through its strides as the (B, Sc, KV, hd) layer view: no transpose
//   copy and no tensor map built per call;
// * one softmax per split, not per position: lanes split hd into 16-byte
//   chunks and each row group of lanes reduces its G dot products with
//   shuffles into a G x SPLIT score table in shared memory; one warp per
//   head then takes the max and the sum once. A masked slot gets p = 0 by
//   a select (never a multiply), so a row with no valid slot has l = 0
//   and gives exactly 0;
// * P V: each warp sums every eighth row of the split, each lane owning
//   hd / 32 columns of all G heads; masked rows are skipped (a branch
//   uniform across the warp); the eight warps' sums add in a fixed order;
// * the splits merge in the same launch: each block writes its partial
//   (m, l, acc) in fp32 to scratch, then __threadfence() and an atomic
//   ticket per (b, kv head); the last block to arrive merges all the
//   splits in split order (one pass, rescaling as the running max grows,
//   every split's loads in flight together), so the result does not
//   depend on the order in which blocks arrive, and resets its ticket to
//   0 for the next launch.
//   The wrapper allocates the ticket and partial buffers once per device
//   and grows them; the tickets assume one launch in flight at a time,
//   that is, one stream at a time. With one split the block writes the
//   output itself;
// * where the caller passes an lse buffer, the thread that writes column
//   0 of a head's output also writes its log-sum-exp, m + log l from the
//   merged state (-inf where l = 0). A cache whose sequence is sharded
//   over ranks then merges the ranks' outputs with all-reduces of B H
//   (hd + 2) values (distributed/spmd.py::merge_softmax) instead of
//   gathering the cache. Without the buffer the launch is as it was.
//
// The split length is fixed, so which positions a block, a warp and a
// lane handle depends on neither B nor Sk: a row's result is the same,
// bit for bit, whether it runs alone or in a batch, and whatever the
// cache capacity past its last valid slot (extra splits merge as exact
// zeros, after the real ones). Greedy decode served in a batch of 4 then
// sees the attention of the unbatched reference exactly.
//
// Arithmetic is fp32 scalar FMA in both dtypes: at 2 G FLOPs a loaded
// element, tensor cores would not shorten a kernel that waits on bytes.
//
// C entry point: decode_attention_fwd(...) launches on the given stream
// and returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;          // warps per block
constexpr int NT = NW * 32;
constexpr int SPLIT = 64;      // kv positions per split (kept in step with
                               // kernels/decode_attention.py::SPLIT)
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;      // (B,)
  const int* kv_pos;     // (B, Sk), contiguous along Sk
  void* o;
  float* lse;            // (B, H) fp32, or null: each row's log-sum-exp
  float* part_acc;       // (B, KV, n_split, G, hd); unused with one split
  float* part_ml;        // (B, KV, n_split, G, 2): m, l
  int* ticket;           // (B, KV), zero between launches
  int B, Sk, H, KV, n_split;
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long kvp_sb;
  long long o_sb, o_sh;
  float scale;
  int window;
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the VEC values of one 16-byte chunk, as fp32
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes from global to shared; src_bytes 0 writes zeros and reads
// nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// CPT consecutive values of one row, as fp32
template <int CPT>
__device__ __forceinline__ void load_cols(const float* p, float (&f)[CPT]) {
  if constexpr (CPT == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  } else if constexpr (CPT == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    f[0] = u.x; f[1] = u.y;
  } else {
    f[0] = p[0];
  }
}
template <int CPT>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&f)[CPT]) {
  if constexpr (CPT == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    f[0] = __uint_as_float(u.x << 16); f[1] = __uint_as_float(u.x & ~0xffffu);
    f[2] = __uint_as_float(u.y << 16); f[3] = __uint_as_float(u.y & ~0xffffu);
  } else if constexpr (CPT == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    f[0] = __uint_as_float(u << 16); f[1] = __uint_as_float(u & ~0xffffu);
  } else {
    f[0] = __bfloat162float(p[0]);
  }
}

template <typename T, int HD, int MAXG>
struct Smem {
  static constexpr int VEC = 16 / sizeof(T);     // values per 16 bytes
  static constexpr int CPR = HD / VEC;           // 16-byte chunks per row
  static constexpr size_t kv = SPLIT * HD * sizeof(T);
  static constexpr size_t bytes =
      2 * kv                                     // K, V
      + sizeof(float) * MAXG * SPLIT             // scores, then p
      + sizeof(float) * NW * MAXG * HD           // each warp's P V sums
      + sizeof(int) * SPLIT;                     // row valid
};

template <typename T, int HD, int MAXG>
__global__ void __launch_bounds__(NT, 1) decode_attn_kernel(Params p) {
  using S = Smem<T, HD, MAXG>;
  constexpr int VEC = S::VEC, CPR = S::CPR;
  constexpr int RPW = 32 / CPR;                  // rows per warp step
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = reinterpret_cast<T*>(smem + S::kv);
  float* sp = reinterpret_cast<float*>(smem + 2 * S::kv);  // [MAXG][SPLIT]
  float* sred = sp + MAXG * SPLIT;                         // [NW][MAXG][HD]
  int* sok = reinterpret_cast<int*>(sred + NW * MAXG * HD);
  __shared__ float s_m[MAXG], s_l[MAXG];   // each head's max and sum
  __shared__ int s_last;

  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h0 = g * G;
  const int s0 = split * SPLIT;
  const int s1 = min(s0 + SPLIT, p.Sk);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h0 * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;

  // which rows of the split are valid: one kv_pos read per row
  if (tid < SPLIT) {
    const int j = s0 + tid;
    bool ok = false;
    if (j < s1) {
      const int qpos = p.q_pos[b];
      const int kp = p.kv_pos[b * p.kvp_sb + j];
      ok = kp >= 0 && kp <= qpos && (p.window <= 0 || qpos - kp < p.window);
    }
    sok[tid] = ok;
  }
  // this lane's 16-byte chunk of q for every head of the group
  const int cidx = lane % CPR;
  float qr[MAXG][VEC];
#pragma unroll
  for (int h = 0; h < MAXG; ++h) {
    if (h < G) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          q + h * p.q_sh + cidx * VEC);
      unpack16(u, qr[h]);
    }
  }
  __syncthreads();

  // the whole split's K, then V, in flight at once
#pragma unroll
  for (int i = tid; i < SPLIT * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = sok[r];
    const long long j = ok ? s0 + r : s0;
    cp_async16(sk + r * HD + c * VEC, k + j * p.k_ss + c * VEC, ok ? 16 : 0);
  }
  cp_async_commit();
#pragma unroll
  for (int i = tid; i < SPLIT * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = sok[r];
    const long long j = ok ? s0 + r : s0;
    cp_async16(sv + r * HD + c * VEC, v + j * p.v_ss + c * VEC, ok ? 16 : 0);
  }
  cp_async_commit();

  // scores: a group of CPR lanes per row, G dot products each
  cp_async_wait<1>();
  __syncthreads();
  for (int r0 = warp * RPW; r0 < SPLIT; r0 += NW * RPW) {
    const int r = r0 + lane / CPR;
    float kf[VEC];
    unpack16(*reinterpret_cast<const uint4*>(sk + r * HD + cidx * VEC), kf);
    const bool ok = sok[r];
#pragma unroll
    for (int h = 0; h < MAXG; ++h) {
      if (h < G) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s = fmaf(qr[h][e], kf[e], s);
#pragma unroll
        for (int off = CPR / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (cidx == 0) sp[h * SPLIT + r] = ok ? s * p.scale : NEG_INF;
      }
    }
  }
  __syncthreads();

  // one softmax per head over the split: max and sum once
  constexpr int PPL = SPLIT / 32;                // positions per lane
  for (int h = warp; h < G; h += NW) {
    float sc[PPL];
    float m = NEG_INF;
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      sc[i] = sp[h * SPLIT + lane + 32 * i];
      m = fmaxf(m, sc[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      const float pr = sok[lane + 32 * i] ? expf(sc[i] - m) : 0.f;
      sp[h * SPLIT + lane + 32 * i] = pr;
      l += pr;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      s_m[h] = m;
      s_l[h] = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // P V: warp w sums rows w, w + NW, ... (skipping masked rows, a branch
  // uniform across the warp); lane l owns columns l CPT .. l CPT + CPT - 1
  // of every head
  {
    constexpr int CPT = HD / 32;
    float acc[MAXG][CPT];
#pragma unroll
    for (int h = 0; h < MAXG; ++h)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[h][c] = 0.f;
    for (int r = warp; r < SPLIT; r += NW) {
      if (!sok[r]) continue;
      float xv[CPT];
      load_cols<CPT>(sv + r * HD + lane * CPT, xv);
#pragma unroll
      for (int h = 0; h < MAXG; ++h) {
        if (h < G) {
          const float pr = sp[h * SPLIT + r];
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[h][c] = fmaf(pr, xv[c], acc[h][c]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < MAXG; ++h)
      if (h < G)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          sred[(warp * MAXG + h) * HD + lane * CPT + c] = acc[h][c];
  }
  __syncthreads();

  const long long bg = static_cast<long long>(b) * p.KV + g;
  if (p.n_split == 1) {
    for (int i = tid; i < G * HD; i += NT) {
      const int h = i / HD, d = i % HD;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) a += sred[(w * MAXG + h) * HD + d];
      const float l = s_l[h];
      T* o = static_cast<T*>(p.o) + b * p.o_sb + (h0 + h) * p.o_sh;
      o[d] = from_f<T>(a / (l == 0.f ? 1.f : l));
      if (p.lse != nullptr && d == 0)
        p.lse[b * p.H + h0 + h] = l == 0.f ? -INFINITY : s_m[h] + logf(l);
    }
    return;
  }

  // write this split's partial state, then take a ticket
  const long long r0 = (bg * p.n_split + split) * G;
  for (int i = tid; i < G * HD; i += NT) {
    const int h = i / HD, d = i % HD;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += sred[(w * MAXG + h) * HD + d];
    p.part_acc[(r0 + h) * HD + d] = a;
  }
  if (tid < G) {
    p.part_ml[2 * (r0 + tid)] = s_m[tid];
    p.part_ml[2 * (r0 + tid) + 1] = s_l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(p.ticket + bg, 1) == p.n_split - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block of (b, kv head): merge every split in split order,
  // rescaling as the running max grows (a trailing split with no valid
  // slot has m = -1e30, l = 0, acc = 0 and leaves l and acc exactly as
  // they were); MB splits' loads are issued before any is used
  __threadfence();
  constexpr int MB = 8;
  const long long base = bg * p.n_split * G;
  for (int i = tid; i < G * HD; i += NT) {
    const int h = i / HD, d = i % HD;
    float mx = NEG_INF, ls = 0.f, a = 0.f;
    for (int s0 = 0; s0 < p.n_split; s0 += MB) {
      float mv[MB], lv[MB], av[MB];
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        const long long rr = base + (s0 + j) * G + h;
        const bool in = s0 + j < p.n_split;
        mv[j] = in ? __ldcg(p.part_ml + 2 * rr) : NEG_INF;
        lv[j] = in ? __ldcg(p.part_ml + 2 * rr + 1) : 0.f;
        av[j] = in ? __ldcg(p.part_acc + rr * HD + d) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        if (s0 + j >= p.n_split) break;
        const float mn = fmaxf(mx, mv[j]);
        const float c_old = expf(mx - mn), c_new = expf(mv[j] - mn);
        ls = fmaf(lv[j], c_new, ls * c_old);
        a = fmaf(av[j], c_new, a * c_old);
        mx = mn;
      }
    }
    T* o = static_cast<T*>(p.o) + b * p.o_sb + (h0 + h) * p.o_sh;
    o[d] = from_f<T>(a / (ls == 0.f ? 1.f : ls));
    if (p.lse != nullptr && d == 0)
      p.lse[b * p.H + h0 + h] = ls == 0.f ? -INFINITY : mx + logf(ls);
  }
  if (tid == 0) p.ticket[bg] = 0;
}

template <typename T, int HD, int MAXG>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, HD, MAXG>::bytes;
  auto kernel = decode_attn_kernel<T, HD, MAXG>;
  if (smem > 48 * 1024) {
    // set once per device (a host call per launch would add to the
    // enqueueing cost that the decode step already waits on)
    static unsigned done = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 32 || !(done >> dev & 1u)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      if (dev < 32) done |= 1u << dev;
    }
  }
  const dim3 grid(p.n_split, p.KV, p.B);
  kernel<<<grid, NT, smem, stream>>>(p);
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
// are contiguous along hd, kv_pos along Sk; q, k and v have 16-byte
// aligned bases and strides of whole 16-byte chunks. lse, where not null,
// receives each (row, head)'s log-sum-exp of its scaled, masked scores
// (B, H contiguous fp32; -inf for a row with no valid slot), so that
// calls over disjoint pieces of one cache (a cache whose sequence is
// sharded over ranks) can be merged. n_split must be
// ceil(Sk / 64); with n_split > 1, part_acc holds B KV n_split G hd fp32,
// part_ml 2 B KV n_split G fp32, and ticket B KV int32 zeros (the kernel
// leaves them zero). Returns the launch's cudaError_t (0 = launched).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* o, float* lse, float* part_acc, float* part_ml,
    int* ticket,
    int B, int Sk, int H, int KV, int hd, int n_split,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long kvp_sb, long long o_sb, long long o_sh,
    float scale, int window, int dtype, void* stream) {
  if (B <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      n_split != (Sk + SPLIT - 1) / SPLIT ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr ||
                       ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, q_pos, kv_pos, o, lse, part_acc, part_ml, ticket,
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
