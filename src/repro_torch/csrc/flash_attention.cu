// Kernel E: the flash-attention forward pass, O = softmax(scale * Q K^T) V,
// with causal and sliding-window masks and grouped-query heads.
//
// Replaces the Pallas kernel `flash_attention_pallas` / `_fa_kernel` of
// src/repro/kernels/flash_attention/kernel.py.  That kernel walks a
// (B*H, Sq/bq, Skv/bk) grid in order, carrying the running max, normaliser
// and accumulator of one query block in VMEM scratch across the innermost
// (key block) grid dimension.  Here one CTA owns one (query row head, 64-row
// query block) and walks the key blocks in a loop, with the running state in
// registers.  It computes the Pallas kernel's function exactly:
//   * query and key positions both count from 0 (left-aligned);
//   * a key is seen when kpos < skv, qpos >= kpos (causal) and
//     qpos - kpos < window (window >= 0);
//   * a masked score is -1e30, its probability 0, and the normaliser is
//     clamped at 1e-30 before the divide, so padded query rows stay finite;
//   * a key block wholly in the causal or window shadow is skipped (it would
//     add nothing: p = 0 and the running max does not move);
//   * query row bh reads KV row (bh / H) * Hkv + (bh % H) / (H / Hkv).
// The arithmetic is float32 throughout, the output rounded once to q's type.
//
// Bound on an H100: operations.  At the prefill shape (B*H = 32, S = 4096,
// D = 128, bf16, causal) the useful work is 2 * S^2 * D * B*H = 1.4e11 FLOP
// against 134 MB of reads and writes, far above the card's ridge point.  This
// version does its products as float32 FMAs outside the tensor cores
// (67 TFLOP/s), so it cannot beat ~2 ms there; wgmma, TMA and warp
// specialisation are in the bfloat16 kernel at the end of the file; this one
// is the float32 path.  Design, for a simple kernel that is right:
//   * 256 threads as a 16 x 16 grid.  Of each 64 x 64 score tile S = Q K^T a
//     thread owns 4 rows x 4 keys, and of the 64 x D output 4 rows x D/16
//     columns: register tiles, so every float4 read from shared memory feeds
//     8 (S) or 16 (P V) FMAs.  A row's 16 threads are one half-warp.
//   * The CTA's scaled Q block and each K tile sit in shared memory
//     transposed (d-major), so a thread's 4 rows or 4 keys at one d are one
//     float4; V tiles and the probabilities (transposed) are float4 rows too.
//   * The row max and the probability sum are 4-shuffle butterflies over the
//     half-warp; the probabilities go through shared memory to every thread
//     of their rows for P V.
//   * Products are explicit fmaf: the library builds with --fmad=false,
//     which stops the compiler fusing on its own but keeps fmaf.
//   * Query blocks are scheduled longest (causal) first to shorten the tail.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void axpy4(float p, float4 x, float4& acc) {
  acc.x = fmaf(p, x.x, acc.x);
  acc.y = fmaf(p, x.y, acc.y);
  acc.z = fmaf(p, x.z, acc.z);
  acc.w = fmaf(p, x.w, acc.w);
}

// The 16 lanes of a half-warp hold one row group: xor offsets below 16 stay
// inside it.
__device__ __forceinline__ float row_max16(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 8));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 4));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 1));
}

__device__ __forceinline__ float row_sum16(float v) {
  v += __shfl_xor_sync(kFull, v, 8);
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 2);
  return v + __shfl_xor_sync(kFull, v, 1);
}

// NC: 64-column groups of the head dim, D = 64 * NC.  Grid: (B*H, Sq / kBQ).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, NC <= 2 ? 2 : 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv, int H,
                           int Hkv, float scale, int causal, int window, int skv) {
  constexpr int D = 64 * NC;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kBQ]: scaled q, transposed
  float* kt = qt + D * kBQ;                     // [D][kBK]: k tile, transposed
  float* vs = kt + D * kBK;                     // [kBK][D]: v tile
  float* pt = vs + kBK * D;                     // [kBK][kBQ]: probabilities, transposed

  const int bh = blockIdx.x;
  const int q_first = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int q_last = q_first + kBQ - 1;
  const int tid = threadIdx.x;
  const int r0 = (tid / 16) * 4;  // this thread's rows r0 .. r0 + 3 of the block
  const int c0 = (tid % 16) * 4;  // its keys c0 .. c0 + 3 of a tile, its columns c0 + 64 c
  const int bkv = (bh / H) * Hkv + (bh % H) / (H / Hkv);

  const T* qbase = q + (static_cast<int64_t>(bh) * Sq + q_first) * D;
  const T* kbase = k + static_cast<int64_t>(bkv) * Skv * D;
  const T* vbase = v + static_cast<int64_t>(bkv) * Skv * D;

  for (int i = tid; i < kBQ * D / 4; i += kThreads) {
    const int row = i % kBQ, d = (i / kBQ) * 4;
    const float4 x = load4(qbase + static_cast<int64_t>(row) * D + d);
    qt[(d + 0) * kBQ + row] = x.x * scale;
    qt[(d + 1) * kBQ + row] = x.y * scale;
    qt[(d + 2) * kBQ + row] = x.z * scale;
    qt[(d + 3) * kBQ + row] = x.w * scale;
  }

  float4 acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int nkb = (skv + kBK - 1) / kBK;  // blocks past skv are wholly masked
  for (int kb = 0; kb < nkb; ++kb) {
    const int k_first = kb * kBK;
    if (causal && k_first > q_last) break;
    if (window >= 0 && k_first + kBK - 1 <= q_first - window) continue;

    __syncthreads();  // every thread is done with the previous tiles (and Q is staged)
    for (int i = tid; i < kBK * D / 4; i += kThreads) {
      const int key = i % kBK, d = (i / kBK) * 4;
      const float4 x = load4(kbase + static_cast<int64_t>(k_first + key) * D + d);
      kt[(d + 0) * kBK + key] = x.x;
      kt[(d + 1) * kBK + key] = x.y;
      kt[(d + 2) * kBK + key] = x.z;
      kt[(d + 3) * kBK + key] = x.w;
      store4(vs + i * 4, load4(vbase + static_cast<int64_t>(k_first) * D + i * 4));
    }
    __syncthreads();

    // s[i] holds the scores of row r0 + i with keys c0 .. c0 + 3
    float4 s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = lds4(qt + d * kBQ + r0);
      const float4 b = lds4(kt + d * kBK + c0);
      axpy4(a.x, b, s[0]);
      axpy4(a.y, b, s[1]);
      axpy4(a.z, b, s[2]);
      axpy4(a.w, b, s[3]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_first + r0 + i;
      float sv[4] = {s[i].x, s[i].y, s[i].z, s[i].w};
      bool ok[4];
      float bmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_first + c0 + j;
        bool seen = kpos < skv;
        if (causal) seen = seen && qpos >= kpos;
        if (window >= 0) seen = seen && qpos - kpos < window;
        ok[j] = seen;
        sv[j] = seen ? sv[j] : kNegInf;
        bmax = fmaxf(bmax, sv[j]);
      }
      const float m_new = fmaxf(m[i], row_max16(bmax));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sv[j] = ok[j] ? expf(sv[j] - m_new) : 0.f;
        psum += sv[j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum16(psum);
      m[i] = m_new;
      s[i] = make_float4(sv[0], sv[1], sv[2], sv[3]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= corr;
        acc[i][c].y *= corr;
        acc[i][c].z *= corr;
        acc[i][c].w *= corr;
      }
    }
    store4(pt + (c0 + 0) * kBQ + r0, make_float4(s[0].x, s[1].x, s[2].x, s[3].x));
    store4(pt + (c0 + 1) * kBQ + r0, make_float4(s[0].y, s[1].y, s[2].y, s[3].y));
    store4(pt + (c0 + 2) * kBQ + r0, make_float4(s[0].z, s[1].z, s[2].z, s[3].z));
    store4(pt + (c0 + 3) * kBQ + r0, make_float4(s[0].w, s[1].w, s[2].w, s[3].w));
    __syncwarp();  // a row's probabilities come from its own half-warp

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p = lds4(pt + j * kBQ + r0);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 x = lds4(vs + j * D + c * 64 + c0);
        axpy4(p.x, x, acc[0][c]);
        axpy4(p.y, x, acc[1][c]);
        axpy4(p.z, x, acc[2][c]);
        axpy4(p.w, x, acc[3][c]);
      }
    }
  }

  T* obase = o + (static_cast<int64_t>(bh) * Sq + q_first + r0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 a = acc[i][c];
      store4(obase + i * D + c * 64 + c0, make_float4(a.x / lc, a.y / lc, a.z / lc, a.w / lc));
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv,
           int H, int Hkv, float scale, int causal, int window, int skv, cudaStream_t stream) {
  constexpr int D = 64 * NC;
  constexpr size_t smem = (2 * D * kBQ + kBK * D + kBK * kBQ) * sizeof(float);
  auto kernel = flash_attention_kernel<T, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>(Sq / kBQ));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), Sq,
                                           Skv, H, Hkv, scale, causal, window, skv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv,
               int D, int H, int Hkv, float scale, int causal, int window, int skv,
               cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 1>(q, k, v, o, BH, Sq, Skv, H, Hkv, scale, causal, window, skv, s);
    case 128: return launch<T, 2>(q, k, v, o, BH, Sq, Skv, H, Hkv, scale, causal, window, skv, s);
    case 256: return launch<T, 4>(q, k, v, o, BH, Sq, Skv, H, Hkv, scale, causal, window, skv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (BH, Sq, D), k and v (BH / H * Hkv, Skv, D), o like q; contiguous.  Sq and
// Skv are multiples of 64, D is 64, 128 or 256, skv <= Skv keys are real,
// window < 0 means no window.  dtype: 0 float32, 1 bfloat16.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int smi_flash_attention(const void* q, const void* k, const void* v, void* o, int BH,
                                   int Sq, int Skv, int D, int H, int Hkv, float scale,
                                   int causal, int window, int skv, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || Sq % kBQ || Skv % kBK || H <= 0 || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return dispatch_d<float>(q, k, v, o, BH, Sq, Skv, D, H, Hkv, scale, causal, window, skv, s);
    case 1:
      return dispatch_d<__nv_bfloat16>(q, k, v, o, BH, Sq, Skv, D, H, Hkv, scale, causal,
                                       window, skv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ================================================== bfloat16 on wgmma (sm_90a)
//
// The redesign for Hopper of the bfloat16 path (the kernel above stays for
// float32), FlashAttention-3's shape in its simple form.  Same function as
// above, every rule of the header kept: left-aligned positions, the -1e30
// mask with probability exactly 0, the 1e-30 clamp, the skipped shadow
// blocks, the GQA row map, longest query blocks first.
//   * One CTA per (query head row, 128 query rows): two consumer warpgroups
//     of 64 rows each and a producer warpgroup whose one thread loads Q once
//     (a 3-D map (D, Sq, BH), so rows past Sq load as zero and nothing is
//     padded) and then K and V tiles of BKV keys by TMA into a 2-stage ring,
//     each tile a 2-D box of K's (or V's) (rows * Skv, D) view at row
//     bkv * Skv + k, bkv the GQA row the query head row reads.
//     K and V have barriers of their own, so S = Q K^T starts while V is in
//     flight.
//   * S = Q K^T: wgmma shared-shared, K the natural K-major B operand;
//     BKV = 128 keys (64 at D = 256, where O takes 128 registers a thread).
//   * Softmax in registers: a thread holds 2 rows; the row max is reduced
//     over the 4 lanes of a quad, exp2 with scale * log2(e) folded into the
//     scores; the running sum stays per thread until the end.
//   * O += P V: P rounded to bfloat16 in registers is the A operand of wgmma
//     register-shared (the accumulator layout of S is the A layout), V the
//     MN-major B operand through the transpose flag: P never goes through
//     shared memory.
//   * setmaxnreg gives the producer 24 registers and the consumers 240.
// Not here yet: ping-pong between the warpgroups and overlapping the
// softmax with the next wgmma.
namespace fa_wgmma {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;       // query rows per CTA
constexpr int kThreads = 384;  // two consumer warpgroups, one producer
constexpr int kStages = 2;

template <int D>
struct Cfg {
  static constexpr int BKV = D == 256 ? 64 : 128;  // keys per tile
  static constexpr int kChunks = D / 64;           // 64-column boxes of the head dim
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = BKV * D * 2;   // one K or V tile
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 3 * kStages);
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                             int Sq, int Skv, int H, int Hkv, float scale_log2, int causal,
                             int window, int skv) {
  using C = Cfg<D>;
  constexpr int BKV = C::BKV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);
  uint8_t* sK = sQ + C::kQBytes;
  uint8_t* sV = sK + kStages * C::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * C::kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;

  const int bh = blockIdx.x;
  const int q_first = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int q_last = min(q_first + kBQ, Sq) - 1;
  const int bkv = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  // key blocks past skv are wholly masked, and so are those past the CTA's
  // last row (causal) or wholly before its first row's window (skip_block)
  int nkb = (skv + BKV - 1) / BKV;
  if (causal) nkb = min(nkb, q_last / BKV + 1);
  const auto skip_block = [&](int kb) {
    return window >= 0 && kb * BKV + BKV - 1 <= q_first - window;
  };
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 8);  // lane 0 of every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer
    setmaxnreg_dec<24>();
    if (tid == 0) {
      tma_prefetch(&map_q);
      tma_prefetch(&map_k);
      tma_prefetch(&map_v);
      mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        tma_load_3d(sQ + c * kBQ * 128, &map_q, q_full, 64 * c, q_first, bh);
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < nkb; ++kb) {
        if (skip_block(kb)) continue;
        const int row = bkv * Skv + kb * BKV;
        mbar_wait(&kv_empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&k_full[stage], C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_2d(sK + stage * C::kTileBytes + c * BKV * 128, &map_k, &k_full[stage], 64 * c,
                      row);
        mbar_arrive_expect_tx(&v_full[stage], C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_2d(sV + stage * C::kTileBytes + c * BKV * 128, &map_v, &v_full[stage], 64 * c,
                      row);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: rows q0 .. q0 + 63; this thread's rows q0 + r and q0 + r + 8
    setmaxnreg_inc<240>();
    const int warp = tid / 32, lane = tid % 32;
    const int q0 = q_first + wg * 64;
    const int r = warp * 16 + lane / 4;
    const int qrow[2] = {q0 + r, q0 + r + 8};
    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float s[BKV / 2];
    uint32_t p[BKV / 16][4];

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kb = 0; kb < nkb; ++kb) {
      if (skip_block(kb)) continue;
      const int k_first = kb * BKV;
      // whether any of this warpgroup's rows sees a key of the block
      const bool active = q0 < Sq && !(causal && k_first > q0 + 63) &&
                          !(window >= 0 && k_first + BKV - 1 <= q0 - window);
      mbar_wait(&k_full[stage], phase);
      if (active) {
        const uint8_t* kt = sK + stage * C::kTileBytes;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk / 4, off = (kk % 4) * 32;
          wgmma_ss<0>(s, sw128_desc(sQ + c * kBQ * 128 + wg * 64 * 128 + off, 16, kSw128Atom),
                      sw128_desc(kt + c * BKV * 128 + off, 16, kSw128Atom), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // scores in log2 units; masked ones are exactly kNegInf
        const bool need_mask = k_first + BKV > skv || (causal && k_first + BKV - 1 > q0) ||
                               (window >= 0 && q0 + 63 - k_first >= window);
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) s[i] *= scale_log2;
        if (need_mask) {
#pragma unroll
          for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int kpos = k_first + 8 * j + 2 * (lane % 4) + e, qpos = qrow[h];
                bool seen = kpos < skv;
                if (causal) seen = seen && qpos >= kpos;
                if (window >= 0) seen = seen && qpos - kpos < window;
                if (!seen) s[4 * j + 2 * h + e] = kNegInf;
              }
        }
        float corr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = m[h];
#pragma unroll
          for (int j = 0; j < BKV / 8; ++j)
            mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
          corr[h] = fast_exp2(m[h] - mx);
          m[h] = mx;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * j + 2 * h + e];
              const float pv = fast_exp2(x - mx);
              x = need_mask && x == kNegInf ? 0.f : pv;
              sum += x;
            }
          l[h] = l[h] * corr[h] + sum;
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            o_acc[4 * j + 2 * h] *= corr[h];
            o_acc[4 * j + 2 * h + 1] *= corr[h];
          }
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      }
      mbar_wait(&v_full[stage], phase);
      if (active) {
        const uint8_t* vt = sV + stage * C::kTileBytes;
        fence_regs(o_acc);
        fence_regs(p);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_rs<1>(o_acc, p[kk], sw128_desc(vt + kk * 16 * 128, BKV * 128, kSw128Atom), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o_acc);
        fence_regs(p);
      }
      if (lane == 0) mbar_arrive(&kv_empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      l[h] = fmaxf(sum, 1e-30f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (qrow[h] >= Sq) continue;
      bf16* orow = o + (static_cast<int64_t>(bh) * Sq + qrow[h]) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
            o_acc[4 * j + 2 * h] / l[h], o_acc[4 * j + 2 * h + 1] / l[h]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv, int H,
           int Hkv, float scale, int causal, int window, int skv, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  const cuuint64_t qd[3] = {D, static_cast<cuuint64_t>(Sq), static_cast<cuuint64_t>(BH)};
  const cuuint64_t qs[2] = {D * 2, static_cast<cuuint64_t>(Sq) * D * 2};
  const cuuint32_t qb[3] = {64, kBQ, 1};
  int err = make_tensor_map(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, 3, qd, qs, qb);
  if (err) return err;
  const cuuint64_t kd[2] = {D, static_cast<cuuint64_t>(BH / H) * Hkv * Skv};
  const cuuint64_t ks[1] = {D * 2};
  const cuuint32_t kb[2] = {64, C::BKV};
  err = make_tensor_map(&mk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, 2, kd, ks, kb);
  if (err) return err;
  err = make_tensor_map(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, 2, kd, ks, kb);
  if (err) return err;
  auto kernel = flash_attention_wgmma_kernel<D>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>((Sq + kBQ - 1) / kBQ));
  const float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(mq, mk, mv, static_cast<bf16*>(o), Sq, Skv, H, Hkv,
                                               scale_log2, causal, window, skv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa_wgmma

// The bfloat16 path on wgmma, for the layout of smi_flash_attention: q
// (BH, Sq, D), k and v (BH / H * Hkv, Skv, D), o like q; contiguous and
// 16-byte aligned, bfloat16.  Sq and Skv are multiples of 64, D is 64, 128 or
// 256, skv <= Skv, window < 0 means no window.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int smi_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                         int BH, int Sq, int Skv, int D, int H, int Hkv,
                                         float scale, int causal, int window, int skv,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (BH <= 0 || Sq <= 0 || Sq % 64 || Skv % 64 || H <= 0 || Hkv <= 0 || H % Hkv ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return fa_wgmma::launch<64>(q, k, v, o, BH, Sq, Skv, H, Hkv, scale, causal, window, skv, s);
    case 128:
      return fa_wgmma::launch<128>(q, k, v, o, BH, Sq, Skv, H, Hkv, scale, causal, window, skv, s);
    case 256:
      return fa_wgmma::launch<256>(q, k, v, o, BH, Sq, Skv, H, Hkv, scale, causal, window, skv, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
