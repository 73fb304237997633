// Kernel F: the Mamba2 SSD chunked scan with a carried state,
//   h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t),   y_t = C_t . h_t,   h_0 = 0.
//
// Replaces the Pallas kernel `ssd_pallas` / `_ssd_kernel` of
// src/repro/kernels/ssd/kernel.py.  That kernel walks a (B*H, S / L) grid in
// order and carries the (Dst, Dh) state of one head row in VMEM scratch
// across the sequential chunk dimension.  A GPU has no such dimension: here
// one CTA owns one head row and walks its chunks in a loop, with the state
// in registers (and a copy in shared memory for the C . h products).  Per
// chunk of L rows it computes the Pallas kernel's function:
//   a = dt A, cum = inclusive cumsum of a over the chunk, xd = x dt;
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xd_j      (intra-chunk)
//       + exp(cum_i) C_i . h_in                                  (inter-chunk);
//   h_out = exp(cum_{L-1}) h_in + sum_j exp(cum_{L-1} - cum_j) B_j (x) xd_j.
// Above the diagonal (j > i) exp(cum_i - cum_j) would overflow: the exponent
// is replaced by -inf there and the score selected to 0, so no inf and no
// inf * 0 is formed.  Arithmetic is float32 throughout (explicit fmaf: the
// library builds with --fmad=false), the output rounded once to x's type.
// The numerical domain is the reference's: A < 0 and dt > 0, so every
// exponent taken is <= 0.
//
// B and C come as G rows shared by BH / G consecutive head rows (row bh reads
// row bh / (BH / G)): G == BH is the Pallas kernel's layout; the model passes
// one row per sequence (G = batch), which Mamba2 shares across all its heads,
// so the kernel reads it in place instead of a copy broadcast to every head.
//
// Bound on an H100, at mamba2-2.7b's prefill (BH = 80 heads, S = 4096,
// L = 128, Dh = 64, Dst = 128, bf16, one sequence): the bytes.  x in and y
// out are 42 MB each, the shared B and C 1 MB each, dt 0.7 MB: ~86 MB, 26 us
// at 3.35 TB/s; the causal products need 1.9e10 FLOP, 19 us on the bf16
// tensor cores.  This version runs float32 FMAs outside the tensor cores and
// one CTA per head row (80 of the 132 SMs), so it is far from either; it is
// the float32 path (and the path of dims below 64 / 128, padded), and the
// bfloat16 kernel at the end of the file, on wgmma, serves
// mamba2's dims.  Design, for a simple kernel that is right:
//   * 256 threads as a 16 x 16 grid (ti, tj); a chunk is walked in sub-tiles
//     of 64 query rows, so shared memory holds the chunk's B rows, one
//     sub-tile of C rows, xd, the state, and one 128 x 64 score tile
//     (204 KB, one CTA per SM);
//   * scores: a thread owns 4 rows x 8 keys (keys tj + 16 k), dot products
//     over float4 runs of the state dim, B and C rows padded by 4 floats so
//     the 8 lanes of a quarter-warp hit distinct banks;
//   * outputs: 4 rows x 4 columns a thread, C . h_in then scores . xd over
//     the transposed score tile; state update: 8 state rows x 4 columns a
//     thread, kept in registers across the chunks;
//   * the chunk's cumsum is taken in order by one thread (128 adds).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;        // 16 x 16
constexpr int kDh = 64;              // x's columns; the wrapper zero-pads up to it
constexpr int kDst = 128;            // the state dim; zero-padded up to it
constexpr int kSub = 64;             // query rows per sub-tile
constexpr int kMaxL = 128;           // the longest chunk
constexpr int kBStride = kDst + 4;   // padded row of B and C in shared memory
constexpr int kSStride = kSub + 4;   // padded row of the transposed score tile
constexpr size_t kSmemFloats = static_cast<size_t>(kMaxL) * kBStride  // B rows
                               + static_cast<size_t>(kSub) * kBStride  // C rows
                               + static_cast<size_t>(kMaxL) * kDh      // xd
                               + static_cast<size_t>(kDst) * kDh       // state
                               + static_cast<size_t>(kMaxL) * kSStride // scores
                               + 4 * kMaxL;                            // dt, cum, w, exp(cum)

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Grid: (BH).  x, y (BH, S, kDh); dt (BH, S) float32; B, C (G, S, kDst);
// A (BH) float32; rep = BH / G head rows share one B/C row; S % L == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const T* __restrict__ B, const T* __restrict__ C,
                    const float* __restrict__ A, T* __restrict__ y, int S, int L, int rep) {
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);  // [L][kBStride]: B rows of the chunk
  float* cs = bs + kMaxL * kBStride;            // [kSub][kBStride]: C rows of the sub-tile
  float* xds = cs + kSub * kBStride;            // [L][kDh]: x * dt
  float* hs = xds + kMaxL * kDh;                // [kDst][kDh]: the state entering the chunk
  float* st = hs + kDst * kDh;                  // [key][kSStride]: scores, transposed
  float* dts = st + kMaxL * kSStride;           // [L]
  float* cum = dts + kMaxL;                     // [L]: inclusive cumsum of dt * A
  float* wj = cum + kMaxL;                      // [L]: exp(cum_{L-1} - cum_j)
  float* ec = wj + kMaxL;                       // [L]: exp(cum_i)

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const float a_h = A[bh];
  const T* xrow = x + static_cast<int64_t>(bh) * S * kDh;
  const float* dtrow = dt + static_cast<int64_t>(bh) * S;
  const T* brow = B + static_cast<int64_t>(bh / rep) * S * kDst;
  const T* crow = C + static_cast<int64_t>(bh / rep) * S * kDst;
  T* yrow = y + static_cast<int64_t>(bh) * S * kDh;

  // this thread's part of the state: rows 8 ti .. 8 ti + 7, columns 4 tj .. 4 tj + 3
  float4 h[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) h[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < kDst * kDh / 4; i += kThreads)
    store4(hs + i * 4, make_float4(0.f, 0.f, 0.f, 0.f));

  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // the previous chunk's readers of every tile are done
    for (int j = tid; j < L; j += kThreads) dts[j] = dtrow[c0 + j];
    __syncthreads();
    if (tid == 0) {  // the decay logs' cumsum, in order
      float s = 0.f;
      for (int j = 0; j < L; ++j) {
        s += dts[j] * a_h;
        cum[j] = s;
      }
    }
    for (int i = tid; i < L * kDst / 4; i += kThreads) {
      const int j = i / (kDst / 4), s = (i % (kDst / 4)) * 4;
      store4(bs + j * kBStride + s, load4(brow + static_cast<int64_t>(c0 + j) * kDst + s));
    }
    for (int i = tid; i < L * kDh / 4; i += kThreads) {
      const int j = i / (kDh / 4), d = (i % (kDh / 4)) * 4;
      const float4 v = load4(xrow + static_cast<int64_t>(c0 + j) * kDh + d);
      const float t = dts[j];
      store4(xds + j * kDh + d, make_float4(v.x * t, v.y * t, v.z * t, v.w * t));
    }
    __syncthreads();
    const float last = cum[L - 1];
    for (int j = tid; j < L; j += kThreads) {
      wj[j] = expf(last - cum[j]);
      ec[j] = expf(cum[j]);
    }

    for (int i0 = 0; i0 < L; i0 += kSub) {
      __syncthreads();  // cs and st are free; wj and ec are visible
      for (int i = tid; i < kSub * kDst / 4; i += kThreads) {
        const int r = i / (kDst / 4), s = (i % (kDst / 4)) * 4;
        store4(cs + r * kBStride + s,
               load4(crow + static_cast<int64_t>(c0 + i0 + r) * kDst + s));
      }
      __syncthreads();

      // scores of rows i0 + 4 ti + r with keys tj + 16 k, keys up to the
      // sub-tile's last row
      const int nk = (i0 + kSub) / 16;
      float g[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) g[r][k] = 0.f;
#pragma unroll 2
      for (int s = 0; s < kDst; s += 4) {
        float4 cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = lds4(cs + (4 * ti + r) * kBStride + s);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (k < nk) {
            const float4 bv = lds4(bs + (tj + 16 * k) * kBStride + s);
#pragma unroll
            for (int r = 0; r < 4; ++r) g[r][k] = dot4(cv[r], bv, g[r][k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < nk) {
          const int j = tj + 16 * k;
          const float cj = cum[j];
          float v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + 4 * ti + r;
            const bool seen = j <= i;
            const float e = expf(seen ? cum[i] - cj : -INFINITY);
            v[r] = seen ? g[r][k] * e : 0.f;
          }
          store4(st + j * kSStride + 4 * ti, make_float4(v[0], v[1], v[2], v[3]));
        }
      }
      __syncthreads();

      // outputs of rows i0 + 4 ti + r, columns 4 tj .. 4 tj + 3
      float4 yv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) yv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
      for (int s = 0; s < kDst; s += 4) {  // C_i . h_in
        float4 hv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) hv[q] = lds4(hs + (s + q) * kDh + 4 * tj);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 cv = lds4(cs + (4 * ti + r) * kBStride + s);
          axpy4(cv.x, hv[0], yv[r]);
          axpy4(cv.y, hv[1], yv[r]);
          axpy4(cv.z, hv[2], yv[r]);
          axpy4(cv.w, hv[3], yv[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = ec[i0 + 4 * ti + r];
        yv[r] = make_float4(yv[r].x * e, yv[r].y * e, yv[r].z * e, yv[r].w * e);
      }
#pragma unroll 4
      for (int j = 0; j < i0 + kSub; ++j) {  // + scores . xd
        const float4 p = lds4(st + j * kSStride + 4 * ti);
        const float4 xv = lds4(xds + j * kDh + 4 * tj);
        axpy4(p.x, xv, yv[0]);
        axpy4(p.y, xv, yv[1]);
        axpy4(p.z, xv, yv[2]);
        axpy4(p.w, xv, yv[3]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        store4(yrow + static_cast<int64_t>(c0 + i0 + 4 * ti + r) * kDh + 4 * tj, yv[r]);
    }
    __syncthreads();  // every read of the entering state is done

    // h_out = exp(cum_{L-1}) h_in + sum_j B_j (x) (w_j xd_j)
    const float el = expf(last);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      h[q] = make_float4(h[q].x * el, h[q].y * el, h[q].z * el, h[q].w * el);
#pragma unroll 2
    for (int j = 0; j < L; ++j) {
      const float w = wj[j];
      const float4 xv0 = lds4(xds + j * kDh + 4 * tj);
      const float4 xv = make_float4(xv0.x * w, xv0.y * w, xv0.z * w, xv0.w * w);
      const float4 b0 = lds4(bs + j * kBStride + 8 * ti);
      const float4 b1 = lds4(bs + j * kBStride + 8 * ti + 4);
      axpy4(b0.x, xv, h[0]);
      axpy4(b0.y, xv, h[1]);
      axpy4(b0.z, xv, h[2]);
      axpy4(b0.w, xv, h[3]);
      axpy4(b1.x, xv, h[4]);
      axpy4(b1.y, xv, h[5]);
      axpy4(b1.z, xv, h[6]);
      axpy4(b1.w, xv, h[7]);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) store4(hs + (8 * ti + q) * kDh + 4 * tj, h[q]);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* B, const void* C, const void* A, void* y,
           int BH, int G, int S, int L, cudaStream_t stream) {
  constexpr size_t smem = kSmemFloats * sizeof(float);
  auto kernel = ssd_scan_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(A), static_cast<T*>(y), S, L, BH / G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and y (BH, S, 64), dt (BH, S) float32, B and C (G, S, 128), A (BH)
// float32; contiguous.  BH % G == 0, L is 64 or 128 and S % L == 0.  dtype
// (x, B, C and y): 0 float32, 1 bfloat16.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int smi_ssd_scan(const void* x, const void* dt, const void* B, const void* C,
                            const void* A, void* y, int BH, int G, int S, int L, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || G <= 0 || BH % G || S <= 0 || (L != 64 && L != 128) || S % L)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch<float>(x, dt, B, C, A, y, BH, G, S, L, s);
    case 1: return launch<__nv_bfloat16>(x, dt, B, C, A, y, BH, G, S, L, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ================================================= bfloat16 on wgmma (sm_90a)
//
// The redesign for Hopper of the bfloat16 path at mamba2's dims (Dh = 64,
// Dst = 128, L = 128); the kernel above stays for float32 and for smaller,
// padded dims.  Same function, the exponent rule above kept, A < 0, dt > 0.
// What held the kernel above back: one CTA a head row (80 of 132 SMs), every
// product a float32 FMA, C B^T recomputed per head, serial sections in each
// chunk.  Here:
//   * One CTA a head row walks its chunks with the float32 state in
//     registers: at mamba2's prefill (80 head rows of 32 chunks) x is read
//     once (42 MB), y written once (42 MB), B and C (1 MB each) come from L2
//     after the first head row.  A chunk is a chain of two wgmma groups and
//     two barriers that one CTA an SM leaves latency bound (~3.5 us).
//     Cutting a head row into segments, their states summed apart and
//     folded in two earlier launches, fills more SMs but measured slower at
//     the prefill at 4- and 8-chunk cuts (the segment states cost a second
//     read of x); storing a state per chunk would move ~460 MB there.
//   * Every product on bf16 wgmma with float32 accumulators, per warpgroup
//     of 64 chunk rows (and 64 state rows):
//       C B^T            ss, both K-major (the rows as TMA lands them);
//       scores . x       rs: the masked, decayed scores, dt_j folded into
//                        the columns, split in registers into two bf16
//                        parts (hi + lo, ~16 bits: one bf16 rounding moved
//                        mamba2's per-layer row cosine from 0.99997 to
//                        0.9988), each an A operand as kernel E's P; x
//                        MN-major (transpose flag);
//       C . h_in         ss: a bf16 copy of the float32 state, MN-major,
//                        then each row scaled by exp(cum_i);
//       h += B^T x'      ss, A = the B tile read M-major (TransA), x' =
//                        bf16(exp(cum_L - cum_j) dt_j x_j) written by the
//                        threads at x's own swizzled position.
//     C B^T, C . h_in and the state update of a chunk go in one wgmma
//     group, scores . x in a second; the carried state stays float32 and is
//     never rounded in the carry.
//   * C B^T is recomputed per head row (10.7 GFLOP at the prefill, ~11 us
//     at the bf16 peak spread over the CTAs) rather than kept as a 2 MB
//     table that every head row would read from L2 (168 MB): no extra pass.
//   * The cumsum is one warp's shuffle scan, a chunk ahead; the next chunk's
//     x, B, C land by TMA on an mbarrier while the current one computes (two
//     stages); y leaves by TMA store from the warpgroup's own C rows, which
//     nothing reads after the first group.
// 256 threads, two warpgroups, one CTA an SM, 213 KB of shared memory.
namespace ssd_wgmma {

using namespace hopper;

constexpr int kL = 128;                   // chunk rows
constexpr int kThreads = 256;             // two warpgroups
constexpr int kStages = 2;                // chunks in flight
constexpr int kTile = kL * 128;           // 128 rows of 128 bytes: x, or 64 columns of B or C
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Two stages of x, B, C; x'; the chunk's h_in in bf16, twice; cum *
// log2(e), dt, exp(cum_L - cum_j) dt_j, exp(cum_i) (2 x kL each) and
// exp(cum_L) (x 2); the stages' mbarriers.
struct YLayout {
  static constexpr int kStage = 5 * kTile;
  static constexpr int kTiles = kStages * kStage + 3 * kTile;
  static constexpr int kSmem = 1024 + kTiles + (8 * kL + 4) * 4 + 8 * kStages;
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
__device__ __forceinline__ uint32_t scale_bf162(uint32_t u, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  return pack_bf16(f.x * s, f.y * s);
}

// An m64n64 accumulator written as bf16 into 64 rows of 128 bytes at `tile`
// (1024-aligned) with the 128-byte swizzle (16-byte unit ^= row % 8).
__device__ __forceinline__ void store_frag(uint8_t* tile, const float (&v)[32], int warp,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * warp + lane / 4 + 8 * hh;
      const uint32_t off = (row * 128 + (8 * j + 2 * (lane % 4)) * 2) ^ ((row & 7) << 4);
      *reinterpret_cast<uint32_t*>(tile + off) =
          pack_bf16(v[4 * j + 2 * hh], v[4 * j + 2 * hh + 1]);
    }
}

// x' = bf16(w_j x_j) at x's swizzled position (the swizzle keeps a 16-byte
// unit in its 128-byte row j).
__device__ __forceinline__ void weigh_x(const uint8_t* x, uint8_t* xp, const float* w, int tid) {
  const uint4* xs = reinterpret_cast<const uint4*>(x);
  uint4* xd = reinterpret_cast<uint4*>(xp);
#pragma unroll
  for (int q = 0; q < kL * 8 / kThreads; ++q) {
    const int u = tid + q * kThreads;
    uint4 v = xs[u];
    const float s = w[u >> 3];
    v.x = scale_bf162(v.x, s);
    v.y = scale_bf162(v.y, s);
    v.z = scale_bf162(v.z, s);
    v.w = scale_bf162(v.w, s);
    xd[u] = v;
  }
}

// Warp 0: the inclusive cumsum of a = dt A over a chunk, 4 rows a lane (d:
// this lane's dt), in a shuffle scan over the lanes; the lane's cums in cj,
// the chunk's last returned.
__device__ __forceinline__ float chunk_cumsum(float4 d, float a_h, int lane, float (&cj)[4]) {
  const float p0 = d.x * a_h;
  const float p1 = p0 + d.y * a_h;
  const float p2 = p1 + d.z * a_h;
  const float p3 = p2 + d.w * a_h;
  float incl = p3;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const float v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  cj[0] = excl + p0;
  cj[1] = excl + p1;
  cj[2] = excl + p2;
  cj[3] = excl + p3;
  return __shfl_sync(kFull, cj[3], 31);
}

// One chunk for this warpgroup's 64 rows (chunk-local rows r and
// r + 8 for this thread), NK keys (the rows up to the warpgroup's last, 64
// or 128):
//   y_i = exp(cum_i) C_i . h_in + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j,
// and, with kUpdate, h = exp(cum_L) h + B^T x' over the warpgroup's 64
// state rows, its bf16 copy written to `sh_next`.  kUpdate is a template
// argument: an accumulator defined under a branch inside a wgmma group makes
// ptxas serialise the group.
template <int NK, bool kUpdate>
__device__ __forceinline__ void chunk_step(float (&y)[32], float (&h)[32],
                                           const uint8_t* sx, const uint8_t* sxp,
                                           const uint8_t* sb, const uint8_t* sc_rows,
                                           const uint8_t* sh, uint8_t* sh_next, const float* cum2,
                                           const float* dts, const float* ec, float e_last,
                                           int wg, int warp, int lane) {
  const int r = 64 * wg + 16 * warp + lane / 4;
  float s[NK / 2];
  uint32_t p[NK / 16][4], q[NK / 16][4];  // the scores' bf16 high and low parts
  if constexpr (kUpdate) {
#pragma unroll
    for (int i = 0; i < 32; ++i) h[i] *= e_last;
  }
  fence_regs(y);
  fence_regs(s);
  fence_regs(h);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDst / 16; ++kk) {
    const int cc = kk / 4, off = (kk % 4) * 32;
    const uint64_t da = sw128_desc(sc_rows + cc * kTile + off, 16, kSw128Atom);
    wgmma_ss<1>(y, da, sw128_desc(sh + kk * 2048, kTile, kSw128Atom), kk > 0);
    wgmma_ss<0>(s, da, sw128_desc(sb + cc * kTile + off, 16, kSw128Atom), kk > 0);
  }
  if constexpr (kUpdate) {
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk)
      wgmma_ss<1, 1>(h, sw128_desc(sb + wg * kTile + kk * 2048, kTile, kSw128Atom),
                     sw128_desc(sxp + kk * 2048, kTile, kSw128Atom), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(y);
  fence_regs(s);
  fence_regs(h);

  const float ci[2] = {cum2[r], cum2[r + 8]};
  const float e[2] = {ec[r], ec[r + 8]};
#pragma unroll
  for (int jj = 0; jj < NK / 8; ++jj) {
    const int j0 = 8 * jj + 2 * (lane % 4);
    const float2 cj = *reinterpret_cast<const float2*>(cum2 + j0);
    const float2 dj = *reinterpret_cast<const float2*>(dts + j0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // above the diagonal the exponent is selected to -inf: exp2 gives 0,
      // no inf is formed
      const bool seen0 = j0 <= r + 8 * hh, seen1 = j0 + 1 <= r + 8 * hh;
      const float e0 = fast_exp2(seen0 ? ci[hh] - cj.x : -INFINITY);
      const float e1 = fast_exp2(seen1 ? ci[hh] - cj.y : -INFINITY);
      float& v0 = s[4 * jj + 2 * hh];
      float& v1 = s[4 * jj + 2 * hh + 1];
      v0 = seen0 ? v0 * e0 * dj.x : 0.f;
      v1 = seen1 ? v1 * e1 * dj.y : 0.f;
    }
  }
  // s = hi + lo, both bf16: the scores keep ~16 bits (one bf16 rounding of
  // the scores moves mamba2's per-layer output by 1e-3 in row cosine)
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = s[8 * kk + 2 * e], b = s[8 * kk + 2 * e + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(hi);
      p[kk][e] = *reinterpret_cast<const uint32_t*>(&hi);
      q[kk][e] = pack_bf16(a - hf.x, b - hf.y);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      y[4 * j + 2 * hh] *= e[hh];
      y[4 * j + 2 * hh + 1] *= e[hh];
    }
  fence_regs(y);
  fence_regs(p);
  fence_regs(q);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    const uint64_t dx = sw128_desc(sx + kk * 2048, kTile, kSw128Atom);
    wgmma_rs<1>(y, p[kk], dx, 1);
    wgmma_rs<1>(y, q[kk], dx, 1);
  }
  wgmma_commit();
  if constexpr (kUpdate) store_frag(sh_next + wg * 64 * 128, h, warp, lane);
  wgmma_wait<0>();
  fence_regs(y);
  fence_regs(p);
  fence_regs(q);
}

// Grid (BH): y of head row blockIdx.x, walking its chunks from a zero state
// with the float32 state in registers.
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_b,
                          const __grid_constant__ CUtensorMap map_c,
                          const __grid_constant__ CUtensorMap map_y, const float* __restrict__ dt,
                          const float* __restrict__ A, int S, int rep) {
  using Ly = YLayout;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = align_1024(smem_raw);
  uint8_t* sxp = tiles + kStages * Ly::kStage;  // x'
  uint8_t* sh = sxp + kTile;                    // [2] the chunk's h_in, bf16
  float* cum2 = reinterpret_cast<float*>(tiles + Ly::kTiles);  // [2][kL]
  float* dts = cum2 + 2 * kL;                                   // [2][kL]
  float* wd = dts + 2 * kL;                                     // [2][kL]
  float* ec = wd + 2 * kL;                                      // [2][kL]
  float* el = ec + 2 * kL;                                      // [2] (+ 2 pad)
  uint64_t* full = reinterpret_cast<uint64_t*>(el + 4);

  const int bh = blockIdx.x, nc = S / kL;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const float a_h = A[bh];
  const float4* dt4 = reinterpret_cast<const float4*>(dt + static_cast<int64_t>(bh) * S);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
  }
  __syncthreads();

  const auto issue = [&](int c) {  // chunk c into stage c % kStages
    const int st = c % kStages, row = c * kL, g = bh / rep;
    uint8_t* sx = tiles + st * Ly::kStage;
    mbar_arrive_expect_tx(&full[st], Ly::kStage);
    tma_load_3d(sx, &map_x, &full[st], 0, row, bh);
    tma_load_3d(sx + kTile, &map_b, &full[st], 0, row, g);
    tma_load_3d(sx + 2 * kTile, &map_b, &full[st], 64, row, g);
    tma_load_3d(sx + 3 * kTile, &map_c, &full[st], 0, row, g);
    tma_load_3d(sx + 4 * kTile, &map_c, &full[st], 64, row, g);
  };
  if (tid == 0) {
    tma_prefetch(&map_x);
    tma_prefetch(&map_b);
    tma_prefetch(&map_c);
    tma_prefetch(&map_y);
    issue(0);
    if (nc > 1) issue(1);
  }

  // warp 0: what chunk c reads of its decay logs' cumsum
  const auto scan = [&](int c, float4 d) {
    const int b = c & 1;
    float cj[4];
    const float last = chunk_cumsum(d, a_h, lane, cj);
    const int j = b * kL + 4 * lane;
    *reinterpret_cast<float4*>(cum2 + j) =
        make_float4(cj[0] * kLog2e, cj[1] * kLog2e, cj[2] * kLog2e, cj[3] * kLog2e);
    *reinterpret_cast<float4*>(dts + j) = d;
    *reinterpret_cast<float4*>(wd + j) =
        make_float4(expf(last - cj[0]) * d.x, expf(last - cj[1]) * d.y,
                    expf(last - cj[2]) * d.z, expf(last - cj[3]) * d.w);
    *reinterpret_cast<float4*>(ec + j) =
        make_float4(expf(cj[0]), expf(cj[1]), expf(cj[2]), expf(cj[3]));
    if (lane == 0) el[b] = expf(last);
  };

  float h[32];  // state rows 64 wg + 16 warp + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1)
#pragma unroll
  for (int i = 0; i < 32; ++i) h[i] = 0.f;
  store_frag(sh + wg * 64 * 128, h, warp, lane);
  fence_async_shared();
  float4 dnext = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < 32) {
    scan(0, dt4[lane]);
    if (nc > 1) dnext = dt4[kL / 4 + lane];
  }

  for (int c = 0; c < nc; ++c) {
    const int b = c & 1, st = c % kStages;
    const bool more = c + 1 < nc;
    if (tid % 128 == 0) tma_store_wait_read();  // the last y tile has left
    // chunk c's vectors, bf16 state and (for c > 0) stage are visible; the
    // stage chunk c - 1 read is free
    __syncthreads();
    if (tid == 0 && c >= 1 && more) issue(c + 1);
    if (tid < 32 && more) {  // a chunk ahead, beside the others' products
      scan(c + 1, dnext);
      if (c + 2 < nc) dnext = dt4[(c + 2) * kL / 4 + lane];
    }
    mbar_wait(&full[st], (c / kStages) & 1);
    uint8_t* sx = tiles + st * Ly::kStage;
    uint8_t* sb = sx + kTile;
    uint8_t* sc_rows = sx + 3 * kTile + wg * 64 * 128;  // this warpgroup's 64 rows of C
    if (more) {  // the state after the last chunk is not needed
      weigh_x(sx, sxp, wd + b * kL, tid);
      fence_async_shared();
      __syncthreads();
    }
    float y[32];
    const auto step = [&](auto nk, auto update) {
      chunk_step<decltype(nk)::value, decltype(update)::value>(
          y, h, sx, sxp, sb, sc_rows, sh + b * kTile, sh + (b ^ 1) * kTile, cum2 + b * kL,
          dts + b * kL, ec + b * kL, el[b], wg, warp, lane);
    };
    using K64 = std::integral_constant<int, 64>;
    using K128 = std::integral_constant<int, 128>;
    if (wg == 0)
      more ? step(K64{}, std::true_type{}) : step(K64{}, std::false_type{});
    else
      more ? step(K128{}, std::true_type{}) : step(K128{}, std::false_type{});
    // y leaves through the C rows only this warpgroup read
    store_frag(sc_rows, y, warp, lane);
    fence_async_shared();
    named_barrier(1 + wg, 128);
    if (tid % 128 == 0) {
      tma_store_3d(&map_y, sc_rows, 0, c * kL + 64 * wg, bh);
      tma_store_commit();
    }
  }
  if (tid % 128 == 0) tma_store_wait_all();
}

int launch(const void* x, const void* dt, const void* B, const void* C, const void* A, void* y,
           int BH, int G, int S, cudaStream_t stream) {
  CUtensorMap mx, my, mb, mc;
  const cuuint64_t xd[3] = {kDh, static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(BH)};
  const cuuint64_t xs[2] = {kDh * 2, static_cast<cuuint64_t>(S) * kDh * 2};
  const cuuint32_t xbox[3] = {64, kL, 1}, ybox[3] = {64, 64, 1};
  const cuuint64_t bd[3] = {kDst, static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(G)};
  const cuuint64_t bs[2] = {kDst * 2, static_cast<cuuint64_t>(S) * kDst * 2};
  const CUtensorMapDataType t = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = make_tensor_map(&mx, t, x, 3, xd, xs, xbox);
  if (!err) err = make_tensor_map(&my, t, y, 3, xd, xs, ybox);
  if (!err) err = make_tensor_map(&mb, t, B, 3, bd, bs, xbox);
  if (!err) err = make_tensor_map(&mc, t, C, 3, bd, bs, xbox);
  if (!err)
    err = cudaFuncSetAttribute(ssd_scan_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               YLayout::kSmem);
  if (err) return err;
  ssd_scan_wgmma_kernel<<<BH, kThreads, YLayout::kSmem, stream>>>(
      mx, mb, mc, my, static_cast<const float*>(dt), static_cast<const float*>(A), S, BH / G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd_wgmma

// The bfloat16 path on wgmma: x and y (BH, S, 64) bfloat16, dt (BH, S) and A
// (BH) float32, B and C (G, S, 128) bfloat16; contiguous, 16-byte aligned.
// BH % G == 0, S % 128 == 0 (chunks of 128).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int smi_ssd_scan_wgmma(const void* x, const void* dt, const void* B, const void* C,
                                  const void* A, void* y, int BH, int G, int S, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (BH <= 0 || G <= 0 || BH % G || S <= 0 || S % ssd_wgmma::kL || misaligned(x) ||
      misaligned(dt) || misaligned(B) || misaligned(C) || misaligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  return ssd_wgmma::launch(x, dt, B, C, A, y, BH, G, S, static_cast<cudaStream_t>(stream));
}
