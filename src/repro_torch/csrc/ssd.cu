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
// one CTA per head row (80 of the 132 SMs), so it is far from either; the
// three-pass form (chunk states in parallel, a short scan over them, then the
// outputs) on wgmma is later work.  Design, for a simple kernel that is right:
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
