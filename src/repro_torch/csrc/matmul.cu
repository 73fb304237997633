// Kernel D: the per-chunk GEMM of the overlap engine, out = x @ w with a
// float32 accumulator and one rounding to the output type at the end.
//
// Replaces the Pallas kernel `matmul_pallas` / `_matmul_kernel` of
// src/repro/kernels/matmul/kernel.py.  That kernel walks an
// (M/bm, N/bn, K/bk) grid with K innermost and sequential, accumulating
// (bm, bn) partials in a float32 VMEM scratch that it flushes once in the
// output dtype; ops.py zero-pads ragged dimensions to the 128-blocks.  Here
// one CTA owns one output tile and walks K in a loop with the partials in
// registers, and the ragged edges are guarded inside the kernel (loads past
// an edge read zeros, stores past it are dropped), so nothing is padded or
// copied.  An optional leading batch dimension multiplies Bt independent
// pairs in one launch: the overlap engine hands it one ring step of all P
// stacked ranks at once.  A batch stride of 0 for w shares one weight.
//
// Bound on an H100: operations for the model's shapes.  The MLP-up ring
// step, (8, 512, 4096) @ (8, 4096, 1376) in bfloat16, is 4.6e10 FLOP
// (0.047 ms at 989 TFLOP/s) against about 135 MB of reads and writes
// (0.040 ms at 3.35 TB/s).  Design, for a simple kernel that is right:
//   * bfloat16 in: the tensor cores through mma.sync.m16n8k16 (inline PTX,
//     float32 accumulate), fed by ldmatrix (x4; .trans for w, which lies
//     k-major).  A 256-thread CTA owns a 128 x 128 tile, each of its 8 warps
//     64 x 32 (4 x 4 products of 16 x 8, 64 float accumulators a thread).
//     K-tiles of 64 are staged in shared memory by cp.async in a ring of
//     three stages (105 KB, two CTAs an SM), so two tiles' loads are in
//     flight while one is multiplied, with one barrier a tile.  Rows are
//     padded by 8 elements, so the 8 rows of every ldmatrix hit distinct
//     banks.
//   * float32 in: float32 FMAs outside the tensor cores (no TF32): a
//     256-thread CTA owns a 64 x 64 tile, each thread 4 x 4 outputs, K-tiles
//     of 16 in shared memory (A transposed so a thread's 4 rows are one
//     float4).  Products are explicit fmaf: the library builds with
//     --fmad=false, which stops the compiler fusing on its own but keeps
//     fmaf.
//   * a 16-byte copy is taken only where K and N are multiples of 8 and the
//     operands are 16-byte aligned; every other element is loaded alone.
// This mma.sync kernel is the path for float32 operands and for bfloat16
// whose K or N is not a multiple of 8; bfloat16 with both multiples of 8 (the
// TP prefill's shapes) runs on the wgmma kernel at the end of the file.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Four 8 x 8 matrices of 16-bit elements from shared memory; lane l gives
// the address of row l % 8 of matrix l / 8 and receives, of each matrix, the
// pair at row l / 4, columns 2 (l % 4) .. + 1 (transposed with .trans).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// d (16 x 8, float32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- bfloat16

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kLdA = kBK + 8;  // 144-byte rows: fragment starts stay 32-byte aligned
constexpr int kLdB = kBN + 8;  // 272-byte rows
constexpr int kStageA = kBM * kLdA;
constexpr int kStageB = kBK * kLdB;
constexpr int kSmemBytes = kStages * (kStageA + kStageB) * static_cast<int>(sizeof(bf16));

// One (kBM, kBK) tile of x and one (kBK, kBN) tile of w into shared memory;
// 8 elements a chunk, 1024 chunks each, 4 a thread.
template <bool kVec>
__device__ __forceinline__ void load_tiles(bf16* sA, bf16* sB, const bf16* x, const bf16* w,
                                           int M, int N, int K, int m0, int n0, int k0,
                                           int tid) {
  const bf16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
    const int row = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
    const int gm = m0 + row, gk = k0 + col;
    bf16* dst = sA + row * kLdA + col;
    if (kVec && gm < M && gk + 8 <= K) {
      cp_async16(dst, x + static_cast<int64_t>(gm) * K + gk);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gm < M && gk + e < K) ? x[static_cast<int64_t>(gm) * K + gk + e] : zero;
    }
  }
#pragma unroll
  for (int c = tid; c < kBK * kBN / 8; c += kThreads) {
    const int row = c / (kBN / 8), col = (c % (kBN / 8)) * 8;
    const int gk = k0 + row, gn = n0 + col;
    bf16* dst = sB + row * kLdB + col;
    if (kVec && gk < K && gn + 8 <= N) {
      cp_async16(dst, w + static_cast<int64_t>(gk) * N + gn);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gk < K && gn + e < N) ? w[static_cast<int64_t>(gk) * N + gn + e] : zero;
    }
  }
}

template <typename TO, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
matmul_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, TO* __restrict__ out,
                   int M, int N, int K, int64_t x_stride, int64_t w_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * kStageA;

  const int b = blockIdx.z;
  x += b * x_stride;
  w += b * w_stride;
  out += static_cast<int64_t>(b) * M * N;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  float acc[4][4][4];  // [16-row block][8-column block][element]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nk = (K + kBK - 1) / kBK;
  // prologue: the first kStages - 1 tiles in flight, one commit group each
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk)
      load_tiles<kVec>(sA + st * kStageA, sB + st * kStageB, x, w, M, N, K, m0, n0, st * kBK,
                       tid);
    cp_async_commit();
  }
  // this lane's ldmatrix row: row lane % 16 of a 16-row (or 16-deep) block,
  // column half lane / 16
  const int lrow = lane % 16, lcol = (lane / 16) * 8;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_one();  // tile kt has landed (kStages - 2 = 1 group may stay in flight)
    __syncthreads();      // ... for every thread; and every warp is done with tile kt - 1
    const int next = kt + kStages - 1;  // refills the stage tile kt - 1 used
    if (next < nk)
      load_tiles<kVec>(sA + (next % kStages) * kStageA, sB + (next % kStages) * kStageB, x, w,
                       M, N, K, m0, n0, next * kBK, tid);
    cp_async_commit();  // possibly empty: keeps one group per iteration
    const bf16* a_s = sA + (kt % kStages) * kStageA + (wm + lrow) * kLdA + lcol;
    const bf16* b_s = sB + (kt % kStages) * kStageB + lrow * kLdB + wn + lcol;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(af[i], a_s + i * 16 * kLdA + kk);
#pragma unroll
      for (int j = 0; j < 2; ++j) ldmatrix_x4_trans(bfr[j], b_s + kk * kLdB + j * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_bf16(acc[i][n], af[i], bfr[n / 2][2 * (n % 2)], bfr[n / 2][2 * (n % 2) + 1]);
    }
  }
  cp_async_wait_all();

  // Epilogue: every accumulator to its element, edges guarded; a lane holds
  // rows g and g + 8 of each 16 x 8 block, columns 2c and 2c + 1.
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int gn = n0 + wn + n * 8 + 2 * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm + i * 16 + g + 8 * h;
        if (gm >= M) continue;
        TO* dst = out + static_cast<int64_t>(gm) * N + gn;
        if (gn < N) dst[0] = from_float<TO>(acc[i][n][2 * h]);
        if (gn + 1 < N) dst[1] = from_float<TO>(acc[i][n][2 * h + 1]);
      }
    }
  }
}

// ----------------------------------------------------------------- float32

constexpr int kFM = 64, kFN = 64, kFK = 16;

template <typename TO>
__global__ void __launch_bounds__(kThreads)
matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, TO* __restrict__ out,
                  int M, int N, int K, int64_t x_stride, int64_t w_stride) {
  __shared__ __align__(16) float As[kFK][kFM + 4];  // As[k][m]: x transposed
  __shared__ __align__(16) float Bs[kFK][kFN + 4];  // Bs[k][n]

  const int b = blockIdx.z;
  x += b * x_stride;
  w += b * w_stride;
  out += static_cast<int64_t>(b) * M * N;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int e = tid; e < kFM * kFK; e += kThreads) {
      const int row = e / kFK, col = e % kFK;
      const int gm = m0 + row, gk = k0 + col;
      As[col][row] = (gm < M && gk < K) ? x[static_cast<int64_t>(gm) * K + gk] : 0.0f;
    }
#pragma unroll
    for (int e = tid; e < kFK * kFN; e += kThreads) {
      const int row = e / kFN, col = e % kFN;
      const int gk = k0 + row, gn = n0 + col;
      Bs[row][col] = (gk < K && gn < N) ? w[static_cast<int64_t>(gk) * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[static_cast<int64_t>(gm) * N + gn] = from_float<TO>(acc[i][j]);
    }
  }
}

template <typename TO, bool kVec>
int launch_bf16(const bf16* x, const bf16* w, TO* out, int batch, int M, int N, int K,
                int64_t x_stride, int64_t w_stride, cudaStream_t s) {
  auto kernel = matmul_bf16_kernel<TO, kVec>;
  // above 48 KB of shared memory only by opting in
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(x, w, out, M, N, K, x_stride, w_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int launch_bf16(const void* x, const void* w, void* out, int batch, int M, int N, int K,
                int64_t x_stride, int64_t w_stride, bool vec, cudaStream_t s) {
  auto xp = static_cast<const bf16*>(x);
  auto wp = static_cast<const bf16*>(w);
  auto op = static_cast<TO*>(out);
  return vec ? launch_bf16<TO, true>(xp, wp, op, batch, M, N, K, x_stride, w_stride, s)
             : launch_bf16<TO, false>(xp, wp, op, batch, M, N, K, x_stride, w_stride, s);
}

template <typename TO>
int launch_f32(const void* x, const void* w, void* out, int batch, int M, int N, int K,
               int64_t x_stride, int64_t w_stride, cudaStream_t s) {
  dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM, batch);
  matmul_f32_kernel<TO><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                  static_cast<const float*>(w),
                                                  static_cast<TO*>(out), M, N, K, x_stride,
                                                  w_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (batch, M, N) = x (batch, M, K) @ w (batch, K, N), each contiguous per
// batch entry; batch entry b of x starts x_stride elements after entry b - 1,
// of w w_stride elements after (0: one w for every entry).  in_dtype and
// out_dtype: 0 float32, 1 bfloat16.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int smi_matmul(const void* x, const void* w, void* out, int batch, int M, int N,
                          int K, int64_t x_stride, int64_t w_stride, int in_dtype, int out_dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || M <= 0 || N <= 0 || K < 0 || batch > 65535 ||
      (M + kFM - 1) / kFM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == 1) {
    const bool vec = K % 8 == 0 && N % 8 == 0 && x_stride % 8 == 0 && w_stride % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (out_dtype == 1)
      return launch_bf16<bf16>(x, w, out, batch, M, N, K, x_stride, w_stride, vec, s);
    if (out_dtype == 0)
      return launch_bf16<float>(x, w, out, batch, M, N, K, x_stride, w_stride, vec, s);
  } else if (in_dtype == 0) {
    if (out_dtype == 1)
      return launch_f32<bf16>(x, w, out, batch, M, N, K, x_stride, w_stride, s);
    if (out_dtype == 0)
      return launch_f32<float>(x, w, out, batch, M, N, K, x_stride, w_stride, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ================================================== bfloat16 on wgmma (sm_90a)
//
// The redesign for Hopper of the bfloat16 path, the one the overlap engine
// runs (the kernel above stays for float32 operands and for K or N that is
// not a multiple of 8, which TMA cannot stride).  Same function: out[b] =
// x[b] @ w[b], float32 accumulate, one rounding to the output type.
//   * A CTA of three warpgroups owns 128 x 128 output tiles: the last
//     warpgroup is the producer (one thread issues TMA loads into a ring of
//     kStages K-slices of 64), the other two are consumers, each multiplying
//     its 64 rows with wgmma m64n128k16 (shared-shared) into 64 float32
//     registers a thread.  Full/empty mbarriers hand the stages over; a
//     consumer keeps one wgmma group in flight and releases a stage when the
//     group after it has been issued.
//   * x is read through a 3-D tensor map (K, M, Bt), so a box past M inside
//     one batch entry is zero-filled rather than taken from the next entry;
//     w (K, N) row-major is the MN-major B operand (the transpose flag), read
//     as two 64-column boxes a stage through a 3-D map, or a 2-D map with no
//     batch coordinate when one w is shared.  Ragged K and N (1376 = d_ff / 8
//     in the TP prefill) are TMA's zero fill; nothing is padded or copied.
//   * A persistent grid (one CTA an SM walking the tiles) overlaps a tile's
//     epilogue with the next tile's loads (one CTA a tile is kept as a
//     launch option, for chip_smoke.py's comparison).  The epilogue stages
//     each warpgroup's 64 x 128 tile in swizzled shared memory and one
//     thread stores it by TMA, clipped at M and N: faster at every ring
//     step than storing from registers, which was measured and removed.
namespace wgmma_path {

using namespace hopper;

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 5;
constexpr int kConsumers = 2;                     // warpgroups of 64 output rows
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kTileA = kBM * kBK * 2;             // 128 rows of 128 bytes
constexpr int kBoxB = kBK * 64 * 2;               // one 64-column box of w: 64 rows of 128 bytes
constexpr int kTileB = 2 * kBoxB;

template <typename TO>
__host__ __device__ constexpr int staging_bytes() {
  return kBM * kBN * static_cast<int>(sizeof(TO));
}
template <typename TO>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + kStages * (kTileA + kTileB) + staging_bytes<TO>() + 2 * kStages * 8;
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename TO>
__global__ void __launch_bounds__(kThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_out, int K, int w_batched,
                    int tiles_m, int tiles_n, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sA = align_1024(smem_raw);
  uint8_t* sB = sA + kStages * kTileA;
  uint8_t* sOut = sB + kStages * kTileB;
  uint64_t* full = reinterpret_cast<uint64_t*>(sOut + staging_bytes<TO>());
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full, tile after tile
    setmaxnreg_dec<40>();
    if (tid == 0) {
      tma_prefetch(&map_x);
      tma_prefetch(&map_w);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int tm = t % tiles_m, tn = (t / tiles_m) % tiles_n, b = t / (tiles_m * tiles_n);
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], kTileA + kTileB);
          tma_load_3d(sA + stage * kTileA, &map_x, &full[stage], kt * kBK, tm * kBM, b);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            uint8_t* dst = sB + stage * kTileB + c * kBoxB;
            if (w_batched)
              tma_load_3d(dst, &map_w, &full[stage], tn * kBN + 64 * c, kt * kBK, b);
            else
              tma_load_2d(dst, &map_w, &full[stage], tn * kBN + 64 * c, kt * kBK);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each
    setmaxnreg_inc<232>();
    const int warp = tid / 32, lane = tid % 32;
    int stage = 0;
    uint32_t phase = 0;
    float acc[kBN / 2];
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int tm = t % tiles_m, tn = (t / tiles_m) % tiles_n, b = t / (tiles_m * tiles_n);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint8_t* a = sA + stage * kTileA + wg * 64 * 128;
        const uint8_t* bt = sB + stage * kTileB;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_ss<1>(acc, sw128_desc(a + kk * 32, 16, kSw128Atom),
                      sw128_desc(bt + kk * 16 * 128, kBoxB, kSw128Atom), 1);
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();  // the group before this one is done: its stage is free
        fence_regs(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      // stage the warpgroup's 64 x 128 tile as boxes of 128-byte rows with the
      // 128-byte swizzle (conflict-free: a warp's 8 rows land in 8 distinct
      // 16-byte groups), then one thread stores them, clipped at M and N
      const int r = warp * 16 + lane / 4;  // this thread's rows r and r + 8 of the warpgroup's 64
      constexpr int kCols = 128 / static_cast<int>(sizeof(TO));  // columns per box
      uint8_t* st = sOut + wg * 64 * kBN * static_cast<int>(sizeof(TO));
      if (tid == 0) tma_store_wait_read();  // the previous tile's stores have read st
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const int byte = (col % kCols) * static_cast<int>(sizeof(TO));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          uint8_t* p = st + (col / kCols) * 64 * 128 + row * 128 +
                       (((byte / 16) ^ (row % 8)) * 16) + byte % 16;
          store_pair(reinterpret_cast<TO*>(p), acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      fence_async_shared();
      named_barrier(1 + wg, 128);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < kBN / kCols; ++c)
          tma_store_3d(&map_out, st + c * 64 * 128, tn * kBN + c * kCols, tm * kBM + wg * 64, b);
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
}

template <typename TO>
__host__ __device__ constexpr CUtensorMapDataType map_dtype() {
  return sizeof(TO) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

template <typename TO>
int launch(const void* x, const void* w, void* out, int batch, int M, int N, int K,
           int w_batched, int persistent, cudaStream_t s) {
  constexpr int sz = static_cast<int>(sizeof(TO));
  CUtensorMap mx, mw, mo;
  const cuuint64_t xd[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M),
                            static_cast<cuuint64_t>(batch)};
  const cuuint64_t xs[2] = {static_cast<cuuint64_t>(K) * 2, static_cast<cuuint64_t>(M) * K * 2};
  const cuuint32_t xb[3] = {64, kBM, 1};
  int err = make_tensor_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 3, xd, xs, xb);
  if (err) return err;
  const cuuint64_t wd[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                            static_cast<cuuint64_t>(batch)};
  const cuuint64_t ws[2] = {static_cast<cuuint64_t>(N) * 2, static_cast<cuuint64_t>(K) * N * 2};
  const cuuint32_t wb[3] = {64, kBK, 1};
  err = make_tensor_map(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, w_batched ? 3 : 2, wd, ws, wb);
  if (err) return err;
  const cuuint64_t od[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M),
                            static_cast<cuuint64_t>(batch)};
  const cuuint64_t os[2] = {static_cast<cuuint64_t>(N) * sz, static_cast<cuuint64_t>(M) * N * sz};
  const cuuint32_t ob[3] = {128 / sz, 64, 1};
  err = make_tensor_map(&mo, map_dtype<TO>(), out, 3, od, os, ob);
  if (err) return err;
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int64_t n_tiles = static_cast<int64_t>(tiles_m) * tiles_n * batch;
  if (n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int grid = static_cast<int>(n_tiles);
  if (persistent) {
    const int sms = sm_count();
    if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    grid = grid < sms ? grid : sms;
  }
  auto kernel = matmul_wgmma_kernel<TO>;
  constexpr int smem = smem_bytes<TO>();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, s>>>(mx, mw, mo, K, w_batched, tiles_m, tiles_n,
                                      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma_path

// The bfloat16 path on wgmma: out (batch, M, N) = x (batch, M, K) @ w, w
// (batch, K, N) when w_batched, else one (K, N) for every entry; all
// contiguous and 16-byte aligned, K and N multiples of 8, K > 0.  out_dtype:
// 0 float32, 1 bfloat16.  persistent: one CTA an SM walking the tiles (else
// one CTA a tile).  Returns the CUDA error of the launch (0 on success).
extern "C" int smi_matmul_wgmma(const void* x, const void* w, void* out, int batch, int M, int N,
                                int K, int w_batched, int out_dtype, int persistent,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 || misaligned(x) ||
      misaligned(w) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == 1)
    return wgmma_path::launch<bf16>(x, w, out, batch, M, N, K, w_batched, persistent, s);
  if (out_dtype == 0)
    return wgmma_path::launch<float>(x, w, out, batch, M, N, K, w_batched, persistent, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
