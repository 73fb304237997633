// Kernel B: one zero-boundary 4-point Jacobi sweep of each (M, N) tile of a
// (P, M, N) stack, y = 0.25 * (((n + s) + w) + e) in float32.
//
// Replaces the Pallas kernel `stencil_pallas` / `_stencil_kernel` of
// src/repro/kernels/stencil/kernel.py, which streams (block_m x N) row
// slabs through VMEM with the north/south rows taken from the neighbouring
// blocks.  DistributedStencil.step_overlapped runs it as the interior update
// while the halo slabs are in flight.
//
// Bound on an H100: memory.  Four adds and one multiply per point against 8
// bytes moved (float32), so the least time is one read and one write of the
// stack, 2 * P * M * N * itemsize / 3.35 TB/s.  Design: one thread per output
// point; a block covers 256 consecutive columns of one row, so loads and
// stores coalesce, and blocks of neighbouring rows run together, so the
// north and south rows a block reads are the rows its neighbours read and
// come from L2 rather than device memory.  A neighbour outside the tile reads
// 0 (the Dirichlet boundary); the kernel masks its own ragged edge, so no
// padding is needed.  The sum is taken in exactly the reference's operand
// order and built with --fmad=false, so every point equals the plain PyTorch
// sweep bit for bit, rounded once to the output type.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void stencil_sweep_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                                     int64_t M, int64_t N) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= N) return;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int64_t m = row % M;  // row within its tile
    const int64_t i = row * N + col;
    const float n = m > 0 ? to_float(x[i - N]) : 0.0f;
    const float s = m < M - 1 ? to_float(x[i + N]) : 0.0f;
    const float w = col > 0 ? to_float(x[i - 1]) : 0.0f;
    const float e = col < N - 1 ? to_float(x[i + 1]) : 0.0f;
    y[i] = from_float<T>(0.25f * (((n + s) + w) + e));
  }
}

template <typename T>
int launch(const void* x, void* y, int64_t P, int64_t M, int64_t N, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t rows = P * M;
  dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads),
            static_cast<unsigned>(rows < 65535 ? rows : 65535));
  stencil_sweep_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                         static_cast<T*>(y), rows, M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns the CUDA error of the launch (0 on
// success).  The caller passes P, M, N > 0.
extern "C" int smi_stencil_sweep(const void* x, void* y, int64_t P, int64_t M, int64_t N,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, y, P, M, N, s);
    case 1: return launch<__nv_bfloat16>(x, y, P, M, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
