// Kernel A: out = a + b, elementwise — the fused transport's receive-side add.
//
// Replaces the Pallas kernel `fused_accumulate` / `_accum_kernel` of
// src/repro/transport/fused.py, which tiles the flattened operands into
// (rows, 128) VMEM blocks.  Every plain-add fold of the collectives on the
// "fused" wire runs through it.
//
// Bound on an H100: memory.  It reads 2n and writes n elements and does one
// add per element, far below the card's 295 operations per byte, so the
// least time is 3 * n * itemsize / 3.35 TB/s.  Design: a grid-stride loop
// with 64-bit indices, one element per thread per iteration, neighbouring
// threads on neighbouring addresses so every warp's loads coalesce; the grid
// is capped at 16 blocks of 256 threads per SM, which fills the card, and the
// loop covers any n, including sizes that are not a multiple of the block.
// Half-precision types add in float and round once to nearest even, which is
// the correctly rounded sum because float carries more than 2p + 2 bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace {

template <typename T>
struct Add;

template <>
struct Add<float> {
  __device__ static float run(float a, float b) { return a + b; }
};

template <>
struct Add<__nv_bfloat16> {
  __device__ static __nv_bfloat16 run(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
};

template <>
struct Add<__half> {
  __device__ static __half run(__half a, __half b) {
    return __float2half_rn(__half2float(a) + __half2float(b));
  }
};

template <>
struct Add<int32_t> {
  // two's-complement wrap-around, as torch and XLA add int32
  __device__ static int32_t run(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
  }
};

template <typename T>
__global__ void accumulate_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                  T* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = Add<T>::run(a[i], b[i]);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int64_t n, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int64_t kMaxBlocks = 132 * 16;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  accumulate_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16, 3 int32.  Returns the CUDA error
// of the launch (0 on success).  The caller passes n > 0.
extern "C" int smi_accumulate(const void* a, const void* b, void* out, int64_t n, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, b, out, n, s);
    case 1: return launch<__nv_bfloat16>(a, b, out, n, s);
    case 2: return launch<__half>(a, b, out, n, s);
    case 3: return launch<int32_t>(a, b, out, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* smi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
