// Kernel A: out = a + b, elementwise — the fused transport's receive-side add,
// and its gather-fused form out[r] = x[src[r]] + addend[r], the ring shift and
// the add in one pass.
//
// Replaces the Pallas kernel `fused_accumulate` / `_accum_kernel` of
// src/repro/transport/fused.py, which tiles the flattened operands into
// (rows, 128) VMEM blocks.  Every plain-add fold of the collectives on the
// "fused" wire runs through `smi_accumulate`; every ring step of their
// reduce-scatters (`FusedTransport.shift_accumulate`, the step the reference's
// DESIGN.md §3.3 fuses to keep the received block out of HBM) runs through
// `smi_shift_accumulate`.  With all P ranks stacked on one card the "receive"
// is a read of another rank's row: `src[r]` names it, and a rank with
// src[r] < 0 receives zeros (lax.ppermute's semantics), added as a real 0 so
// that -0.0 + 0 rounds to +0.0 exactly as the unfused composition does.
//
// Bound on an H100: memory.  It reads 2n and writes n elements and does one
// add per element, far below the card's 295 operations per byte, so the
// least time is 3 * n * itemsize / 3.35 TB/s (the gather-fused form moves
// the same 3n: the unfused one wrote the shifted copy and read it back, 5n).
// Design: 16 bytes a thread a load (float4 / int4, eight half-precision
// values as uint4), kUnroll of them in flight per thread before any add,
// streaming (evict-first) loads and stores, a grid sized to cover the row in
// one pass (blocks of kThreads threads, a grid-stride loop beyond 2^31
// vectors), rows along blockIdx.y.  A row whose
// three pointers share their offset modulo 16 bytes runs a scalar head up to
// the 16-byte boundary, the vector body and a scalar tail; a row whose
// pointers disagree modulo 16 (a view at an odd offset) runs scalar, which is
// exact, only slower.  Half-precision types add in float and round once to
// nearest even, which is the correctly rounded sum because float carries more
// than 2p + 2 bits; int32 wraps around.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

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

// 16 bytes of T added lane by lane
template <typename T>
__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b) {
  uint4 o;
  const T* pa = reinterpret_cast<const T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
  T* po = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int i = 0; i < static_cast<int>(16 / sizeof(T)); ++i) po[i] = Add<T>::run(pa[i], pb[i]);
  return o;
}

// out[i] = x[i] + b[i] over one row of n elements; x == nullptr reads zeros.
// Every block of the row's grid takes its share of vectors.
template <typename T>
__device__ void add_row(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ out,
                        int64_t n) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const T zero = T();
  const uintptr_t mb = reinterpret_cast<uintptr_t>(b) % 16;
  const bool same = reinterpret_cast<uintptr_t>(out) % 16 == mb &&
                    (x == nullptr || reinterpret_cast<uintptr_t>(x) % 16 == mb);
  if (!same) {
    for (int64_t i = tid; i < n; i += nthreads) out[i] = Add<T>::run(x ? x[i] : zero, b[i]);
    return;
  }
  int64_t head = static_cast<int64_t>((16 - mb) % 16 / sizeof(T));
  if (head > n) head = n;
  const int64_t nvec = (n - head) / kVec;
  const int64_t tail = head + nvec * kVec;
  if (tid < head) out[tid] = Add<T>::run(x ? x[tid] : zero, b[tid]);
  if (tid < n - tail) out[tail + tid] = Add<T>::run(x ? x[tail + tid] : zero, b[tail + tid]);

  const uint4* xv = x ? reinterpret_cast<const uint4*>(x + head) : nullptr;
  const uint4* bv = reinterpret_cast<const uint4*>(b + head);
  uint4* ov = reinterpret_cast<uint4*>(out + head);
  // kUnroll vectors a thread, blockDim apart so a warp's loads coalesce;
  // all loads issue before the first add
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x * kUnroll + threadIdx.x;
       base < nvec; base += nthreads * kUnroll) {
    // zero bits are +0 in every type the kernel takes
    uint4 va[kUnroll], vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * blockDim.x;
      va[u] = vb[u] = make_uint4(0, 0, 0, 0);
      if (i < nvec) {
        vb[u] = __ldcs(bv + i);
        if (xv) va[u] = __ldcs(xv + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * blockDim.x;
      if (i < nvec) __stcs(ov + i, add_vec<T>(va[u], vb[u]));
    }
  }
}

// row r of out = row src[r] of x (zeros when src[r] < 0) + row r of b;
// src == nullptr reads row r of x
template <typename T>
__global__ void __launch_bounds__(kThreads) add_rows_kernel(const T* __restrict__ x,
                                                            const T* __restrict__ b,
                                                            T* __restrict__ out,
                                                            const int* __restrict__ src,
                                                            int64_t n) {
  const int64_t r = blockIdx.y;
  const int s = src ? src[r] : static_cast<int>(r);
  add_row<T>(s >= 0 ? x + s * n : nullptr, b + r * n, out + r * n, n);
}

template <typename T>
int launch(const void* x, const void* b, void* out, const int* src, int64_t rows, int64_t n,
           cudaStream_t stream) {
  constexpr int64_t kVec = 16 / sizeof(T);
  const int64_t per_block = static_cast<int64_t>(kThreads) * kUnroll * kVec;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > (int64_t{1} << 31) - 1) blocks = (int64_t{1} << 31) - 1;  // grid-stride beyond
  if (blocks < 1) blocks = 1;
  add_rows_kernel<T><<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(rows)),
                       kThreads, 0, stream>>>(static_cast<const T*>(x),
                                              static_cast<const T*>(b), static_cast<T*>(out),
                                              src, n);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, const void* b, void* out, const int* src, int64_t rows, int64_t n,
             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > 65535 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch<float>(x, b, out, src, rows, n, s);
    case 1: return launch<__nv_bfloat16>(x, b, out, src, rows, n, s);
    case 2: return launch<__half>(x, b, out, src, rows, n, s);
    case 3: return launch<int32_t>(x, b, out, src, rows, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16, 3 int32.  Returns the CUDA error
// of the launch (0 on success).  The caller passes n > 0.
extern "C" int smi_accumulate(const void* a, const void* b, void* out, int64_t n, int dtype,
                              void* stream) {
  return dispatch(a, b, out, nullptr, 1, n, dtype, stream);
}

// out[r, :] = x[src[r], :] + addend[r, :] for r < P over rows of n elements,
// zeros in place of x's row where src[r] < 0; src is a (P,) int32 device
// array.  The caller passes 1 <= P <= 65535 and n > 0.
extern "C" int smi_shift_accumulate(const void* x, const void* addend, const void* src,
                                    void* out, int P, int64_t n, int dtype, void* stream) {
  return dispatch(x, addend, out, static_cast<const int*>(src), P, n, dtype, stream);
}

extern "C" const char* smi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
