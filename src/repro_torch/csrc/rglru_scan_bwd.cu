// Backward of the RG-LRU linear recurrence for Hopper (sm_90a), CUDA C++
// with a plain C entry point loaded through ctypes
// (repro_torch/kernels/_build.py).
//
// The JAX package differentiates the hybrid's recurrence with XLA (jax.grad
// through src/repro/models/rglru.py); the Pallas kernel rglru_scan_kernel
// has no backward. This source is the backward of the port's forward
// kernel (csrc/rglru_scan.cu), h_t = a_t * h_{t-1} + b_t, and computes the
// gradients that autograd gives of rglru_scan_ref
// (kernels/rglru_scan/ref.py): from dy = dL/dh [B,S,W] and the saved
// forward output h, with the carry g in fp32 walking S backwards,
//   g_t  = dy_t + a_{t+1} * g_{t+1}     (g_S = 0)
//   db_t = g_t
//   da_t = g_t * h_{t-1}                (h_{-1} = h0, or 0 without one)
//   dh0  = a_0 * g_0                    (when h0 was given)
// a, h, dy, da, db are [B,S,W] contiguous in one type (fp32 or bf16); h0
// and dh0 are fp32 [B,W].
//
// Bound on an H100 SXM (3.35 TB/s): 3 reads and 2 writes per element and
// 3 flops, so bytes bound it by far: at the hybrid's train shape
// [2, 2100, 4096] fp32, 344 MB, 0.103 ms.
//
// Design: one thread per (b, w) column walks S backwards; neighbouring
// threads hold neighbouring columns, so every row of a, h and dy is one
// coalesced read. The walk goes in blocks of U rows whose loads are all
// issued before the block's chain runs, so U rows of each input are in
// flight per thread. CTAs of 64 threads spread the B * W columns over the
// SMs (B2 W4096: 128 CTAs). Splitting S across a CTA with a reversed
// carry chain, as the forward kernel does, is left for the kernel's
// redesign.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int U = 8;          // rows of a block whose loads go out together
constexpr int NT = 64;        // threads per CTA

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                      const T* __restrict__ dy,
                      const float* __restrict__ h0, T* __restrict__ da,
                      T* __restrict__ db, float* __restrict__ dh0, int B,
                      int S, int W) {
  const int64_t col = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (col >= (int64_t)B * W) return;
  const int64_t b = col / W, w = col - b * W;
  const int64_t base = b * S * W + w;       // element (b, 0, w)
  const float hinit = h0 ? h0[col] : 0.f;

  float g = 0.f, a_next = 0.f;
  for (int t_hi = S - 1; t_hi >= 0; t_hi -= U) {
    float ra[U], rd[U], rh[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int t = t_hi - i;
      if (t >= 0) {
        const int64_t e = base + (int64_t)t * W;
        ra[i] = to_f32(a[e]);
        rd[i] = to_f32(dy[e]);
        rh[i] = t > 0 ? to_f32(h[e - W]) : hinit;
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int t = t_hi - i;
      if (t >= 0) {
        const int64_t e = base + (int64_t)t * W;
        g = rd[i] + a_next * g;
        db[e] = from_f32<T>(g);
        da[e] = from_f32<T>(g * rh[i]);
        a_next = ra[i];
      }
    }
  }
  if (dh0) dh0[col] = a_next * g;           // a_0 * g_0
}

template <typename T>
cudaError_t launch(const void* a, const void* h, const void* dy,
                   const float* h0, void* da, void* db, float* dh0, int B,
                   int S, int W, cudaStream_t stream) {
  const int64_t cols = (int64_t)B * W;
  const int64_t ctas = (cols + NT - 1) / NT;
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  rglru_scan_bwd_kernel<T><<<static_cast<unsigned>(ctas), NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dy), h0, static_cast<T*>(da),
      static_cast<T*>(db), dh0, B, S, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, h, dy, da, db); h0 and dh0 are
// fp32 [B, W], both null when the forward had no h0. Returns a
// cudaError_t.
int rglru_scan_bwd(const void* a, const void* h, const void* dy,
                   const float* h0, void* da, void* db, float* dh0,
                   int dtype, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || ((h0 == nullptr) != (dh0 == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(a, h, dy, h0, da, db, dh0, B, S, W, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(a, h, dy, h0, da, db, dh0, B, S, W, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* rglru_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
