// RG-LRU linear recurrence for Hopper (sm_90a), CUDA C++ with a plain C
// entry point loaded through ctypes (repro_torch/kernels/_build.py).
//
// Replaces the Pallas TPU kernel rglru_scan_kernel
// (src/repro/kernels/rglru_scan/kernel.py, body _rglru_kernel) and computes
// exactly rglru_scan_ref (same file tree, ref.py):
//   a, b [B,S,W] (fp32 or bf16, contiguous), h0 [B,W] fp32 or null (zeros)
//   h_t = a_t * h_{t-1} + b_t with the carry in fp32, every prefix
//   h [B,S,W] written in a's dtype.
//
// Bound on an H100 SXM (3.35 TB/s): the recurrence is elementwise along W
// and does 2 flops per element, so it is memory-bound by far. At the
// serving shape [4, 48, 4096] fp32 it reads a and b and writes h, 9.4 MB,
// about 2.8 us; at the prefill shape [2, 2100, 4096] fp32, 206 MB, about
// 62 us.
//
// Design: one thread per (b, w) walks S with h in a register, so the
// recurrence needs no cross-thread communication and every prefix is
// written once. Neighbouring threads take neighbouring w, so each step's
// loads and stores are coalesced rows. The loads of a and b do not depend
// on h: the loop is unrolled UNROLL steps deep with all of a step group's
// loads issued before its multiply-adds, which keeps UNROLL rows in flight
// per thread and hides most of the memory latency of the sequential walk.
// B*W threads is 16,384 at serving (128 CTAs of 128) and 8,192 at prefill
// (64 CTAs): when that underfills the card, splitting S with a two-pass
// scan is the next step, for a later revision.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;      // threads per CTA, all along W
constexpr int UNROLL = 8;    // steps whose loads are issued together

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
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ h_out,
                  int B, int S, int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const int64_t base = (int64_t)bi * S * W + w;
  const T* ap = a + base;
  const T* bp = b + base;
  T* op = h_out + base;
  float h = (h0 != nullptr) ? h0[(int64_t)bi * W + w] : 0.f;

  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = to_f32(ap[(int64_t)(t + u) * W]);
      bv[u] = to_f32(bp[(int64_t)(t + u) * W]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = av[u] * h + bv[u];
      op[(int64_t)(t + u) * W] = from_f32<T>(h);
    }
  }
  for (; t < S; ++t) {
    h = to_f32(ap[(int64_t)t * W]) * h + to_f32(bp[(int64_t)t * W]);
    op[(int64_t)t * W] = from_f32<T>(h);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, void* h,
                   int B, int S, int W, cudaStream_t stream) {
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(h), B, S, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and h). a, b and h are
// contiguous [B,S,W]; h0 is a contiguous fp32 [B,W] or null. Returns a
// cudaError_t.
int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* h,
                   int dtype, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  cudaError_t err;
  if (dtype == 0) err = launch<float>(a, b, h0f, h, B, S, W, st);
  else if (dtype == 1) err = launch<__nv_bfloat16>(a, b, h0f, h, B, S, W, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
