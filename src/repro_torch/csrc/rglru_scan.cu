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
// Design: S is split across the threads of a CTA, with a carried state.
// - A CTA owns one batch row and a tile of TW consecutive columns (grid
//   B * ceil(W / TW) on x); each lane owns one column, so a row of the
//   tile is one coalesced read of TW elements.
// - The CTA walks S in blocks of NSEG * ROWS rows. Thread (seg, col) of
//   the CTA (threadIdx.x = seg * TW + col) holds rows [seg * ROWS,
//   (seg + 1) * ROWS) of the block in registers, loaded once.
// - Local scan: each thread scans its rows from a zero state and keeps
//   A = prod(a) and H = h_end, written to shared memory.
// - Carries: after one barrier, every thread walks the NSEG (A, H) pairs
//   of its column from the block's carry, c <- A_j * c + H_j, which gives
//   its own carry-in (at j = seg) and the next block's carry (after the
//   last), all in fp32. The first block starts from h0 (or 0).
// - Re-walk: each thread runs h = a * h + b over its rows again from its
//   carry-in, in the sequential order, and writes every prefix once. Only
//   the carry-in's rounding differs from the plain sequential walk.
// - Overlap: the next block's loads are issued into a second register
//   buffer before the current block's scan and stores, so loads stay in
//   flight across the chain; the two buffers (and two shared-memory
//   slots, so one barrier a block suffices) alternate.
// - DRAM: a CTA reads only 64 or 128 bytes of each row, and its
//   neighbouring tiles' CTAs read the rest of the row at about the same
//   time. The loads ask L2 to fetch the whole 256-byte span around each
//   piece (ld.global.nc.L2::256B), so the card reads rows in larger pieces
//   and the neighbours find theirs in L2.
// - Launch: the kernel is a programmatic dependent launch
//   (cudaLaunchKernelEx) and executes griddepcontrol.wait before it
//   touches global memory, which holds it until the kernel before has
//   finished and its writes are visible; its launch and prologue overlap
//   that kernel's tail, most of the time of a short scan.
// - Rows past S are the identity (a = 1, b = 0; a zero a would reset the
//   state) and are neither read nor written; columns past W neither.
// So a and b are read once and h written once: the bound's bytes. TW and
// NSEG are chosen by the binding's scan_plan (kernels/rglru_scan/
// kernel.py): a tile narrow enough that the grid fills the card at B = 1,
// and at most 192 threads a CTA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;          // rows of a block each thread holds
constexpr int MAX_THREADS = 256;  // TW * NSEG at most, per CTA

// a load from memory the kernel does not write, with L2 fetching the
// aligned 256 bytes around it
__device__ __forceinline__ float load_l2_256(const float* p) {
  float v;
  asm("ld.global.nc.L2::256B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ __nv_bfloat16
load_l2_256(const __nv_bfloat16* p) {
  unsigned short v;
  asm("ld.global.nc.L2::256B.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return __ushort_as_bfloat16(v);
}

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

// a thread's rows of one block, kept in the input type: converting at
// the load would make the warp wait for the load there
template <typename T> struct Rows {
  T a[ROWS], b[ROWS];
};

struct Column {
  int S, W, r_seg;   // r_seg: the thread's first row within a block
  int block_rows;
  bool ok;           // the column lies inside W
};

// Issue the loads of block k's rows of this thread; rows past S are the
// identity.
template <typename T>
__device__ __forceinline__ void load_rows(Rows<T>& buf, const T* ap,
                                          const T* bp, const Column& c,
                                          int k) {
  const int r0 = k * c.block_rows + c.r_seg;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int t = r0 + r;
    if (c.ok && t < c.S) {
      buf.a[r] = load_l2_256(ap + (int64_t)t * c.W);
      buf.b[r] = load_l2_256(bp + (int64_t)t * c.W);
    } else {
      buf.a[r] = from_f32<T>(1.f);
      buf.b[r] = from_f32<T>(0.f);
    }
  }
}

// Block k: prefetch block k + 1 into nxt, then scan cur (local scan,
// carries through shared slot As/Hs, re-walk and stores). Returns the
// carry into block k + 1.
template <typename T>
__device__ __forceinline__ float scan_block(
    const Rows<T>& cur, Rows<T>& nxt, const T* ap, const T* bp, T* hp,
    const Column& c, int k, int tw, int nseg, float carry,
    float* __restrict__ As, float* __restrict__ Hs) {
  load_rows(nxt, ap, bp, c, k + 1);
  float A = 1.f, H = 0.f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float av = to_f32(cur.a[r]);
    A *= av;
    H = fmaf(av, H, to_f32(cur.b[r]));
  }
  As[threadIdx.x] = A;
  Hs[threadIdx.x] = H;
  __syncthreads();
  const int seg = threadIdx.x / tw, lane_col = threadIdx.x - seg * tw;
  float h = carry;
  for (int j = 0; j < nseg; ++j) {
    if (j == seg) h = carry;
    carry = fmaf(As[j * tw + lane_col], carry, Hs[j * tw + lane_col]);
  }
  const int r0 = k * c.block_rows + c.r_seg;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    h = fmaf(to_f32(cur.a[r]), h, to_f32(cur.b[r]));
    const int t = r0 + r;
    if (c.ok && t < c.S) hp[(int64_t)t * c.W] = from_f32<T>(h);
  }
  return carry;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 2)
rglru_scan_split(const T* __restrict__ a, const T* __restrict__ b,
                 const float* __restrict__ h0, T* __restrict__ h_out,
                 int S, int W, int tw, int nseg) {
  // two slots of (A, H), used by alternate blocks: a slot is written
  // again only after the next block's barrier, which every thread passes
  // after reading it
  __shared__ float As[2][MAX_THREADS], Hs[2][MAX_THREADS];
  const int tiles = (W + tw - 1) / tw;
  const int bi = blockIdx.x / tiles;
  const int seg = threadIdx.x / tw;
  const int col = (blockIdx.x - bi * tiles) * tw + (threadIdx.x - seg * tw);
  Column c;
  c.S = S;
  c.W = W;
  c.r_seg = seg * ROWS;
  c.block_rows = nseg * ROWS;
  c.ok = col < W;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int64_t base = (int64_t)bi * S * W + (c.ok ? col : 0);
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h_out + base;
  float carry = (h0 != nullptr && c.ok) ? h0[(int64_t)bi * W + col] : 0.f;
  const int blocks = (S + c.block_rows - 1) / c.block_rows;

  Rows<T> x, y;
  load_rows(x, ap, bp, c, 0);
  for (int k = 0; k < blocks; k += 2) {
    carry = scan_block(x, y, ap, bp, hp, c, k, tw, nseg, carry, As[0],
                       Hs[0]);
    if (k + 1 < blocks)
      carry = scan_block(y, x, ap, bp, hp, c, k + 1, tw, nseg, carry, As[1],
                         Hs[1]);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, void* h,
                   int B, int S, int W, int tw, int nseg,
                   cudaStream_t stream) {
  const int64_t ctas = (int64_t)B * ((W + tw - 1) / tw);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(tw * nseg);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, rglru_scan_split<T>, static_cast<const T*>(a),
      static_cast<const T*>(b), h0, static_cast<T*>(h), S, W, tw, nseg);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and h). a, b and h are
// contiguous [B,S,W]; h0 is a contiguous fp32 [B,W] or null. tw (8, 16 or
// 32) columns and nseg segments of rglru_scan_rows() rows per CTA, at
// most 256 threads (tw * nseg). Returns a cudaError_t.
int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* h,
                   int dtype, int B, int S, int W, int tw, int nseg,
                   void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  if ((tw != 8 && tw != 16 && tw != 32) || nseg <= 0
      || tw * nseg > MAX_THREADS)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(a, b, h0f, h, B, S, W, tw, nseg, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(a, b, h0f, h, B, S, W, tw, nseg, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// rows of a block each thread holds (a block is nseg times as many)
int rglru_scan_rows(void) { return ROWS; }

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
