// Backward of the RG-LRU linear recurrence for Hopper (sm_90a), CUDA C++
// with a plain C entry point loaded through ctypes
// (repro_torch/kernels/_build.py).
//
// Stands in for jax.grad of src/repro/models/rglru.py:115
// (rglru_scan_full): the JAX package differentiates the hybrid's
// recurrence with XLA, and the Pallas kernel rglru_scan_kernel has no
// backward. This source is the backward of the port's forward kernel
// (csrc/rglru_scan.cu), h_t = a_t * h_{t-1} + b_t, and computes the
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
// [2, 2100, 4096] fp32, 344 MB, 0.103 ms (bf16 0.051 ms).
//
// Design: the forward kernel's, run backwards. With a'_t = a_{t+1},
// g_t = dy_t + a'_t * g_{t+1} is the forward recurrence over reversed
// rows, with (a', dy) in place of (a, b).
// - A CTA owns one batch row and a tile of TW consecutive columns (grid
//   B * ceil(W / TW) on x); each lane owns one column, so a row of the
//   tile is one coalesced read of TW elements.
// - The CTA walks S in blocks of NSEG * ROWS rows from the last block
//   toward row 0. Thread (seg, col) (threadIdx.x = seg * TW + col) holds
//   rows [seg * ROWS, (seg + 1) * ROWS) of the block in registers.
// - Local scan: each thread walks its rows from the last to the first
//   from a zero carry and keeps P = prod(a') and G, the g at its first
//   row, written to shared memory.
// - Carries: after one barrier, every thread walks the NSEG (P, G) pairs
//   of its column from the last segment to the first, c <- P_j * c + G_j,
//   starting from the carry into the block (g at the row after it; 0 for
//   the last block). That gives its own carry-in (at j = seg) and the
//   carry into the block before (after j = 0), all in fp32.
// - Re-walk: each thread runs g = a' * g + dy over its rows again from
//   its carry-in, in the plain version's order, and writes db = g and
//   da = g * h_{t-1}, each rounded once to the output type.
// - Shifted loads: a thread loads a one row down (row t + 1 for row t)
//   and h one row up (row t - 1), so no value crosses a segment or block
//   edge and no halo is exchanged: every element of a, h and dy is read
//   once (a_0 once more, for dh0; h_{S-1} never) and da, db written once,
//   the bound's bytes. a_S does not exist: its address is the next batch
//   row's row 0, or past the allocation for the last, so row S - 1 takes
//   a' = 1 without a load (it multiplies g_S = 0; a loaded inf would make
//   0 * inf a NaN). Row 0 takes h_{-1} = h0 in fp32 (or 0), never a load.
// - Rows past S are the identity (a' = 1, dy = 0), so their g is 0 and
//   the carry into row S - 1 is g_S = 0; they are neither read nor
//   written; columns past W neither.
// - Overlap: the next (earlier) block's loads are issued into a second
//   register buffer before the current block's scan and stores, so loads
//   stay in flight across the chain; the two buffers (and two shared
//   slots, so one barrier a block suffices) alternate. Loads ask L2 for
//   the aligned 256 bytes around each piece (ld.global.nc.L2::256B), as
//   the forward's do: a CTA reads 64 or 128 bytes of a row and its
//   neighbouring tiles' CTAs the rest at about the same time.
// - Registers: 3 inputs x ROWS x 2 buffers are 96 registers of data a
//   thread in fp32, so a CTA has at most MAX_THREADS = 192 threads and
//   the bounds ask for 2 CTAs an SM: at most 168 registers a thread.
// - Launch: a programmatic dependent launch (cudaLaunchKernelEx) that
//   executes griddepcontrol.wait before it touches global memory, as the
//   forward does.
// - No atomics, and each element is written by one thread: two calls
//   give the same bits.
// TW and NSEG are chosen by the binding's bwd_plan (kernels/rglru_scan/
// kernel.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;          // rows of a block each thread holds
constexpr int MAX_THREADS = 192;  // TW * NSEG at most, per CTA

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

// a thread's rows of one block, shifted: row r holds a_{t+1}, dy_t and
// h_{t-1} for t = its first row + r; kept in the input type
template <typename T> struct Rows {
  T a[ROWS], dy[ROWS], h[ROWS];
};

struct Column {
  int S, W, r_seg;   // r_seg: the thread's first row within a block
  int block_rows;
  bool ok;           // the column lies inside W
};

// Issue the loads of block k's rows of this thread (k may be -1: no
// rows). Rows past S, and a_S, are the identity; h_{-1} is taken from
// h0 by the re-walk.
template <typename T>
__device__ __forceinline__ void load_rows(Rows<T>& buf, const T* ap,
                                          const T* dyp, const T* hp,
                                          const Column& c, int k) {
  const int r0 = k * c.block_rows + c.r_seg;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int t = r0 + r;
    if (c.ok && t >= 0 && t < c.S)
      buf.dy[r] = load_l2_256(dyp + (int64_t)t * c.W);
    else
      buf.dy[r] = from_f32<T>(0.f);
    if (c.ok && t >= 0 && t + 1 < c.S)
      buf.a[r] = load_l2_256(ap + (int64_t)(t + 1) * c.W);
    else
      buf.a[r] = from_f32<T>(1.f);
    if (c.ok && t > 0 && t < c.S)
      buf.h[r] = load_l2_256(hp + (int64_t)(t - 1) * c.W);
    else
      buf.h[r] = from_f32<T>(0.f);
  }
}

// Block k: prefetch block k - 1 into nxt, then run cur (local scan,
// carries through shared slot Ps/Gs, re-walk and stores). Returns the
// carry into block k - 1 (g at block k's first row).
template <typename T>
__device__ __forceinline__ float bwd_block(
    const Rows<T>& cur, Rows<T>& nxt, const T* ap, const T* dyp,
    const T* hp, T* dap, T* dbp, const Column& c, int k, int tw, int nseg,
    float carry, float hinit, float* __restrict__ Ps,
    float* __restrict__ Gs) {
  load_rows(nxt, ap, dyp, hp, c, k - 1);
  float P = 1.f, G = 0.f;
#pragma unroll
  for (int r = ROWS - 1; r >= 0; --r) {
    const float av = to_f32(cur.a[r]);
    P *= av;
    G = fmaf(av, G, to_f32(cur.dy[r]));
  }
  Ps[threadIdx.x] = P;
  Gs[threadIdx.x] = G;
  __syncthreads();
  const int seg = threadIdx.x / tw, lane_col = threadIdx.x - seg * tw;
  float g = carry;
  for (int j = nseg - 1; j >= 0; --j) {
    if (j == seg) g = carry;
    carry = fmaf(Ps[j * tw + lane_col], carry, Gs[j * tw + lane_col]);
  }
  const int r0 = k * c.block_rows + c.r_seg;
#pragma unroll
  for (int r = ROWS - 1; r >= 0; --r) {
    g = fmaf(to_f32(cur.a[r]), g, to_f32(cur.dy[r]));
    const int t = r0 + r;
    if (c.ok && t < c.S) {
      const float hv = t == 0 ? hinit : to_f32(cur.h[r]);
      dbp[(int64_t)t * c.W] = from_f32<T>(g);
      dap[(int64_t)t * c.W] = from_f32<T>(g * hv);
    }
  }
  return carry;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 2)
rglru_scan_bwd_split(const T* __restrict__ a, const T* __restrict__ h,
                     const T* __restrict__ dy, const float* __restrict__ h0,
                     T* __restrict__ da, T* __restrict__ db,
                     float* __restrict__ dh0, int S, int W, int tw,
                     int nseg) {
  // two slots of (P, G), used by alternate blocks: a slot is written
  // again only after the next block's barrier, which every thread passes
  // after reading it
  __shared__ float Ps[2][MAX_THREADS], Gs[2][MAX_THREADS];
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
  const T* dyp = dy + base;
  const T* hp = h + base;
  T* dap = da + base;
  T* dbp = db + base;
  const bool with_h0 = h0 != nullptr && c.ok;
  const float hinit = with_h0 ? h0[(int64_t)bi * W + col] : 0.f;
  // a_0 for dh0: the one element of a read twice
  const float a0 = with_h0 && seg == 0 ? to_f32(ap[0]) : 0.f;
  const int blocks = (S + c.block_rows - 1) / c.block_rows;

  float carry = 0.f;  // g_S
  Rows<T> x, y;
  load_rows(x, ap, dyp, hp, c, blocks - 1);
  for (int k = blocks - 1; k >= 0; k -= 2) {
    carry = bwd_block(x, y, ap, dyp, hp, dap, dbp, c, k, tw, nseg, carry,
                      hinit, Ps[0], Gs[0]);
    if (k >= 1)
      carry = bwd_block(y, x, ap, dyp, hp, dap, dbp, c, k - 1, tw, nseg,
                        carry, hinit, Ps[1], Gs[1]);
  }
  if (with_h0 && seg == 0) dh0[(int64_t)bi * W + col] = a0 * carry;
}

template <typename T>
cudaError_t launch(const void* a, const void* h, const void* dy,
                   const float* h0, void* da, void* db, float* dh0, int B,
                   int S, int W, int tw, int nseg, cudaStream_t stream) {
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
      &cfg, rglru_scan_bwd_split<T>, static_cast<const T*>(a),
      static_cast<const T*>(h), static_cast<const T*>(dy), h0,
      static_cast<T*>(da), static_cast<T*>(db), dh0, S, W, tw, nseg);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, h, dy, da, db); h0 and dh0 are
// fp32 [B, W], both null when the forward had no h0. tw (8, 16 or 32)
// columns and nseg segments of rglru_scan_bwd_rows() rows per CTA, at
// most rglru_scan_bwd_max_threads() threads (tw * nseg). Returns a
// cudaError_t.
int rglru_scan_bwd(const void* a, const void* h, const void* dy,
                   const float* h0, void* da, void* db, float* dh0,
                   int dtype, int B, int S, int W, int tw, int nseg,
                   void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || ((h0 == nullptr) != (dh0 == nullptr)))
    return cudaErrorInvalidValue;
  if ((tw != 8 && tw != 16 && tw != 32) || nseg <= 0
      || tw * nseg > MAX_THREADS)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(a, h, dy, h0, da, db, dh0, B, S, W, tw, nseg, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(a, h, dy, h0, da, db, dh0, B, S, W, tw,
                                nseg, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// rows of a block each thread holds (a block is nseg times as many)
int rglru_scan_bwd_rows(void) { return ROWS; }

// the most threads (tw * nseg) a CTA may have
int rglru_scan_bwd_max_threads(void) { return MAX_THREADS; }

const char* rglru_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
