// Prefill flash attention for Hopper (sm_90a), CUDA C++ with a plain C
// entry point loaded through ctypes (repro_torch/kernels/_build.py).
//
// Replaces the Pallas TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py, body _flash_kernel) and
// computes exactly flash_attention_ref (same file tree, ref.py):
//   q [B,H,Sq,D], k/v [B,Kh,Sk,D] -> o [B,H,Sq,D], fp32 or bf16 in and out,
//   fp32 softmax statistics and accumulator, GQA (query head h reads kv
//   head h / (H / Kh)), masks from indices (causal kpos <= qpos, window
//   qpos - kpos < window, chunk qpos / c == kpos / c), default scale
//   D ** -0.5 chosen by the caller. A row whose every key is masked returns
//   mean(v) over all Sk keys, as the oracle does (its softmax over a row of
//   equal -1e30 logits is uniform). Ragged Sq and Sk are masked, not
//   asserted: serving runs S = 48.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the serving
// shapes the kernel is memory-bound. The hi service (B=2, H=32, Kh=8,
// S=48, D=128, bf16) moves about 2.0 MB (q, k, v read once, o written
// once), about 0.6 us at 3.35 TB/s, against 39 MFLOP of causal QK^T and
// PV (0.04 us at 989 TFLOP/s); the lo service (B=4, H=Kh=32, S=48, D=64)
// about 3.1 MB. Only at long Sq does the S^2 * D work make it
// compute-bound (S=4096, H=32, D=128: 137 GFLOP against 67 MB).
//
// Design: what matters at the serving shapes is reading each input once
// and writing the output once, so one CTA owns a 64-row q tile of one
// (batch, head) and walks the kv tiles with the running max, denominator
// and accumulator in registers; q, k and v never return to device memory
// and the [Sq, Sk] scores never exist there. kv tiles that the causal,
// window or chunk mask removes entirely are skipped, which halves the work
// of long causal prefill. Strides are arguments, so the caller passes
// transposed [B,S,H,D] projections without a copy, and the output may be
// written straight into a [B,S,H,D] buffer. The arithmetic runs on the
// CUDA cores in fp32 (no wgmma, no TMA): at long Sq that leaves the kernel
// far from the tensor-core bound, which a later revision addresses.
//
// Thread layout: 256 threads; thread t serves q row t / 4 of the tile and
// lane c = t % 4 of that row. For scores the lane takes keys c, c+4, ...;
// for the output it owns columns c, c+4, ..., so the four lanes of a row
// read neighbouring shared-memory words. Row statistics are reduced with
// two xor shuffles inside the group of four.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // keys per kv tile
constexpr int NT = 256;       // threads per CTA: 4 per q row

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Kh, Sq, Sk;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int causal, window, chunk;  // window / chunk < 0: no such mask
  float scale;
};

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

__device__ __forceinline__ bool allowed(const Params& p, int qpos,
                                        int kpos) {
  if (kpos >= p.Sk) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window >= 0 && qpos - kpos >= p.window) return false;
  if (p.chunk > 0 && qpos / p.chunk != kpos / p.chunk) return false;
  return true;
}

// True when no (q, k) pair of rows [q0, q1] x keys [k0, k1] survives the
// mask. Positions are non-negative, so integer division is floor.
__device__ __forceinline__ bool tile_masked(const Params& p, int q0, int q1,
                                            int k0, int k1) {
  if (p.causal && k0 > q1) return true;
  if (p.window >= 0 && q0 - k1 >= p.window) return true;
  if (p.chunk > 0 && (k1 / p.chunk < q0 / p.chunk ||
                      k0 / p.chunk > q1 / p.chunk)) return true;
  return false;
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t stride, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = (row0 + r < rows)
        ? to_f32(src[(int64_t)(row0 + r) * stride + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const Params p) {
  static_assert(BQ == BK, "load_tile assumes square tiles");
  constexpr int LD = D + 1;      // padded row: conflict-free column reads
  constexpr int DPT = D / 4;     // output columns per lane
  constexpr int KPT = BK / 4;    // keys per lane per tile
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][LD]
  float* sK = sQ + BQ * LD;      // [BK][LD]
  float* sV = sK + BK * LD;      // [BK][D]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = tid >> 2, c = tid & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kh = h / (p.H / p.Kh);
  const int q0 = blockIdx.x * BQ;
  const int q1 = min(q0 + BQ, p.Sq) - 1;
  const int qpos = q0 + r;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;

  load_tile<T, D>(sQ, LD, qb, p.q_ss, q0, p.Sq);

  float m = -INFINITY, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    const int k1 = min(k0 + BK, p.Sk) - 1;
    if (tile_masked(p, q0, q1, k0, k1)) continue;   // uniform over the CTA
    __syncthreads();          // last tile's readers are done; sQ is visible
    load_tile<T, D>(sK, LD, kb, p.k_ss, k0, p.Sk);
    load_tile<T, D>(sV, D, vb, p.v_ss, k0, p.Sk);
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * LD + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] += qd * sK[(c + 4 * j) * LD + d];
    }

    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      s[j] = allowed(p, qpos, k0 + c + 4 * j) ? s[j] * p.scale : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    // nothing unmasked yet: keep the (zero) state as it is
    const float alpha = (m_new == -INFINITY) ? 1.f : expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      s[j] = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_new);
      ls += s[j];
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    m = m_new;

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float pj = __shfl_sync(0xffffffffu, s[j], (lane & ~3) | cc);
        const float* vrow = sV + (cc + 4 * j) * D;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] += pj * vrow[c + 4 * i];
      }
    }
  }

  // A row with no unmasked key: the oracle's uniform softmax, mean(v).
  const bool empty = qpos < p.Sq && l == 0.f;
  if (__syncthreads_or(empty)) {
    for (int k0 = 0; k0 < p.Sk; k0 += BK) {
      __syncthreads();
      load_tile<T, D>(sV, D, vb, p.v_ss, k0, p.Sk);
      __syncthreads();
      if (empty) {
        const int n = min(BK, p.Sk - k0);
        for (int j = 0; j < n; ++j) {
#pragma unroll
          for (int i = 0; i < DPT; ++i) acc[i] += sV[j * D + c + 4 * i];
        }
      }
    }
    if (empty) l = static_cast<float>(p.Sk);
  }

  if (qpos < p.Sq) {
    T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh +
            (int64_t)qpos * p.o_ss;
#pragma unroll
    for (int i = 0; i < DPT; ++i) ob[c + 4 * i] = from_f32<T>(acc[i] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // above 48 KB only as opted-in dynamic shared memory (D=128: 96.5 KB);
  // set once per instantiation (a thread-safe static initialisation)
  constexpr size_t smem = sizeof(float) * (2 * BQ * (D + 1) + BK * D);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(p, stream);
    case 96: return launch<T, 96>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of every tensor is contiguous. Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int Kh, int Sq, int Sk,
                        int D, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                        int64_t k_sb, int64_t k_sh, int64_t k_ss,
                        int64_t v_sb, int64_t v_sh, int64_t v_ss,
                        int64_t o_sb, int64_t o_sh, int64_t o_ss,
                        int causal, int window, int chunk, float scale,
                        void* stream) {
  if (B <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, o, B, H, Kh, Sq, Sk,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                 causal, window, chunk, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch_d<float>(p, D, st);
  else if (dtype == 1) err = launch_d<__nv_bfloat16>(p, D, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
