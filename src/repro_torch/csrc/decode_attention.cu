// One-token (decode) GQA attention over a ring-buffer KV cache for Hopper
// (sm_90a), CUDA C++ with a plain C entry point loaded through ctypes
// (repro_torch/kernels/_build.py).
//
// Replaces the Pallas TPU kernel decode_attention_kernel
// (src/repro/kernels/decode_attention/kernel.py, body _decode_kernel) and
// computes exactly decode_attention_ref (same file tree, ref.py):
//   q [B,H,D], k/v [B,Kh,C,D] given by strides, kpos [C] int32 (the
//   position each cache slot holds, -1 = empty), pos (the query's
//   position, a host int) -> o [B,H,D] in q's dtype, fp32 or bf16.
//   A slot is valid iff kpos >= 0 and kpos <= pos, and pos - kpos < window
//   and pos / chunk == kpos / chunk when those are given. Masked logits
//   are the oracle's finite -1e30, not -inf: a row whose every slot is
//   masked then gets a uniform softmax, mean(v) over all C slots, as the
//   oracle and the Pallas body give, and a split whose slots are all
//   masked weighs exp(-1e30 - m) = 0 once another split has a valid slot.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): decode reads every cache byte once for 4 flops per (head, slot,
// dim) pair, so it is memory-bound. qwen3-4b at B2 Kh8 C1040 D128 bf16
// reads 8.5 MB, about 2.5 us; recurrentgemma-9b's attention blocks at B2
// Kh1 C2048 D256 bf16 read 4.2 MB, about 1.3 us; a long cache of 32768
// slots at B1 Kh8 D128 bf16 reads 134 MB, about 40 us.
//
// Design: a grid of (split, b * Kh) CTAs. Each CTA owns the G query heads
// of one kv head and a range of the cache (split-KV), so recurrentgemma's
// B * Kh = 2 still spreads over the card; a second kernel combines the
// splits' partial (m, l, acc). The cache is read through strides, so the
// model's [B, C, Kh, D] cache reaches the kernel as a transposed view and
// no decoded token pays for a copy; C is any length, its ragged tail is
// masked. Inside a split, 32-slot tiles of k and v are staged in shared
// memory as fp32 (k rows padded for conflict-free reads); a thread per
// (head, slot) pair computes a score, one warp per head updates the online
// softmax (lane = slot), and the G x D accumulator lives in shared memory,
// a thread per element. All arithmetic runs on the CUDA cores in fp32: a
// simple first version, not yet near the memory bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per CTA of the split kernel
constexpr int NWARP = NT / 32;
constexpr int BK = 32;           // cache slots per tile: one per lane
constexpr int MAX_G = 64;        // query heads per kv head
constexpr float NEG = -1.0e30f;  // the oracle's mask value
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kpos;
  void* o;
  float* m_part;    // [B*Kh, splits, G]
  float* l_part;    // [B*Kh, splits, G]
  float* acc_part;  // [B*Kh, splits, G, D]
  int B, H, Kh, G, C, D;
  int64_t q_sb, q_sh;
  int64_t k_sb, k_sh, k_sc;
  int64_t v_sb, v_sh, v_sc;
  int64_t o_sb, o_sh;
  int pos, window, chunk;   // window / chunk < 0: no such mask
  float scale;
  int splits, split_len;    // split_len: a multiple of BK
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

// Positions are non-negative where this is reached, so / is floor.
__device__ __forceinline__ bool slot_valid(const Params& p, int kp) {
  if (kp < 0 || kp > p.pos) return false;
  if (p.window >= 0 && p.pos - kp >= p.window) return false;
  if (p.chunk > 0 && p.pos / p.chunk != kp / p.chunk) return false;
  return true;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const Params p) {
  constexpr int LDK = D + 1;     // padded k row: conflict-free reads
  extern __shared__ float smem[];
  const int G = p.G;
  float* sQ = smem;              // [G][D]
  float* sK = sQ + G * D;        // [BK][LDK]
  float* sV = sK + BK * LDK;     // [BK][D]
  float* sAcc = sV + BK * D;     // [G][D]
  float* sP = sAcc + G * D;      // [G][BK] scores, then probabilities
  float* sM = sP + G * BK;       // [G] running max
  float* sL = sM + G;            // [G] running denominator
  float* sAlpha = sL + G;        // [G] this tile's rescale of acc

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x;
  const int bk = blockIdx.y;     // b * Kh + kh
  const int b = bk / p.Kh, kh = bk - b * p.Kh;
  const int c0 = split * p.split_len;
  const int c1 = min(c0 + p.split_len, p.C);

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb +
                (int64_t)kh * G * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;

  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i - g * D;
    sQ[i] = to_f32(qb[g * p.q_sh + d]);
    sAcc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    sM[g] = NEG;
    sL[g] = 0.f;
  }

  for (int t0 = c0; t0 < c1; t0 += BK) {
    __syncthreads();             // last tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int j = i / D, d = i - j * D;
      const int64_t c = t0 + j;
      const bool in = t0 + j < c1;
      sK[j * LDK + d] = in ? to_f32(kb[c * p.k_sc + d]) : 0.f;
      sV[j * D + d] = in ? to_f32(vb[c * p.v_sc + d]) : 0.f;
    }
    __syncthreads();

    // scores: a thread per (head, slot); the 32 lanes of a warp take the
    // 32 slots of one head
    for (int i = tid; i < G * BK; i += NT) {
      const int g = i / BK, j = i - g * BK;
      float s = -INFINITY;       // past the split's end: no slot at all
      if (t0 + j < c1) {
        const float* qr = sQ + g * D;
        const float* kr = sK + j * LDK;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s = slot_valid(p, p.kpos[t0 + j]) ? dot * p.scale : NEG;
      }
      sP[i] = s;
    }
    __syncthreads();

    // online softmax: a warp per head, lane j holds slot j of the tile
    for (int g = warp; g < G; g += NWARP) {
      const float s = sP[g * BK + lane];
      float mt = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mt);   // >= NEG: finite
      const float pj = (s == -INFINITY) ? 0.f : expf(s - m_new);
      float ls = pj;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ls += __shfl_xor_sync(FULL, ls, off);
      sP[g * BK + lane] = pj;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sAlpha[g] = alpha;
        sL[g] = sL[g] * alpha + ls;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * alpha[g] + sum_j p[g][j] v[j][d]; a thread per
    // element, neighbouring threads on neighbouring d
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D, d = i - g * D;
      const float* pr = sP + g * BK;
      float a = sAcc[i] * sAlpha[g];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a += pr[j] * sV[j * D + d];
      sAcc[i] = a;
    }
  }
  __syncthreads();

  const int64_t part = (int64_t)bk * p.splits + split;
  float* accp = p.acc_part + part * G * D;
  for (int i = tid; i < G * D; i += NT) accp[i] = sAcc[i];
  for (int g = tid; g < G; g += NT) {
    p.m_part[part * G + g] = sM[g];
    p.l_part[part * G + g] = sL[g];
  }
}

// One CTA per (b, h): o = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30)
// with w_s = exp(m_s - max_s m_s).
template <typename T>
__global__ void __launch_bounds__(NT)
decode_combine_kernel(const Params p) {
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kh = h / p.G, g = h - kh * p.G;
  const int64_t part0 = (int64_t)(b * p.Kh + kh) * p.splits;
  float M = NEG;
  for (int s = 0; s < p.splits; ++s)
    M = fmaxf(M, p.m_part[(part0 + s) * p.G + g]);
  float L = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const int64_t i = (part0 + s) * p.G + g;
    L += p.l_part[i] * expf(p.m_part[i] - M);
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int d = threadIdx.x; d < p.D; d += NT) {
    float acc = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const int64_t i = (part0 + s) * p.G + g;
      acc += p.acc_part[i * p.D + d] * expf(p.m_part[i] - M);
    }
    ob[d] = from_f32<T>(acc * inv);
  }
}

template <int D>
constexpr size_t smem_floats(int G) {
  return (size_t)G * D * 2 + BK * (D + 1) + BK * D + (size_t)G * BK + 3 * G;
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>(p.G);
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_split_kernel<T, D>
      <<<dim3(p.splits, p.B * p.Kh), NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<p.B * p.H, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, cudaStream_t stream) {
  switch (p.D) {
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o). Strides are in elements;
// the last dimension of q, k, v and o is contiguous. m_part / l_part hold
// B*Kh*splits*G floats and acc_part that times D; split_len is a positive
// multiple of 32 with splits * split_len >= C. Returns a cudaError_t.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* kpos, void* o, void* m_part,
                         void* l_part, void* acc_part, int dtype, int B,
                         int H, int Kh, int C, int D, int64_t q_sb,
                         int64_t q_sh, int64_t k_sb, int64_t k_sh,
                         int64_t k_sc, int64_t v_sb, int64_t v_sh,
                         int64_t v_sc, int64_t o_sb, int64_t o_sh, int pos,
                         int window, int chunk, float scale, int splits,
                         int split_len, void* stream) {
  if (B <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 || C <= 0 || pos < 0 ||
      H / Kh > MAX_G || splits <= 0 || split_len <= 0 ||
      split_len % BK != 0 || (int64_t)splits * split_len < C ||
      B * Kh > 65535)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const int*>(kpos), o,
                 static_cast<float*>(m_part), static_cast<float*>(l_part),
                 static_cast<float*>(acc_part), B, H, Kh, H / Kh, C, D,
                 q_sb, q_sh, k_sb, k_sh, k_sc, v_sb, v_sh, v_sc, o_sb, o_sh,
                 pos, window, chunk, scale, splits, split_len};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch_d<float>(p, st);
  else if (dtype == 1) err = launch_d<__nv_bfloat16>(p, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
