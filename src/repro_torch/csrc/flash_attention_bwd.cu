// Backward of the prefill flash attention for Hopper (sm_90a), CUDA C++
// with a plain C entry point loaded through ctypes
// (repro_torch/kernels/_build.py).
//
// The JAX package differentiates its jnp attention with XLA (jax.grad of
// src/repro/models/attention.py::attend); the Pallas kernel
// flash_attention_kernel has no backward. This source is the backward of
// the port's forward kernel (csrc/flash_attention.cu) and computes the
// gradients that autograd gives of flash_attention_ref
// (kernels/flash_attention/ref.py):
//   q [B,H,Sq,D], k/v [B,Kh,Sk,D] and dO [B,H,Sq,D] -> dq, dk, dv of q's,
//   k's and v's shapes, fp32 or bf16 in
//   and out, every sum in fp32. Masks (causal, window, chunk; positions
//   are the indices 0..Sq-1 and 0..Sk-1), GQA (query head h reads kv head
//   h / (H / Kh); dk and dv sum over the group's heads) and the scale are
//   the forward's. A row with every key masked got mean(v) forward (the
//   oracle's uniform softmax over a row of equal -1e30 logits): its dO
//   reaches dv as dO / Sk at every key, and dq and dk get nothing from it,
//   as autograd of the oracle gives (its mask is a where, whose gradient
//   is zero at a masked logit). Every tensor is given by strides with a
//   contiguous last dim, so the transposed [B,S,H,D] views that attend
//   passes need no copy.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): the backward does
// the work of five S x D products per (b, h) over the allowed (q, k)
// pairs (recompute Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q,
// dQ = dS K), 10 flops per pair and column; at qwen3-4b's train shape
// (B2 H32 Kh8 S2048 D128, causal) that is 172 GFLOP, 0.174 ms, against
// 42 MB of inputs and outputs (13 us). So operations bound it.
//
// Design: plain and deterministic, with no atomics; every sum is taken by
// one thread in a fixed order. Three passes, each a kernel of 256
// threads over 32-row tiles held in fp32 in shared memory (rows padded to
// D + 1 floats, so column reads by different rows hit different banks):
// 1. lse and Di: one CTA per (b, h, 32 query rows) walks the key tiles the
//    mask leaves and recomputes the forward in fp32: each row's logsumexp
//    of the scaled scores and its output o (an online softmax, as the
//    forward's fp32 instances run it), then Di = rowsum(dO * o). Di from
//    this fp32 o, not from the forward's saved output: the bf16 output
//    (and the bf16 forward's P, rounded for wgmma) is 2^-9 off per
//    element, which puts errors of several per cent of a row's size into
//    the dq rows that cancel most (dS sums to zero over a row); the fp32
//    o costs one more S x D product here and keeps the backward within
//    one bf16 rounding of the plain version's gradients. A row with no
//    allowed key keeps lse = -inf, which marks it for pass 2. The forward
//    kernel writes no statistics and saves nothing extra.
// 2. dK and dV: one CTA per (b, kv head, 32 keys) holds its K and V tiles
//    and walks the group's query heads and, for each, the query tiles the
//    mask leaves. Thread (key r, lane c) recomputes the scores and dP of
//    its key against query rows c, c + 8, ... (P = exp(s - lse),
//    dS = P (dP - Di)), which go to shared memory; then it adds P^T dO
//    and dS^T Q into its columns c, c + 8, ... of dV and dK, kept in
//    registers across the whole walk. The rows with every key masked
//    (lse = -inf) are found 256 at a time with one barrier vote, and
//    their dO, summed in row order over the group, is added to every
//    key's dV over Sk.
// 3. dQ: one CTA per (b, h, 32 query rows) walks the key tiles, recomputes
//    P and dS for its rows and adds dS K into its rows' dQ in registers.
// The three passes run in order on the caller's stream. Tensor cores (mma
// or wgmma tiles, as the forward's bf16 instances use) are left for the
// kernel's redesign.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 32;        // rows of a query tile and of a key tile
constexpr int NT = 256;       // threads per CTA
constexpr int LN = NT / BT;   // lanes per row: 8
constexpr int LDP = BT + 1;   // padded row of the P and dS tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;                 // [B, H, Sq] contiguous
  float* di;                  // [B, H, Sq] contiguous
  int B, H, Kh, Sq, Sk;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
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
  return __float2bfloat16(x);
}

// The forward's mask for one (q, k) pair of indices in range.
__device__ __forceinline__ bool allowed(const Params& p, int qpos,
                                        int kpos) {
  if (qpos >= p.Sq || kpos >= p.Sk) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window >= 0 && qpos - kpos >= p.window) return false;
  if (p.chunk > 0 && qpos / p.chunk != kpos / p.chunk) return false;
  return true;
}

// True when no (q, k) pair of rows [q0, q1] x keys [k0, k1] survives the
// mask (the forward's rule; positions are non-negative).
__device__ __forceinline__ bool tile_masked(const Params& p, int q0, int q1,
                                            int k0, int k1) {
  if (p.causal && k0 > q1) return true;
  if (p.window >= 0 && q0 - k1 >= p.window) return true;
  if (p.chunk > 0 && (k1 / p.chunk < q0 / p.chunk ||
                      k0 / p.chunk > q1 / p.chunk)) return true;
  return false;
}

// rows [row0, row0 + BT) of a [rows, D] slab with row stride ``stride``
// into dst [BT][D + 1] as fp32, zeros past ``rows``
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < BT * D; i += NT) {
    const int r = i / D, d = i - r * D;
    dst[r * (D + 1) + d] = (row0 + r < rows)
        ? to_f32(src[(int64_t)(row0 + r) * stride + d]) : 0.f;
  }
}

// ------------------------------------------------------ pass 1: lse, Di
// A forward recompute in fp32: the row's online max and sum over the
// lanes' keys (merged across its 8 lanes each tile, so the lanes share one
// running max), and o = P V / l in the lanes' columns; then Di = dO . o.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_stats(const Params p) {
  constexpr int LD = D + 1;
  constexpr int KPT = BT / LN;   // keys per lane per tile
  constexpr int CPT = D / LN;    // columns per lane
  extern __shared__ float smem[];
  float* sQ = smem;              // [BT][LD]
  float* sK = sQ + BT * LD;      // [BT][LD]
  float* sV = sK + BT * LD;      // [BT][LD]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = tid / LN, c = tid % LN;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kh = h / (p.H / p.Kh);
  const int q0 = blockIdx.x * BT;
  const int q1 = min(q0 + BT, p.Sq) - 1;
  const int qpos = q0 + r;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  load_tile<T, D>(sQ, qb, p.q_ss, q0, p.Sq);

  float m = -INFINITY, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += BT) {
    const int k1 = min(k0 + BT, p.Sk) - 1;
    if (tile_masked(p, q0, q1, k0, k1)) continue;   // uniform over the CTA
    __syncthreads();
    load_tile<T, D>(sK, kb, p.k_ss, k0, p.Sk);
    load_tile<T, D>(sV, vb, p.v_ss, k0, p.Sk);
    __syncthreads();
    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * LD + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] += qd * sK[(c + LN * j) * LD + d];
    }
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      s[j] = allowed(p, qpos, k0 + c + LN * j) ? s[j] * p.scale : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
#pragma unroll
    for (int off = 1; off < LN; off <<= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float m_new = fmaxf(m, mt);
    // nothing unmasked yet: keep the (zero) state as it is
    const float alpha = (m_new == -INFINITY) ? 1.f : expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      s[j] = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_new);
      ls += s[j];
    }
#pragma unroll
    for (int off = 1; off < LN; off <<= 1)
      ls += __shfl_xor_sync(0xffffffffu, ls, off);
    l = l * alpha + ls;
    m = m_new;
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
#pragma unroll
      for (int cc = 0; cc < LN; ++cc) {
        // key cc + 8 j's weight, held by lane cc of this row
        const float pj =
            __shfl_sync(0xffffffffu, s[j], (lane & ~(LN - 1)) | cc);
        const float* vrow = sV + (cc + LN * j) * LD + c;
#pragma unroll
        for (int i = 0; i < CPT; ++i) acc[i] += pj * vrow[LN * i];
      }
    }
  }

  // Di = dO . o, lane c over its columns c, c + 8, ...
  float di = 0.f;
  if (qpos < p.Sq && l > 0.f) {
    const T* gb = static_cast<const T*>(p.dout) + b * p.do_sb +
                  h * p.do_sh + (int64_t)qpos * p.do_ss;
#pragma unroll
    for (int i = 0; i < CPT; ++i) di += to_f32(gb[c + LN * i]) * acc[i];
    di /= l;
  }
#pragma unroll
  for (int off = 1; off < LN; off <<= 1)
    di += __shfl_xor_sync(0xffffffffu, di, off);

  if (c == 0 && qpos < p.Sq) {
    const int64_t row = (int64_t)bh * p.Sq + qpos;
    p.lse[row] = (m == -INFINITY) ? -INFINITY : m + logf(l);
    p.di[row] = di;
  }
}

// ------------------------------------------------------ pass 2: dK, dV
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const Params p) {
  constexpr int LD = D + 1;
  constexpr int QPT = BT / LN;   // query rows per lane per tile
  constexpr int CPT = D / LN;    // columns per lane
  extern __shared__ float smem[];
  float* sK = smem;              // [BT][LD]
  float* sV = sK + BT * LD;      // [BT][LD]
  float* sQ = sV + BT * LD;      // [BT][LD]
  float* sG = sQ + BT * LD;      // [BT][LD]  dO
  float* sP = sG + BT * LD;      // [BT keys][LDP]
  float* sS = sP + BT * LDP;     // [BT keys][LDP]  dS
  float* sL = sS + BT * LDP;     // [BT] lse
  float* sD = sL + BT;           // [BT] Di
  float* sE = sD + BT;           // [D] dO summed over the all-masked rows
  int* sF = reinterpret_cast<int*>(sE + D);   // [NT] all-masked flags

  const int tid = threadIdx.x;
  const int r = tid / LN, c = tid % LN;
  const int bk = blockIdx.y;
  const int b = bk / p.Kh, kh = bk - b * p.Kh;
  const int G = p.H / p.Kh;
  const int k0 = blockIdx.x * BT;
  const int k1 = min(k0 + BT, p.Sk) - 1;
  const int kpos = k0 + r;

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  load_tile<T, D>(sK, kb, p.k_ss, k0, p.Sk);
  load_tile<T, D>(sV, vb, p.v_ss, k0, p.Sk);
  for (int d = tid; d < D; d += NT) sE[d] = 0.f;

  float dk[CPT], dv[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) dk[i] = dv[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const int64_t bh = (int64_t)b * p.H + h;
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* gb = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const float* lse = p.lse + bh * p.Sq;
    const float* dia = p.di + bh * p.Sq;

    for (int q0 = 0; q0 < p.Sq; q0 += BT) {
      const int q1 = min(q0 + BT, p.Sq) - 1;
      if (tile_masked(p, q0, q1, k0, k1)) continue;   // uniform
      __syncthreads();       // the last tile's readers are done
      load_tile<T, D>(sQ, qb, p.q_ss, q0, p.Sq);
      load_tile<T, D>(sG, gb, p.do_ss, q0, p.Sq);
      if (tid < BT) {
        const bool in = q0 + tid < p.Sq;
        sL[tid] = in ? lse[q0 + tid] : 0.f;
        sD[tid] = in ? dia[q0 + tid] : 0.f;
      }
      __syncthreads();

      // scores and dP of key r against query rows c, c + 8, ...
      float s[QPT], dp[QPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kd = sK[r * LD + d], vd = sV[r * LD + d];
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          s[j] += kd * sQ[(c + LN * j) * LD + d];
          dp[j] += vd * sG[(c + LN * j) * LD + d];
        }
      }
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int qi = c + LN * j;
        const float pr = allowed(p, q0 + qi, kpos)
            ? expf(s[j] * p.scale - sL[qi]) : 0.f;
        sP[r * LDP + qi] = pr;
        sS[r * LDP + qi] = pr * (dp[j] - sD[qi]);
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's rows, in row order
#pragma unroll 2
      for (int qi = 0; qi < BT; ++qi) {
        const float pr = sP[r * LDP + qi], ds = sS[r * LDP + qi];
        const float* grow = sG + qi * LD + c;
        const float* qrow = sQ + qi * LD + c;
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          dv[i] += pr * grow[LN * i];
          dk[i] += ds * qrow[LN * i];
        }
      }
    }

    // rows with every key masked (lse = -inf): their dO / Sk reaches
    // every key's dV. Found 256 rows at a time by one barrier vote, so a
    // mask without such rows costs one read of lse per row.
    for (int base = 0; base < p.Sq; base += NT) {
      const int qpos = base + tid;
      const int empty = qpos < p.Sq && lse[qpos] == -INFINITY;
      if (!__syncthreads_or(empty)) continue;
      sF[tid] = empty;
      __syncthreads();
      for (int d = tid; d < D; d += NT) {
        float acc = sE[d];
        const int n = min(NT, p.Sq - base);
        for (int i = 0; i < n; ++i)
          if (sF[i]) acc += to_f32(gb[(int64_t)(base + i) * p.do_ss + d]);
        sE[d] = acc;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  if (kpos < p.Sk) {
    T* dkb = static_cast<T*>(p.dk) + b * p.dk_sb + kh * p.dk_sh +
             (int64_t)kpos * p.dk_ss;
    T* dvb = static_cast<T*>(p.dv) + b * p.dv_sb + kh * p.dv_sh +
             (int64_t)kpos * p.dv_ss;
    const float inv_sk = 1.f / static_cast<float>(p.Sk);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int d = c + LN * i;
      dkb[d] = from_f32<T>(dk[i] * p.scale);
      dvb[d] = from_f32<T>(dv[i] + sE[d] * inv_sk);
    }
  }
}

// ------------------------------------------------------------ pass 3: dQ
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const Params p) {
  constexpr int LD = D + 1;
  constexpr int KPT = BT / LN;   // keys per lane per tile
  constexpr int CPT = D / LN;    // columns per lane
  extern __shared__ float smem[];
  float* sQ = smem;              // [BT][LD]
  float* sG = sQ + BT * LD;      // [BT][LD]  dO
  float* sK = sG + BT * LD;      // [BT][LD]
  float* sV = sK + BT * LD;      // [BT][LD]
  float* sS = sV + BT * LD;      // [BT rows][LDP]  dS

  const int tid = threadIdx.x;
  const int r = tid / LN, c = tid % LN;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kh = h / (p.H / p.Kh);
  const int q0 = blockIdx.x * BT;
  const int q1 = min(q0 + BT, p.Sq) - 1;
  const int qpos = q0 + r;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* gb = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  load_tile<T, D>(sQ, qb, p.q_ss, q0, p.Sq);
  load_tile<T, D>(sG, gb, p.do_ss, q0, p.Sq);
  const int64_t row = (int64_t)bh * p.Sq + qpos;
  const float lse = qpos < p.Sq ? p.lse[row] : 0.f;
  const float di = qpos < p.Sq ? p.di[row] : 0.f;

  float dq[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) dq[i] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += BT) {
    const int k1 = min(k0 + BT, p.Sk) - 1;
    if (tile_masked(p, q0, q1, k0, k1)) continue;   // uniform
    __syncthreads();
    load_tile<T, D>(sK, kb, p.k_ss, k0, p.Sk);
    load_tile<T, D>(sV, vb, p.v_ss, k0, p.Sk);
    __syncthreads();

    float s[KPT], dp[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * LD + d], gd = sG[r * LD + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[j] += qd * sK[(c + LN * j) * LD + d];
        dp[j] += gd * sV[(c + LN * j) * LD + d];
      }
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int ki = c + LN * j;
      const float pr = allowed(p, qpos, k0 + ki)
          ? expf(s[j] * p.scale - lse) : 0.f;
      sS[r * LDP + ki] = pr * (dp[j] - di);
    }
    __syncthreads();

#pragma unroll 2
    for (int ki = 0; ki < BT; ++ki) {
      const float ds = sS[r * LDP + ki];
      const float* krow = sK + ki * LD + c;
#pragma unroll
      for (int i = 0; i < CPT; ++i) dq[i] += ds * krow[LN * i];
    }
  }

  if (qpos < p.Sq) {
    T* dqb = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh +
             (int64_t)qpos * p.dq_ss;
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      dqb[c + LN * i] = from_f32<T>(dq[i] * p.scale);
  }
}

template <int D> constexpr size_t stats_smem() {
  return sizeof(float) * 3 * BT * (D + 1);
}
template <int D> constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * BT * (D + 1) + 2 * BT * LDP + 2 * BT + D) +
         sizeof(int) * NT;
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * BT * (D + 1) + BT * LDP);
}

// above 48 KB only as opted-in dynamic shared memory (D 256's dK/dV pass:
// 141 KB of the 227 KB a CTA may have); set once per instantiation
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr[3] = {
      opt_in(flash_bwd_stats<T, D>, stats_smem<D>()),
      opt_in(flash_bwd_dkdv<T, D>, dkdv_smem<D>()),
      opt_in(flash_bwd_dq<T, D>, dq_smem<D>())};
  for (cudaError_t e : attr)
    if (e != cudaSuccess) return e;
  const int qt = (p.Sq + BT - 1) / BT, kt = (p.Sk + BT - 1) / BT;
  flash_bwd_stats<T, D><<<dim3(qt, p.B * p.H), NT, stats_smem<D>(),
                          stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<T, D><<<dim3(kt, p.B * p.Kh), NT, dkdv_smem<D>(),
                         stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, D><<<dim3(qt, p.B * p.H), NT, dq_smem<D>(), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(p, stream);
    case 96: return launch<T, 96>(p, stream);
    case 120: return launch<T, 120>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Kernels a call launches, one after the other on the stream.
int flash_attention_bwd_passes() { return 3; }

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (b, h, s) for
// q, k, v, dout, dq, dk, dv in that order; the last dimension of every
// tensor is contiguous. lse and di are fp32 scratch of B * H * Sq floats.
// Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, void* dq, void* dk,
                        void* dv, float* lse, float* di, int dtype, int B,
                        int H, int Kh, int Sq, int Sk, int D,
                        const int64_t* strides, int causal, int window,
                        int chunk, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 || Sq <= 0 || Sk <= 0 ||
      B * H > 65535)
    return cudaErrorInvalidValue;
  const int64_t* s = strides;
  const Params p{q, k, v, dout, dq, dk, dv, lse, di, B, H, Kh, Sq, Sk,
                 s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                 s[9], s[10], s[11], s[12], s[13], s[14], s[15], s[16],
                 s[17], s[18], s[19], s[20],
                 causal, window, chunk, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch_d<float>(p, D, st);
  else if (dtype == 1) err = launch_d<__nv_bfloat16>(p, D, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
