// Backward of the prefill flash attention for Hopper (sm_90a), CUDA C++
// with a plain C entry point loaded through ctypes
// (repro_torch/kernels/_build.py).
//
// The JAX package differentiates its jnp attention with XLA (jax.grad of
// src/repro/models/attention.py::attend, line 80); the Pallas kernel
// flash_attention_kernel has no backward. This source is the backward of
// the port's forward kernel (csrc/flash_attention.cu) and computes the
// gradients that autograd gives of flash_attention_ref
// (kernels/flash_attention/ref.py):
//   q [B,H,Sq,D], k/v [B,Kh,Sk,D] and dO [B,H,Sq,D] -> dq, dk, dv of q's,
//   k's and v's shapes, fp32 or bf16 in and out, every sum in fp32. Masks
//   (causal, window, chunk; positions are the indices 0..Sq-1 and
//   0..Sk-1), GQA (query head h reads kv head h / (H / Kh); dk and dv sum
//   over the group's heads) and the scale are the forward's. A row with
//   every key masked got mean(v) forward (the oracle's uniform softmax
//   over a row of equal -1e30 logits): its dO reaches dv as dO / Sk at
//   every key, and dq and dk get nothing from it, as autograd of the
//   oracle gives (its mask is a where, whose gradient is zero at a masked
//   logit). Every tensor is given by strides with a contiguous last dim,
//   so the transposed [B,S,H,D] views that attend passes need no copy, and
//   the gradients are written straight into that layout.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): the function is five
// S x D products per (b, h) over the allowed (q, k) pairs (Q K^T,
// dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K), 10 flops per pair and
// column; at qwen3-4b's train shape (B2 H32 Kh8 S2048 D128, causal) 172
// GFLOP, 0.174 ms, against 42 MB of inputs and outputs (13 us). So
// operations bound it, and the products belong on the tensor cores.
//
// bf16 design (the train path's type): wgmma tiles fed by TMA rings,
// deterministic (no atomics on sums), two kernels a call.
// 1. dQ and the statistics, flash_bwd_dq_tc: a consumer warpgroup owns 64
//    query rows of one (b, h); two share a CTA and its K/V ring when
//    128-row CTAs still cover the card (bwd_plan in
//    kernels/flash_attention/kernel.py). The ring walks the CTA's key
//    tiles twice. Walk 1 computes S = Q K^T and dP = dO V^T (wgmma,
//    K-major descriptors) and keeps, per row, the running max m, the sum
//    l of e^(s-m) and the sum of e^(s-m) dP rescaled with them: then
//    lse = m + log2 l and Di = sum_k P_k dP_k = dO . (sum_k P_k v_k), the
//    fp32 o's dot product with dO to fp32 rounding, with no P V product
//    and nothing saved by the forward. (Di from the forward's bf16 output
//    missed the bf16 tolerance: dS sums to zero over a row, so a cancelling
//    dq row keeps o's 2^-9 error whole.) lse (in log2 units of the scaled
//    scores) and Di go to fp32 scratch. Walk 2 recomputes S and dP,
//    forms P = exp2(s - lse) and dS = P (dP - Di) in registers, splits dS
//    into bf16 hi and lo halves as wgmma's register A operand (the
//    accumulator's layout is the A fragment's, as the forward's P V) and
//    adds dS_hi K + dS_lo K, K read through an MN-major descriptor. Folding the statistics into this kernel saves a
//    launch and a second load of Q and dO; it also zeroes the arrival
//    counters of the next kernel.
// 2. dK and dV, flash_bwd_dkdv_tc, 256 threads: for D <= 128 each of two
//    warpgroups owns 64 keys of one (b, kv head) and they share a Q/dO
//    ring; it computes S^T = K Q^T and dP^T = V dO^T (the accumulator's
//    row is the key), P^T = exp2(s - lse) and dS^T = P^T (dP^T - Di) in
//    registers, and adds P^T dO into dV and dS^T Q into dK with P^T and
//    dS^T split into bf16 hi and lo halves as the register A operand, Q and
//    dO read through MN-major descriptors (no transposed copy). D 256 does not fit so: dK and dV of
//    64 keys x 256 columns are 2 x 128 fp32 registers a thread beside
//    S^T and dP^T. So its two warpgroups share one 64-key tile and split
//    D: warpgroup 0 computes S^T and P^T, warpgroup 1 dP^T; P^T goes to
//    warpgroup 1 in fp32 and dS^T comes back split through 16 KB of
//    shared memory (each thread reads only the slots its twin wrote), and
//    each warpgroup accumulates dK and dV of its 128 columns.
//    A CTA walks its group's query heads and, for each, the q tiles the
//    mask leaves; Q, dO and the tiles' lse and Di come through a 2-stage
//    ring. Where B * Kh * key tiles would leave SMs idle (MQA: the hybrid's
//    B2 Kh1 S2100 is 66 CTAs), the group's heads are split across CTAs
//    (bwd_plan's head_split, until two waves' worth); each CTA writes its
//    fp32 partial dK and dV to scratch, counts its arrival, and the last CTA
//    of a key tile sums the partials in split order (the counter only
//    decides who sums; the sum's order is fixed), so the gradients are
//    bit-identical from call to call. Rows with every key masked
//    (lse = -inf) are found by a barrier vote over lse, and their dO / Sk
//    is added to every key's dV.
// Loads: TMA from 4-D tensor maps (D, S, heads, B) over the strided views,
// encoded on the host per launch, in boxes of 64 columns x 64 rows with the
// 128-byte swizzle wgmma reads; D 96 and 120 are two boxes whose columns
// past D TMA zero-fills (they add nothing to the products, and the stores
// clip them). The tiles a CTA holds load once; the walked tiles go through
// a 2-stage ring with a full and an empty mbarrier per stage, started by
// thread 0; tiles the causal, window or chunk mask removes for the whole
// CTA are never loaded, and a warpgroup skips the math of a tile masked for
// all its rows or keys. An mbarrier wait past 1 s traps (a broken ring is
// an error, not a hang). Outputs go through shared memory and TMA stores,
// which clip at S and D.
// Precision: P and dS rounded once to bf16 for wgmma left the gradients
// 0.043-0.047 of their size off at the train shapes (each element against
// |plain| + the gradient's rms; the bound is 2e-2): where P is near 1
// (early causal rows and keys) its 2^-9 rounding is a large part of a
// small, cancelling gradient. So every A operand built in registers is
// split, x = hi + lo in bf16 (about 2^-16 of x), and its product is two
// wgmmas: 12 S x D products per allowed pair instead of 9 (walk 1: 2;
// walk 2: 2 + 2; dK/dV: 2 + 2 + 2), and no P V product for Di.
// Left for later: warp specialisation with setmaxnreg, overlapping one
// tile's softmax with the next tile's products, persistent scheduling.
//
// fp32 instances (on no path: the models run bf16 on the card) keep the
// CUDA-core design, as the forward's do (TF32 would not hold their
// tolerance): three kernels of 256 threads over 32-row tiles held in fp32
// in shared memory (rows padded to D + 1 floats), every sum taken by one
// thread in a fixed order. 1. lse and Di: a forward recompute in fp32 (an
// online softmax and o), then Di = dO . o. 2. dK and dV: one CTA per
// (b, kv head, 32 keys) walks the group's heads and their query tiles,
// recomputes P and dS = P (dP - Di) into shared memory and adds P^T dO and
// dS^T Q in registers; all-masked rows as above. 3. dQ: one CTA per (b, h,
// 32 query rows) adds dS K.

#include <cuda.h>            // CUtensorMap and its enums only: no -lcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ----------------------------------------------------- fp32: CUDA cores

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
  float* lse;                 // row (b * H + h) * st + s
  float* di;                  // the same rows
  int64_t st;                 // row stride of lse and di per (b, h)
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
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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
template <typename P>
__device__ __forceinline__ bool tile_masked(const P& p, int q0, int q1,
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
    const int64_t row = (int64_t)bh * p.st + qpos;
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
    const float* lse = p.lse + bh * p.st;
    const float* dia = p.di + bh * p.st;

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
  const int64_t row = (int64_t)bh * p.st + qpos;
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

cudaError_t launch_f32(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<float, 64>(p, stream);
    case 96: return launch<float, 96>(p, stream);
    case 120: return launch<float, 120>(p, stream);
    case 128: return launch<float, 128>(p, stream);
    case 256: return launch<float, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------- bf16: wgmma + TMA rings
namespace tc {

constexpr int BM = 64;                // rows of every tile: wgmma's M
constexpr int CB = 64;                // columns per box: 128 bytes of bf16
constexpr int STAGES = 2;             // ring depth
constexpr uint32_t BOX = BM * 128;    // one box: 64 rows x 128 bytes
constexpr uint32_t STAT_BYTES = 2 * BM * 4;   // a q tile's lse and Di

template <int D>
__host__ __device__ constexpr int boxes() { return (D + CB - 1) / CB; }

struct TcParams {
  int B, H, Kh, Sq, Sk;
  int Sq_pad;                 // Sq rounded up to 64: the stats' row length
  int causal, window, chunk;  // window / chunk < 0: no such mask
  float scale;
  float* stats;               // [B * H][2][Sq_pad]: lse (log2 units of the
                              // scaled scores), then Di
  float* partial;             // head_split > 1: [head_split][groups][...]
  int* counters;              // head_split > 1: [groups] arrivals
  int groups;                 // B * Kh * key tiles: dK/dV CTAs a split
  int head_split;             // CTAs sharing a key tile's query heads
  const __nv_bfloat16* dout;  // for the all-masked rows' sum
  int64_t do_sb, do_sh, do_ss;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint32_t globaltimer_lo() {   // ns, wraps at 4.3 s
  uint32_t t;
  asm volatile("mov.u32 %0, %%globaltimer_lo;" : "=r"(t));
  return t;
}

// A wait that lasts this long has no copy or arrival left to end it.
constexpr uint32_t kWaitLimitNs = 1000000000u;   // 1 s

// Spin until the phase of ``bar`` with this parity has completed; a wait
// past kWaitLimitNs traps instead of hanging the card (a sticky error: the
// process's CUDA context is broken and the process has to be restarted).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint32_t t0 = globaltimer_lo();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer_lo() - t0 > kWaitLimitNs) __trap();
}

// one box (64 columns x 64 rows at column c0, row c1, head c2, batch c3)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// ``bytes`` (a multiple of 16) of contiguous global memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand in shared memory: groups
// of 8 rows (or of 8 k values, MN-major) lie 1024 bytes apart. The other
// offset is not read here (a K-major swizzled operand, or an MN-major one
// that is a single 64-wide swizzle atom across N) and is set alike.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(1024 >> 4) << 16)
       | (static_cast<uint64_t>(1024 >> 4) << 32)
       | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accesses to the accumulator across a
// wgmma or its wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// the 32 fp32 accumulator registers of one m64n64 wgmma
#define ACC32(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
    "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31])
#define ACC32_LIST \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, " \
  "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B: A 64x16 and B 16x64 from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      ACC32_LIST ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B: A 64x16 bf16 in registers (the accumulator's layout), B 16x64
// from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      ACC32_LIST ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 as a bf16 pair ``hi`` and the bf16 pair ``lo`` of what hi leaves
// over: hi + lo holds x to about 2^-16 of its size, so a product whose A
// operand is split so (two wgmmas) carries what one bf16 operand would
// leave 2^-9 off per element
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - f.x, x1 - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// base-2 exponent on the special function unit (-inf gives +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d = A B^T over the head dim: A and B 64-row tiles of NB boxes in shared
// memory (K-major; the product's rows are A's, its columns B's)
template <int NB>
__device__ __forceinline__ void issue_abt(float (&d)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int kk = 0; kk < CB / 16; ++kk)
      wgmma_ss(d, desc(a + c * BOX + 32 * kk), desc(b + c * BOX + 32 * kk),
               c | kk);
}

template <int NB>
__device__ __forceinline__ void abt(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  pin(d);
  wg_fence();
  issue_abt<NB>(d, a, b);
  wg_commit();
  wg_wait_all();
  pin(d);
}

// d1 = A1 B1^T and d2 = A2 B2^T, one wait for both
template <int NB>
__device__ __forceinline__ void abt2(float (&d1)[32], uint32_t a1,
                                     uint32_t b1, float (&d2)[32],
                                     uint32_t a2, uint32_t b2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d1[i] = d2[i] = 0.f;
  pin(d1);
  pin(d2);
  wg_fence();
  issue_abt<NB>(d1, a1, b1);
  issue_abt<NB>(d2, a2, b2);
  wg_commit();
  wg_wait_all();
  pin(d1);
  pin(d2);
}

// The mask as intervals. Keys a query row may see: [row_lo, row_hi];
// query rows a key may be seen by: [key_lo, key_hi] (both empty past Sq
// or Sk). Each bound is non-decreasing in its position.
__device__ __forceinline__ int row_lo(const TcParams& p, int q) {
  int lo = 0;
  if (p.window >= 0) lo = max(lo, q - p.window + 1);
  if (p.chunk > 0) lo = max(lo, q / p.chunk * p.chunk);
  return lo;
}
__device__ __forceinline__ int row_hi(const TcParams& p, int q) {
  if (q >= p.Sq) return -1;
  int hi = p.Sk - 1;
  if (p.causal) hi = min(hi, q);
  if (p.chunk > 0) hi = min(hi, q / p.chunk * p.chunk + p.chunk - 1);
  return hi;
}
__device__ __forceinline__ int key_lo(const TcParams& p, int k) {
  int lo = p.causal ? k : 0;
  if (p.chunk > 0) lo = max(lo, k / p.chunk * p.chunk);
  return lo;
}
__device__ __forceinline__ int key_hi(const TcParams& p, int k) {
  if (k >= p.Sk) return -1;
  int hi = p.Sq - 1;
  if (p.window >= 0) hi = min(hi, k + p.window - 1);
  if (p.chunk > 0) hi = min(hi, k / p.chunk * p.chunk + p.chunk - 1);
  return hi;
}

// o (64 rows x 64 columns of one box, the accumulator's layout) in bf16
// into a 128-byte-swizzled box at ``blk``, as the tensor maps expect
__device__ __forceinline__ void stage_box(uint8_t* blk, const float (&o)[32],
                                          int r0, int cl, float s) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const uint32_t col = ((jj ^ (r0 & 7)) << 4) + 2 * cl;   // bytes
    *reinterpret_cast<uint32_t*>(blk + r0 * 128 + col) =
        pack_bf16(o[4 * jj] * s, o[4 * jj + 1] * s);
    *reinterpret_cast<uint32_t*>(blk + (r0 + 8) * 128 + col) =
        pack_bf16(o[4 * jj + 2] * s, o[4 * jj + 3] * s);
  }
}

// Thread layout inside a warpgroup (wgmma's accumulator): warp w holds rows
// 16w .. 16w+15; lane l holds rows r = 16w + l/4 and r + 8, and in each
// 8-column group j the columns 8j + 2(l%4) and +1: d[4j], d[4j+1] are
// (r, 8j+2(l%4) + 0/1), d[4j+2], d[4j+3] the same columns of row r + 8.

// ----------------------------------------------- kernel 1: lse, Di and dQ
template <int D, int WG>
__global__ void __launch_bounds__(128 * WG, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tdq,
                const TcParams p) {
  constexpr int NB = boxes<D>();
  constexpr uint32_t TILE = NB * BOX;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;                      // [WG] Q tiles
  const uint32_t sG = sQ + WG * TILE;            // [WG] dO tiles
  const uint32_t sK = sG + WG * TILE;            // [STAGES] K ring
  const uint32_t sV = sK + STAGES * TILE;        // [STAGES] V ring
  const uint32_t qbar = sV + STAGES * TILE;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int BH = p.B * p.H;
  const int ntiles = (p.Sq + BM * WG - 1) / (BM * WG);
  const int bh = blockIdx.x % BH;
  const int q0 = (ntiles - 1 - blockIdx.x / BH) * (BM * WG);  // longest first
  const int b = bh / p.H, h = bh - b * p.H;
  const int kh = h / (p.H / p.Kh);
  const int q1 = min(q0 + BM * WG, p.Sq) - 1;
  const int wq0 = q0 + wg * BM;                  // this warpgroup's rows
  const int wq1 = min(wq0 + BM, p.Sq) - 1;
  const bool has_rows = wq0 < p.Sq;              // uniform per warpgroup

  // the dK/dV kernel, next on the stream, counts its arrivals from zero
  const int ncount = p.head_split > 1 ? p.groups : 0;
  for (int i = blockIdx.x * blockDim.x + tid; i < ncount;
       i += gridDim.x * blockDim.x)
    p.counters[i] = 0;

  // the key tiles some row of the CTA may see, fully masked ones skipped;
  // the ring walks them twice (walk 1: lse and Di; walk 2: dQ)
  const int klo = row_lo(p, q0), khi = row_hi(p, q1);
  const int t_last = klo <= khi ? khi / BM : -1;
  auto skip = [&](int t) {
    while (t <= t_last &&
           tile_masked(p, q0, q1, t * BM, min(t * BM + BM, p.Sk) - 1))
      ++t;
    return t;
  };
  const int t_first = skip(klo / BM);
  int n = 0;
  for (int t = t_first; t <= t_last; t = skip(t + 1)) ++n;
  auto next = [&](int t) {
    t = skip(t + 1);
    return t <= t_last ? t : t_first;
  };
  const int total = 2 * n;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * WG);         // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int t, int s) {             // key tile t -> stage s
    const uint32_t bar = full0 + 8 * s;
    mbar_expect_tx(bar, 2 * TILE);               // zero fill counts too
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load(sK + s * TILE + c * BOX, &tk, bar, c * CB, t * BM, kh, b);
      tma_load(sV + s * TILE + c * BOX, &tv, bar, c * CB, t * BM, kh, b);
    }
  };
  int pt = t_first;                              // thread 0's next load
  if (tid == 0) {
    int nq = 0;
    for (int w = 0; w < WG; ++w) nq += (q0 + w * BM < p.Sq);
    mbar_expect_tx(qbar, nq * 2 * TILE);
    for (int w = 0; w < WG; ++w) {
      if (q0 + w * BM >= p.Sq) continue;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load(sQ + w * TILE + c * BOX, &tq, qbar, c * CB, q0 + w * BM, h,
                 b);
        tma_load(sG + w * TILE + c * BOX, &tdo, qbar, c * CB, q0 + w * BM,
                 h, b);
      }
    }
    for (int j = 0; j < min(total, STAGES); ++j) {
      load_kv(pt, j);
      pt = next(pt);
    }
  }
  auto acquire = [&](int j) {
    __syncwarp();
    mbar_wait(full0 + 8 * (j % STAGES), (j / STAGES) & 1);
  };
  // this warp is done with the stage; thread 0 refills it once all are
  auto release = [&](int j) {
    const int s = j % STAGES;
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (tid == 0 && j + STAGES < total) {
      mbar_wait(empty0 + 8 * s, (j / STAGES) & 1);
      load_kv(pt, s);
      pt = next(pt);
    }
  };

  const int r0 = warp * 16 + lane / 4;          // rows r0 and r0 + 8
  const int qp0 = wq0 + r0, qp1 = qp0 + 8;
  const int lo0 = row_lo(p, qp0), hi0 = row_hi(p, qp0);
  const int lo1 = row_lo(p, qp1), hi1 = row_hi(p, qp1);
  const int cl = 2 * (lane % 4);                 // first column in a group
  const float sl = p.scale * 1.4426950408889634f;  // scale * log2(e)
  const uint32_t qtile = sQ + wg * TILE, gtile = sG + wg * TILE;
  // every pair of the warpgroup's rows and the 64 keys from k0 allowed
  auto unmasked = [&](int k0) {
    return k0 + BM <= p.Sk && wq0 + BM <= p.Sq &&
           row_lo(p, wq0 + BM - 1) <= k0 && row_hi(p, wq0) >= k0 + BM - 1;
  };
  mbar_wait(qbar, 0);

  // walk 1: per row the running max m (log2 units), l = sum e^(s-m) and
  // a = sum e^(s-m) dP, this lane's share of l and a
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f, a0 = 0.f, a1 = 0.f;
  int ct = t_first;
  for (int j = 0; j < n; ++j, ct = next(ct)) {
    const int k0 = ct * BM, k1 = min(k0 + BM, p.Sk) - 1;
    acquire(j);
    if (has_rows && !tile_masked(p, wq0, wq1, k0, k1)) {
      const int s = j % STAGES;
      float sc[32], dp[32];
      abt2<NB>(sc, qtile, sK + s * TILE, dp, gtile, sV + s * TILE);
      const bool all = unmasked(k0);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * jj + cl + e;
          float x0 = sc[4 * jj + e] * sl, x1 = sc[4 * jj + 2 + e] * sl;
          if (!all) {
            if (kp < lo0 || kp > hi0) x0 = -INFINITY;
            if (kp < lo1 || kp > hi1) x1 = -INFINITY;
          }
          sc[4 * jj + e] = x0;
          sc[4 * jj + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // nothing unmasked yet: keep the (zero) state as it is
      const float base0 = mn0 == -INFINITY ? 0.f : mn0;
      const float base1 = mn1 == -INFINITY ? 0.f : mn1;
      const float al0 = exp2_approx(m0 - base0), al1 = exp2_approx(m1 - base1);
      float ls0 = 0.f, ls1 = 0.f, as0 = 0.f, as1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = exp2_approx(sc[4 * jj + e] - base0);
          const float p1 = exp2_approx(sc[4 * jj + 2 + e] - base1);
          ls0 += p0;
          ls1 += p1;
          as0 += p0 * dp[4 * jj + e];
          as1 += p1 * dp[4 * jj + 2 + e];
        }
      l0 = l0 * al0 + ls0;
      l1 = l1 * al1 + ls1;
      a0 = a0 * al0 + as0;
      a1 = a1 * al1 + as1;
      m0 = mn0;
      m1 = mn1;
    }
    release(j);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    a0 += __shfl_xor_sync(0xffffffffu, a0, off);
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
  }
  // a row with no allowed key: lse = -inf (it marks the row for the dK/dV
  // kernel), Di = 0
  const float lse0 = l0 > 0.f ? m0 + log2f(l0) : -INFINITY;
  const float lse1 = l1 > 0.f ? m1 + log2f(l1) : -INFINITY;
  const float di0 = l0 > 0.f ? a0 / l0 : 0.f;
  const float di1 = l1 > 0.f ? a1 / l1 : 0.f;
  if (has_rows && lane % 4 == 0) {
    float* st = p.stats + static_cast<int64_t>(bh) * 2 * p.Sq_pad;
    if (qp0 < p.Sq_pad) {
      st[qp0] = lse0;
      st[p.Sq_pad + qp0] = di0;
    }
    if (qp1 < p.Sq_pad) {
      st[qp1] = lse1;
      st[p.Sq_pad + qp1] = di1;
    }
  }

  // walk 2: dQ += dS K, dS = P (dP - Di) split into bf16 hi and lo as
  // the A operand
  float dq[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;
  for (int j = n; j < total; ++j, ct = next(ct)) {
    const int k0 = ct * BM, k1 = min(k0 + BM, p.Sk) - 1;
    acquire(j);
    if (has_rows && !tile_masked(p, wq0, wq1, k0, k1)) {
      const int s = j % STAGES;
      const uint32_t ktile = sK + s * TILE;
      float sc[32], dp[32];
      abt2<NB>(sc, qtile, ktile, dp, gtile, sV + s * TILE);
      const bool all = unmasked(k0);
      uint32_t dh[16], dl[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * jj + cl + e;
          float x0 = fmaf(sc[4 * jj + e], sl, -lse0);
          float x1 = fmaf(sc[4 * jj + 2 + e], sl, -lse1);
          if (!all) {
            if (kp < lo0 || kp > hi0) x0 = -INFINITY;
            if (kp < lo1 || kp > hi1) x1 = -INFINITY;
          }
          ds[e] = exp2_approx(x0) * (dp[4 * jj + e] - di0);
          ds[2 + e] = exp2_approx(x1) * (dp[4 * jj + 2 + e] - di1);
        }
        split_bf16(ds[0], ds[1], dh[2 * jj], dl[2 * jj]);
        split_bf16(ds[2], ds[3], dh[2 * jj + 1], dl[2 * jj + 1]);
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) pin(dq[c]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          const uint64_t kd = desc(ktile + c * BOX + 16 * 128 * kk);
          wgmma_rs(dq[c], &dh[4 * kk], kd);
          wgmma_rs(dq[c], &dl[4 * kk], kd);
        }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < NB; ++c) pin(dq[c]);
    }
    release(j);
  }
  if (!has_rows) return;

  // dQ * scale in bf16 into this warpgroup's Q tile (the last wgmma that
  // read it has completed), then one TMA store per box, clipped at Sq, D
  uint8_t* const otile = gbase + (qtile - base);
#pragma unroll
  for (int c = 0; c < NB; ++c)
    stage_box(otile + c * BOX, dq[c], r0, cl, p.scale);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(wg + 1, 128);
  if (tid % 128 == 0) {
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_store(&tdq, qtile + c * BOX, c * CB, wq0, h, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// ------------------------------------------------------ kernel 2: dK, dV
template <int D>
struct Dkdv {
  static constexpr int NB = boxes<D>();
  static constexpr bool SPLIT = D > 128;   // two warpgroups split D
  static constexpr int KT = SPLIT ? 1 : 2; // 64-key tiles a CTA holds
  static constexpr int NBO = SPLIT ? NB / 2 : NB;   // boxes a WG owns
  static constexpr uint32_t TILE = NB * BOX;
  static constexpr uint32_t XBYTES = SPLIT ? 128 * 32 * 4 : 0;
  static constexpr size_t smem() {
    // 1 KB of slack for the 1024-byte alignment; K, V; the Q and dO rings;
    // their lse and Di; the exchange; dO of the all-masked rows; the
    // split's flag; kvbar, full[STAGES], empty[STAGES]
    return 1024 + static_cast<size_t>(2 * KT + 2 * STAGES) * TILE +
           STAGES * STAT_BYTES + XBYTES + NB * CB * 4 + 16 +
           8 * (1 + 2 * STAGES);
  }
};

template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tdk,
                  const __grid_constant__ CUtensorMap tdv,
                  const TcParams p) {
  using L = Dkdv<D>;
  constexpr int NB = L::NB, KT = L::KT, NBO = L::NBO;
  constexpr bool SPLIT = L::SPLIT;
  constexpr uint32_t TILE = L::TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sK = base;                      // [KT] K tiles
  const uint32_t sV = sK + KT * TILE;            // [KT] V tiles
  const uint32_t sQ = sV + KT * TILE;            // [STAGES] Q ring
  const uint32_t sG = sQ + STAGES * TILE;        // [STAGES] dO ring
  const uint32_t sS = sG + STAGES * TILE;        // [STAGES] lse, Di
  const uint32_t sX = sS + STAGES * STAT_BYTES;  // exchange (SPLIT)
  const uint32_t sE = sX + L::XBYTES;            // [NB * CB] fp32
  const uint32_t sF = sE + NB * CB * 4;          // int flag
  const uint32_t kvbar = sF + 16;
  const uint32_t full0 = kvbar + 8, empty0 = full0 + 8 * STAGES;
  float* const gE = reinterpret_cast<float*>(gbase + (sE - base));
  int* const gF = reinterpret_cast<int*>(gbase + (sF - base));

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int wt = tid % 128;
  const int NS = p.head_split;
  const int per_tile = p.B * p.Kh * NS;
  const int kt = blockIdx.x / per_tile;          // longest first
  const int rest = blockIdx.x - kt * per_tile;
  const int bkh = rest / NS, split = rest - bkh * NS;
  const int b = bkh / p.Kh, kh = bkh - b * p.Kh;
  const int GS = p.H / p.Kh / NS;                // query heads of this CTA
  const int hb = kh * (p.H / p.Kh) + split * GS;
  const int k0 = kt * KT * BM, k1 = min(k0 + KT * BM, p.Sk) - 1;
  const int wk0 = SPLIT ? k0 : k0 + wg * BM;     // this warpgroup's keys
  const int wk1 = min(wk0 + BM, p.Sk) - 1;
  const bool has_keys = wk0 < p.Sk;              // uniform per warpgroup
  const int cb = SPLIT ? wg * NBO : 0;           // first box it owns

  // the q tiles some key of the CTA may be seen by, fully masked ones
  // skipped; the ring walks them for each of the CTA's heads
  const int qlo = key_lo(p, k0), qhi = key_hi(p, k1);
  const int t_last = qlo <= qhi ? qhi / BM : -1;
  auto skip = [&](int t) {
    while (t <= t_last &&
           tile_masked(p, t * BM, min(t * BM + BM, p.Sq) - 1, k0, k1))
      ++t;
    return t;
  };
  const int t_first = skip(qlo / BM);
  int n = 0;
  for (int t = t_first; t <= t_last; t = skip(t + 1)) ++n;
  const int total = n * GS;
  auto next = [&](int& g, int& t) {
    t = skip(t + 1);
    if (t > t_last) {
      t = t_first;
      ++g;
    }
  };

  for (int d = tid; d < NB * CB; d += 256) gE[d] = 0.f;
  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);              // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto load_q = [&](int g, int t, int s) {       // head hb + g, tile t
    const uint32_t bar = full0 + 8 * s;
    const int h = hb + g;
    mbar_expect_tx(bar, 2 * TILE + STAT_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load(sQ + s * TILE + c * BOX, &tq, bar, c * CB, t * BM, h, b);
      tma_load(sG + s * TILE + c * BOX, &tdo, bar, c * CB, t * BM, h, b);
    }
    const float* st = p.stats +
        static_cast<int64_t>(b * p.H + h) * 2 * p.Sq_pad + t * BM;
    bulk_load(sS + s * STAT_BYTES, st, BM * 4, bar);
    bulk_load(sS + s * STAT_BYTES + BM * 4, st + p.Sq_pad, BM * 4, bar);
  };
  int pg = 0, pt = t_first;                      // thread 0's next load
  if (tid == 0) {
    int nk = 0;
    for (int w = 0; w < KT; ++w) nk += (k0 + w * BM < p.Sk);
    mbar_expect_tx(kvbar, nk * 2 * TILE);
    for (int w = 0; w < KT; ++w) {
      if (k0 + w * BM >= p.Sk) continue;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load(sK + w * TILE + c * BOX, &tk, kvbar, c * CB, k0 + w * BM,
                 kh, b);
        tma_load(sV + w * TILE + c * BOX, &tv, kvbar, c * CB, k0 + w * BM,
                 kh, b);
      }
    }
    for (int j = 0; j < min(total, STAGES); ++j) {
      load_q(pg, pt, j);
      next(pg, pt);
    }
  }

  const int r0 = warp * 16 + lane / 4;          // keys r0 and r0 + 8
  const int kp0 = wk0 + r0, kp1 = kp0 + 8;
  const int lo0 = key_lo(p, kp0), hi0 = key_hi(p, kp0);
  const int lo1 = key_lo(p, kp1), hi1 = key_hi(p, kp1);
  const int cl = 2 * (lane % 4);                 // first column in a group
  const float sl = p.scale * 1.4426950408889634f;  // scale * log2(e)
  const uint32_t ktile = sK + (SPLIT ? 0 : wg) * TILE;
  const uint32_t vtile = sV + (SPLIT ? 0 : wg) * TILE;
  float* const xs = reinterpret_cast<float*>(gbase + (sX - base));

  float dk[NBO][32], dv[NBO][32];
#pragma unroll
  for (int c = 0; c < NBO; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;

  // P^T = exp2(s - lse) of the accumulator st (keys x q rows from q0),
  // zero where masked, in place
  auto probs = [&](float (&st)[32], const float* lse, int q0) {
    const bool all = wk0 + BM <= p.Sk && q0 + BM <= p.Sq &&
                     key_lo(p, wk0 + BM - 1) <= q0 &&
                     key_hi(p, wk0) >= q0 + BM - 1;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * jj + cl + e, qp = q0 + qc;
        float x0 = fmaf(st[4 * jj + e], sl, -lse[qc]);
        float x1 = fmaf(st[4 * jj + 2 + e], sl, -lse[qc]);
        if (!all) {
          if (qp < lo0 || qp > hi0) x0 = -INFINITY;
          if (qp < lo1 || qp > hi1) x1 = -INFINITY;
        }
        st[4 * jj + e] = exp2_approx(x0);
        st[4 * jj + 2 + e] = exp2_approx(x1);
      }
  };
  // P^T split into bf16 hi and lo, wgmma's A operand
  auto split_p = [&](const float (&pr)[32], uint32_t (&ph)[16],
                     uint32_t (&pl)[16]) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      split_bf16(pr[4 * jj], pr[4 * jj + 1], ph[2 * jj], pl[2 * jj]);
      split_bf16(pr[4 * jj + 2], pr[4 * jj + 3], ph[2 * jj + 1],
                 pl[2 * jj + 1]);
    }
  };
  // dS^T = P^T (dP^T - Di) into dpt, in place, then split as P^T
  auto grads = [&](const float (&pr)[32], float (&dpt)[32], const float* di,
                   uint32_t (&dh)[16], uint32_t (&dl)[16]) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dq = di[8 * jj + cl + e];
        dpt[4 * jj + e] = pr[4 * jj + e] * (dpt[4 * jj + e] - dq);
        dpt[4 * jj + 2 + e] = pr[4 * jj + 2 + e] * (dpt[4 * jj + 2 + e] - dq);
      }
    split_p(dpt, dh, dl);
  };

  mbar_wait(kvbar, 0);
  int cg = 0, ct = t_first;
  for (int j = 0; j < total; ++j, next(cg, ct)) {
    const int s = j % STAGES;
    const int q0 = ct * BM;
    __syncwarp();
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    if (has_keys &&
        !tile_masked(p, q0, min(q0 + BM, p.Sq) - 1, wk0, wk1)) {
      const uint32_t qt = sQ + s * TILE, gt = sG + s * TILE;
      const float* lse =
          reinterpret_cast<const float*>(gbase + (sS + s * STAT_BYTES - base));
      const float* di = lse + BM;
      uint32_t ph[16], pl[16], dh[16], dl[16];
      if (!SPLIT) {
        float st[32], dpt[32];
        abt2<NB>(st, ktile, qt, dpt, vtile, gt);
        probs(st, lse, q0);
        // dS first: P^T's halves never live beside P^T and dP^T in fp32
        // (the other order spills 8 bytes at D 96-128; 255 registers)
        grads(st, dpt, di, dh, dl);
        split_p(st, ph, pl);
      } else {
        // warpgroup 0: S^T and P^T; warpgroup 1: dP^T and dS^T; P^T goes
        // over in fp32, dS^T comes back split, each thread to its twin
        float acc[32];
        float4* const x4 = reinterpret_cast<float4*>(xs);
        if (wg == 0) {
          abt<NB>(acc, ktile, qt);
          probs(acc, lse, q0);
#pragma unroll
          for (int v = 0; v < 8; ++v)
            x4[v * 128 + wt] = make_float4(acc[4 * v], acc[4 * v + 1],
                                           acc[4 * v + 2], acc[4 * v + 3]);
          split_p(acc, ph, pl);
        } else {
          abt<NB>(acc, vtile, gt);
        }
        named_sync(1, 256);
        if (wg == 1) {
          float pr[32];
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            const float4 x = x4[v * 128 + wt];
            pr[4 * v] = x.x;
            pr[4 * v + 1] = x.y;
            pr[4 * v + 2] = x.z;
            pr[4 * v + 3] = x.w;
          }
          // P^T's halves first here (the other order spills 60 bytes)
          split_p(pr, ph, pl);
          grads(pr, acc, di, dh, dl);
          uint4* const u4 = reinterpret_cast<uint4*>(xs);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            u4[v * 128 + wt] = make_uint4(dh[4 * v], dh[4 * v + 1],
                                          dh[4 * v + 2], dh[4 * v + 3]);
            u4[(4 + v) * 128 + wt] = make_uint4(dl[4 * v], dl[4 * v + 1],
                                                dl[4 * v + 2], dl[4 * v + 3]);
          }
        }
        named_sync(1, 256);
        if (wg == 0) {
          const uint4* const u4 = reinterpret_cast<const uint4*>(xs);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const uint4 x = u4[v * 128 + wt], y = u4[(4 + v) * 128 + wt];
            dh[4 * v] = x.x;
            dh[4 * v + 1] = x.y;
            dh[4 * v + 2] = x.z;
            dh[4 * v + 3] = x.w;
            dl[4 * v] = y.x;
            dl[4 * v + 1] = y.y;
            dl[4 * v + 2] = y.z;
            dl[4 * v + 3] = y.w;
          }
        }
      }
      // dV += P^T dO, dK += dS^T Q over the boxes this warpgroup owns,
      // the hi and the lo half of each A operand
#pragma unroll
      for (int c = 0; c < NBO; ++c) {
        pin(dv[c]);
        pin(dk[c]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NBO; ++c) {
          const uint64_t gd = desc(gt + (cb + c) * BOX + 16 * 128 * kk);
          const uint64_t qd = desc(qt + (cb + c) * BOX + 16 * 128 * kk);
          wgmma_rs(dv[c], &ph[4 * kk], gd);
          wgmma_rs(dv[c], &pl[4 * kk], gd);
          wgmma_rs(dk[c], &dh[4 * kk], qd);
          wgmma_rs(dk[c], &dl[4 * kk], qd);
        }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < NBO; ++c) {
        pin(dv[c]);
        pin(dk[c]);
      }
    }
    // this warp is done with stage s; thread 0 refills it once all are
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (tid == 0 && j + STAGES < total) {
      mbar_wait(empty0 + 8 * s, (j / STAGES) & 1);
      load_q(pg, pt, s);
      next(pg, pt);
    }
  }

  // rows with every key masked (lse = -inf) among this CTA's heads: their
  // dO / Sk reaches every key's dV. Found 256 rows at a time by a barrier
  // vote; the flags go to the ring's first Q tile, idle now.
  __syncthreads();
  int* const flags = reinterpret_cast<int*>(gbase + (sQ - base));
  for (int g = 0; g < GS; ++g) {
    const int h = hb + g;
    const float* lse = p.stats + static_cast<int64_t>(b * p.H + h) * 2 *
                                     p.Sq_pad;
    const __nv_bfloat16* gb = p.dout + b * p.do_sb + h * p.do_sh;
    for (int q = 0; q < p.Sq; q += 256) {
      const int empty = q + tid < p.Sq && lse[q + tid] == -INFINITY;
      if (!__syncthreads_or(empty)) continue;
      flags[tid] = empty;
      __syncthreads();
      const int rows = min(256, p.Sq - q);
      for (int d = tid; d < D; d += 256) {
        float acc = gE[d];
        for (int i = 0; i < rows; ++i)
          if (flags[i])
            acc += __bfloat162float(
                gb[static_cast<int64_t>(q + i) * p.do_ss + d]);
        gE[d] = acc;
      }
      __syncthreads();
    }
  }
  const float inv_sk = 1.f / static_cast<float>(p.Sk);
#pragma unroll
  for (int c = 0; c < NBO; ++c)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = gE[(cb + c) * CB + 8 * jj + cl + e] * inv_sk;
        dv[c][4 * jj + e] += x;
        dv[c][4 * jj + 2 + e] += x;
      }

  if (NS > 1) {
    // this split's partial in fp32 (each thread its own registers, 16
    // bytes at a time, coalesced); the last CTA of the key tile to arrive
    // sums every split's in split order
    const int group = bkh * (gridDim.x / per_tile) + kt;
    constexpr int V4 = NBO * 8;                  // float4 of dk (dv) a thread
    auto slot = [&](int sp) {
      return reinterpret_cast<float4*>(p.partial) +
             (static_cast<int64_t>(sp) * p.groups + group) * (2 * V4 * 256);
    };
    float4* const mine = slot(split);
#pragma unroll
    for (int c = 0; c < NBO; ++c)
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        mine[(c * 8 + v) * 256 + tid] =
            make_float4(dk[c][4 * v], dk[c][4 * v + 1], dk[c][4 * v + 2],
                        dk[c][4 * v + 3]);
        mine[(V4 + c * 8 + v) * 256 + tid] =
            make_float4(dv[c][4 * v], dv[c][4 * v + 1], dv[c][4 * v + 2],
                        dv[c][4 * v + 3]);
      }
    __threadfence();
    __syncthreads();
    if (tid == 0) *gF = atomicAdd(p.counters + group, 1) == NS - 1;
    __syncthreads();
    if (!*gF) return;
    __threadfence();
#pragma unroll
    for (int c = 0; c < NBO; ++c)
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float4 a = __ldcg(slot(0) + (c * 8 + v) * 256 + tid);
        float4 w = __ldcg(slot(0) + (V4 + c * 8 + v) * 256 + tid);
        for (int sp = 1; sp < NS; ++sp) {
          const float4 x = __ldcg(slot(sp) + (c * 8 + v) * 256 + tid);
          const float4 y = __ldcg(slot(sp) + (V4 + c * 8 + v) * 256 + tid);
          a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
          w.x += y.x; w.y += y.y; w.z += y.z; w.w += y.w;
        }
        dk[c][4 * v] = a.x;
        dk[c][4 * v + 1] = a.y;
        dk[c][4 * v + 2] = a.z;
        dk[c][4 * v + 3] = a.w;
        dv[c][4 * v] = w.x;
        dv[c][4 * v + 1] = w.y;
        dv[c][4 * v + 2] = w.z;
        dv[c][4 * v + 3] = w.w;
      }
  }

  // dK * scale and dV in bf16 into the K and V tiles (every wgmma that read
  // them has completed), then TMA stores, clipped at Sk and D
  __syncthreads();
  if (has_keys) {
    uint8_t* const kst = gbase + (ktile - base);
    uint8_t* const vst = gbase + (vtile - base);
#pragma unroll
    for (int c = 0; c < NBO; ++c) {
      stage_box(kst + (cb + c) * BOX, dk[c], r0, cl, p.scale);
      stage_box(vst + (cb + c) * BOX, dv[c], r0, cl, 1.f);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    for (int w = 0; w < KT; ++w) {
      if (k0 + w * BM >= p.Sk) continue;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_store(&tdk, sK + w * TILE + c * BOX, c * CB, k0 + w * BM, kh, b);
        tma_store(&tdv, sV + w * TILE + c * BOX, c * CB, k0 + w * BM, kh, b);
      }
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, looked up once (nullptr
// if absent)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// 4-D map (D, S, heads, B) of a bf16 tensor given by element strides (s,
// h, b), in boxes of 64 columns x 64 rows with the 128-byte swizzle;
// out-of-bounds reads give zeros
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
              int B, const int64_t* st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * st[0]),
                                 static_cast<cuuint64_t>(2 * st[1]),
                                 static_cast<cuuint64_t>(2 * st[2])};
  const cuuint32_t box[4] = {CB, BM, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  auto encode_map = [&] {
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = encode_map();
  // a driver call: it needs a context current on the calling thread, and
  // a thread that has made no CUDA runtime call yet has none (autograd's
  // device thread, where PyTorch's allocator served every tensor from its
  // cache). Make the primary context of the device holding ``ptr``
  // current, then encode again.
  cudaPointerAttributes a;
  if (r == CUDA_ERROR_INVALID_CONTEXT &&
      cudaPointerGetAttributes(&a, ptr) == cudaSuccess &&
      cudaSetDevice(a.device) == cudaSuccess)
    r = encode_map();
  return r == CUDA_SUCCESS;
}

template <int D, int WG>
constexpr size_t dq_smem() {
  // 1 KB of slack for the alignment; Q and dO tiles, the K and V rings,
  // then qbar, full[STAGES], empty[STAGES]
  return 1024 + static_cast<size_t>(2 * WG + 2 * STAGES) * boxes<D>() * BOX +
         8 * (1 + 2 * STAGES);
}

struct Maps {
  CUtensorMap q, k, v, dout, dq, dk, dv;
};

template <int D, int WG>
cudaError_t launch_dq(const Maps& m, const TcParams& p, cudaStream_t st) {
  constexpr size_t smem = dq_smem<D, WG>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_tc<D, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const int ctas = (p.Sq + BM * WG - 1) / (BM * WG) * p.B * p.H;
  flash_bwd_dq_tc<D, WG><<<ctas, 128 * WG, smem, st>>>(m.q, m.k, m.v,
                                                       m.dout, m.dq, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Maps& m, const TcParams& p, int dq_wg,
                   cudaStream_t st) {
  cudaError_t err;
  if (dq_wg == 2) {
    if constexpr (D <= 128) err = launch_dq<D, 2>(m, p, st);
    else return cudaErrorInvalidValue;
  } else if (dq_wg == 1) {
    err = launch_dq<D, 1>(m, p, st);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Dkdv<D>::smem();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  flash_bwd_dkdv_tc<D><<<p.groups * p.head_split, 256, smem, st>>>(
      m.q, m.k, m.v, m.dout, m.dk, m.dv, p);
  return cudaGetLastError();
}

// ptrs: q, k, v, dout, dq, dk, dv; strides: 21 (b, h, s) element strides
// of them in that order
cudaError_t launch_bf16(const void* const* ptrs, const int64_t* s,
                        TcParams p, int D, int dq_wg, cudaStream_t st) {
  const int keys = D <= 128 ? 2 * BM : BM;       // keys of a dK/dV CTA
  p.groups = p.B * p.Kh * ((p.Sk + keys - 1) / keys);
  Maps m;
  CUtensorMap* maps[7] = {&m.q, &m.k, &m.v, &m.dout, &m.dq, &m.dk, &m.dv};
  for (int i = 0; i < 7; ++i) {
    const bool kv = i == 1 || i == 2 || i == 5 || i == 6;
    // (s, h, b) strides for make_map
    const int64_t t[3] = {s[3 * i + 2], s[3 * i + 1], s[3 * i]};
    if (!make_map(maps[i], ptrs[i], D, kv ? p.Sk : p.Sq, kv ? p.Kh : p.H,
                  p.B, t))
      return cudaErrorInvalidValue;
  }
  switch (D) {
    case 64: return launch<64>(m, p, dq_wg, st);
    case 96: return launch<96>(m, p, dq_wg, st);
    case 120: return launch<120>(m, p, dq_wg, st);
    case 128: return launch<128>(m, p, dq_wg, st);
    case 256: return launch<256>(m, p, dq_wg, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// Kernels a call launches, one after the other on the stream, by dtype
// (0 = float32: lse and Di, dK and dV, dQ; 1 = bfloat16: lse, Di and dQ,
// then dK and dV).
int flash_attention_bwd_passes(int dtype) { return dtype == 1 ? 2 : 3; }

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (b, h, s) for
// q, k, v, dout, dq, dk, dv in that order; the last dimension of every
// tensor is contiguous (bfloat16: every base address and stride a multiple
// of 16 bytes, for TMA; the wrapper checks). stats: fp32 scratch of
// B * H * 2 * Sq_pad floats (Sq_pad = Sq rounded up to 64). bfloat16 only:
// dq_warpgroups (1 or 2; 1 at D 256) and head_split (a divisor of H / Kh;
// above 1, partial holds head_split * B * Kh * key tiles * keys * 64 *
// ceil(D / 64) * 2 floats and counters B * Kh * key tiles ints, a key tile
// being 128 keys at D <= 128 and 64 at D 256). Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, void* dq, void* dk, void* dv,
                        float* stats, float* partial, int* counters,
                        int dtype, int B, int H, int Kh, int Sq, int Sk,
                        int D, const int64_t* strides, int causal,
                        int window, int chunk, float scale,
                        int dq_warpgroups, int head_split, void* stream) {
  if (B <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  const int sq_pad = (Sq + 63) / 64 * 64;
  const int64_t* s = strides;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    if (B * H > 65535) return cudaErrorInvalidValue;   // grid dimension y
    const Params p{q, k, v, dout, dq, dk, dv, stats, stats + sq_pad,
                   2 * static_cast<int64_t>(sq_pad), B, H, Kh, Sq, Sk,
                   s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                   s[9], s[10], s[11], s[12], s[13], s[14], s[15], s[16],
                   s[17], s[18], s[19], s[20],
                   causal, window, chunk, scale};
    err = launch_f32(p, D, st);
  } else if (dtype == 1) {
    if (head_split < 1 || (H / Kh) % head_split != 0 ||
        (head_split > 1 && (partial == nullptr || counters == nullptr)))
      return cudaErrorInvalidValue;
    tc::TcParams p{B, H, Kh, Sq, Sk, sq_pad, causal, window, chunk, scale,
                   stats, partial, counters, 0, head_split,
                   static_cast<const __nv_bfloat16*>(dout), s[9], s[10],
                   s[11]};
    const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
    err = tc::launch_bf16(ptrs, s, p, D, dq_warpgroups, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
