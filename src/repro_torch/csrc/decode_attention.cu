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
//   Slots past the end of a range weigh exactly 0 (-inf).
//
// Bound on an H100 SXM (3.35 TB/s): decode reads every cache byte once for
// 4 flops per (head, slot, dim), far below the tensor cores' rate, so it
// is memory-bound. qwen3-4b at B2 Kh8 C1040 D128 bf16 reads 8.5 MB, about
// 2.5 us; recurrentgemma-9b's attention blocks at B2 Kh1 C2048 D256 bf16
// read 4.2 MB, about 1.3 us; a long cache of 32768 slots at B1 Kh8 D128
// bf16 reads 134 MB, about 40 us.
//
// Design of the bf16 instances (decode_split_tc): split-KV over a grid of
// (split, b * Kh * head tiles) CTAs; a CTA owns one m16 tile of query
// heads (at most 16 of the G heads of one kv head; rows past G are zero)
// and a range of whole 16-slot tiles. The wrapper's split_plan picks the
// splits from the bytes (repro_torch/kernels/decode_attention/kernel.py):
// one wave of CTAs, a tile for every warp, fp32 partials at most a
// quarter of the cache's bytes. Each of the CTA's four warps streams its
// own contiguous share of that range through its own ring of STAGES
// stages in shared memory: a stage is a 16-slot K tile, a 16-slot V tile
// and their 16 kpos values, copied as they lie in memory by cp.async (16
// bytes a lane, rows padded by 16 bytes so that ldmatrix reads them
// without bank conflicts; rows past C are zero-filled), paced by
// commit/wait_group and __syncwarp, so the main loop has no CTA-wide
// barrier. S = Q K^T runs on the tensor cores (mma.sync m16n8k16 bf16,
// fp32 sums): Q is the A operand (in registers at D <= 128, re-read from
// shared memory at D 256, where O alone takes 128 registers), K comes in
// by ldmatrix.x4 as B. Masks and the online softmax work on the S
// fragment in registers (log2(e) folded into the scale, exp2; row max and
// sum across the four lanes of a row). P is rounded to bf16 pairs in
// place: two m16n8 C fragments are the A fragment of one m16n8k16 over
// the 16 slots, and O += P V takes V through ldmatrix.x4.trans. Rounding
// P is the one numerical change against the fp32 oracle. The four warps
// merge their (m, l, O) through shared memory into one partial per CTA,
// and decode_combine_kernel reduces the splits, all of its loads issued
// at once. At short caches the two launches' latency is most of the
// time, so both kernels are launched as programmatic dependents of the
// kernel before them (launch_dependent). The fp32 instances
// (decode_split_kernel) keep the first design: 32-slot tiles staged as
// fp32, the arithmetic on the CUDA cores.
//
// Left for later: the combine in the last CTA of a group (one launch), TMA
// loads, persistent CTAs, an fp8 KV cache, CUDA graphs for a decode step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per CTA of both split kernels
constexpr int NWARP = NT / 32;
constexpr int BK = 32;           // fp32 kernel: cache slots per tile
constexpr int MAX_G = 64;        // query heads per kv head
constexpr int SPLIT_ALIGN = 16;  // a split is whole 16-slot tiles
constexpr int MAX_SPLITS = 4096; // the combine's (m, l) in shared memory
constexpr float NEG = -1.0e30f;  // the oracle's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// bf16 tensor-core kernel: slots per tile (the mma's k for P V, two n8
// tiles for Q K^T), query heads per CTA (the mma's m), ring depth
constexpr int TS = 16;
constexpr int TH = 16;
constexpr int STAGES = 3;

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
  int splits, split_len;    // split_len: a multiple of SPLIT_ALIGN
};

__device__ __forceinline__ float to_f32(float x) { return x; }
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

// ------------------------------------------------ fp32: CUDA-core kernel
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

  asm volatile("griddepcontrol.wait;" ::: "memory");  // launch_dependent
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

template <int D>
constexpr size_t smem_floats(int G) {
  return (size_t)G * D * 2 + BK * (D + 1) + BK * D + (size_t)G * BK + 3 * G;
}

// ------------------------------------------- bf16: tensor-core kernel
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory of one bf16 CTA, in bytes: the Q tile, each warp's ring of
// STAGES (K tile, V tile) pairs, their kpos, and each warp's (m, l) per
// row. Rows are 2 D + 16 bytes: consecutive rows start 16 bytes apart
// modulo 128, so the 8 rows an ldmatrix reads hit 8 different bank
// groups. After the main loop the ring holds the warps' fp32 O for the
// merge.
template <int D>
struct TcLayout {
  static constexpr int ROW = 2 * D + 16;
  static constexpr int TILE = TS * ROW;
  static constexpr int Q = 0;
  static constexpr int RING = Q + TH * ROW;
  static constexpr int RING_WARP = STAGES * 2 * TILE;
  static constexpr int KPOS = RING + NWARP * RING_WARP;
  static constexpr int ML = KPOS + NWARP * STAGES * TS * 4;
  static constexpr int BYTES = ML + 2 * NWARP * TH * 4;
  static constexpr int LDO = D + 4;        // merge buffer's fp32 row
  static_assert(NWARP * TH * LDO * 4 <= NWARP * RING_WARP,
                "the merge buffer fits in the ring");
};

// One CTA: head tile ht of kv head kh of batch b, slots [c0, c1).
template <int D>
__global__ void __launch_bounds__(NT)
decode_split_tc(const Params p) {
  using L = TcLayout<D>;
  constexpr int KSTEPS = D / 16;   // k steps of Q K^T
  constexpr int CH = D / 8;        // 16-byte chunks of a row
  constexpr bool Q_IN_REGS = D <= 128;   // at D 256, O alone is 128 regs
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // the mma fragments' row, column
  const int head_tiles = (p.G + TH - 1) / TH;
  const int split = blockIdx.x;
  const int bk = blockIdx.y / head_tiles;
  const int ht = blockIdx.y - bk * head_tiles;
  const int b = bk / p.Kh, kh = bk - b * p.Kh;
  const int h0 = ht * TH;                  // first head of the tile in G
  const int rows = min(TH, p.G - h0);
  const int c0 = split * p.split_len;
  const int c1 = min(c0 + p.split_len, p.C);

  typedef __nv_bfloat16 bf16;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb +
                   (int64_t)(kh * p.G + h0) * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sh;

  asm volatile("griddepcontrol.wait;" ::: "memory");  // launch_dependent
  // this warp's tiles: a balanced, contiguous share of the CTA's
  const int n_tiles = (c1 - c0 + TS - 1) / TS;
  const int w_t0 = (warp * n_tiles) / NWARP;
  const int w_nt = ((warp + 1) * n_tiles) / NWARP - w_t0;
  const int w_c0 = c0 + w_t0 * TS;

  const uint32_t ring = smem_u32(smem + L::RING + warp * L::RING_WARP);
  const int* sKp = reinterpret_cast<const int*>(
      smem + L::KPOS + warp * STAGES * TS * 4);
  const uint32_t kp_ring = smem_u32(sKp);

  // stage s: K tile at ring + 2 s TILE, V tile after it, kpos at
  // kp_ring + 64 s. Slots at or past c1 are zero-filled.
  auto load_tile = [&](int i, int s) {
    const int tc = w_c0 + i * TS;
    const uint32_t kdst = ring + s * 2 * L::TILE;
    const uint32_t vdst = kdst + L::TILE;
#pragma unroll
    for (int j = 0; j < TS * CH / 32; ++j) {
      const int idx = j * 32 + lane;
      const int r = idx / CH, ch = idx - r * CH;
      const bool in = tc + r < c1;
      const int64_t c = in ? tc + r : 0;
      const uint32_t off = r * L::ROW + ch * 16;
      cp_async16(kdst + off, kb + c * p.k_sc + ch * 8, in ? 16 : 0);
      cp_async16(vdst + off, vb + c * p.v_sc + ch * 8, in ? 16 : 0);
    }
    if (lane < TS / 4) {
      const int c = tc + lane * 4;
      const int n = max(0, min(4, c1 - c));
      cp_async16(kp_ring + s * TS * 4 + lane * 16, p.kpos + (n ? c : 0),
                 n * 4);
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < w_nt) load_tile(s, s);
    cp_async_commit();                     // empty groups keep the count
  }

  // Q tile, while the first tiles are in flight: rows past the group's
  // heads are zero
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q);
  bf16 qv[TH * D / NT];
#pragma unroll
  for (int j = 0; j < TH * D / NT; ++j) {
    const int i = j * NT + tid, r = i / D, d = i - r * D;
    qv[j] = r < rows ? qb[r * p.q_sh + d] : __float2bfloat16(0.f);
  }
#pragma unroll
  for (int j = 0; j < TH * D / NT; ++j) {
    const int i = j * NT + tid, r = i / D, d = i - r * D;
    sQ[r * (L::ROW / 2) + d] = qv[j];
  }
  __syncthreads();                         // the Q tile is in
  // ldmatrix addresses of this lane: matrix mi = lane / 8, its row lane % 8
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t q_addr = smem_u32(smem + L::Q) +
                          (mr + (mi & 1) * 8) * L::ROW + (mi >> 1) * 16;
  const uint32_t k_off = (mr + (mi >> 1) * 8) * L::ROW + (mi & 1) * 16;
  const uint32_t v_off = L::TILE + (mr + (mi & 1) * 8) * L::ROW +
                         (mi >> 1) * 16;
  uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      ldsm_x4(q_addr + kk * 32, qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
  }

  const float scale2 = p.scale * LOG2E;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG, m1 = NEG;                // rows g and g + 8, log2 units
  float l0 = 0.f, l1 = 0.f;                // this lane's share of the sums

  for (int i = 0; i < w_nt; ++i) {
    cp_async_wait<STAGES - 2>();           // tile i has landed (this lane's)
    __syncwarp();                          // ... every lane's; and stage
                                           // (i - 1) % STAGES is read
    if (i + STAGES - 1 < w_nt)
      load_tile(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();

    const int s = i % STAGES;
    const uint32_t kt = ring + s * 2 * L::TILE;

    // S = Q K^T: 16 heads x 16 slots, two n8 fragments
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
        a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
      } else {
        ldsm_x4(q_addr + kk * 32, a[0], a[1], a[2], a[3]);
      }
      uint32_t b0, b1, b2, b3;
      ldsm_x4(kt + k_off + kk * 32, b0, b1, b2, b3);
      mma_bf16(sc[0], a, b0, b1);
      mma_bf16(sc[1], a, b2, b3);
    }

    // masks: the lane holds slots n * 8 + 2 t + e of rows g and g + 8
    const int tc = w_c0 + i * TS;
    const int* kp = sKp + s * TS;
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n * 8 + 2 * t + e;
        float x0, x1;
        if (tc + j >= c1) {
          x0 = x1 = -INFINITY;             // no slot: weighs exactly 0
        } else if (!slot_valid(p, kp[j])) {
          x0 = x1 = NEG;
        } else {
          x0 = sc[n][e] * scale2;
          x1 = sc[n][2 + e] * scale2;
        }
        sc[n][e] = x0;
        sc[n][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);   // finite
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float p0 = exp2f(sc[n][0] - mn0), p1 = exp2f(sc[n][1] - mn0);
      const float p2 = exp2f(sc[n][2] - mn1), p3 = exp2f(sc[n][3] - mn1);
      l0 = l0 * (n ? 1.f : al0) + p0 + p1;
      l1 = l1 * (n ? 1.f : al1) + p2 + p3;
      pa[2 * n] = pack_bf16(p0, p1);       // row g, slots n*8 + 2t, +1
      pa[2 * n + 1] = pack_bf16(p2, p3);   // row g + 8
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= al0; o[n][1] *= al0;
      o[n][2] *= al1; o[n][3] *= al1;
    }

    // O += P V: V^T fragments through ldmatrix.trans, two n8 tiles each
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(kt + v_off + j * 32, b0, b1, b2, b3);
      mma_bf16(o[2 * j], pa, b0, b1);
      mma_bf16(o[2 * j + 1], pa, b2, b3);
    }
  }

  // merge the four warps: O_w scaled by exp2(m_w - M) summed in shared
  // memory (over the idle ring), one partial (M, L, O) per CTA
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  cp_async_wait<0>();
  __syncthreads();
  float* sM = reinterpret_cast<float*>(smem + L::ML);   // [NWARP][TH]
  float* sL = sM + NWARP * TH;                            // [NWARP][TH]
  float* sO = reinterpret_cast<float*>(smem + L::RING);  // [NWARP][TH][LDO]
  if (t == 0) {
    sM[warp * TH + g] = m0;
    sM[warp * TH + g + 8] = m1;
    sL[warp * TH + g] = l0;
    sL[warp * TH + g + 8] = l1;
  }
  __syncthreads();
  float M0 = NEG, M1 = NEG;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    M0 = fmaxf(M0, sM[w * TH + g]);
    M1 = fmaxf(M1, sM[w * TH + g + 8]);
  }
  const float f0 = exp2f(m0 - M0), f1 = exp2f(m1 - M1);
  float* so = sO + warp * TH * L::LDO;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * t;
    *reinterpret_cast<float2*>(so + g * L::LDO + d) =
        make_float2(o[n][0] * f0, o[n][1] * f0);
    *reinterpret_cast<float2*>(so + (g + 8) * L::LDO + d) =
        make_float2(o[n][2] * f1, o[n][3] * f1);
  }
  __syncthreads();

  const int64_t part = ((int64_t)bk * p.splits + split) * p.G + h0;
  float* accp = p.acc_part + part * D;
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D, d = i - r * D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) a += sO[(w * TH + r) * L::LDO + d];
    accp[i] = a;
  }
  if (tid < rows) {
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) M = fmaxf(M, sM[w * TH + tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w)
      l += sL[w * TH + tid] * exp2f(sM[w * TH + tid] - M);
    p.m_part[part + tid] = M;
    p.l_part[part + tid] = l;
  }
}

// ------------------------------------------------------------- combine
// One CTA per (b, h): o = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30)
// with w_s = exp(m_s - max_s m_s); LOG2: the partials' m are in log2
// units (the bf16 kernel), so w_s = exp2(m_s - max_s m_s). A thread per
// split finds M and L; then each thread sums four dims over a share of
// the splits, and the shares are added in shared memory. Launched as a
// programmatic dependent of the split kernel (launch_dependent).
template <typename T, bool LOG2>
__global__ void __launch_bounds__(NT)
decode_combine_kernel(const Params p) {
  constexpr int PRE = 8;                   // acc rows a thread loads early
  extern __shared__ float sW[];            // [splits] m_s, then w_s;
                                           // [splits] l_s
  __shared__ float sRed[2][NWARP];
  __shared__ float4 sSum[NT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kh = h / p.G, g = h - kh * p.G;
  const int64_t part0 = (int64_t)(b * p.Kh + kh) * p.splits;
  const int dq = p.D / 4, shares = NT / dq;       // D 64-256: 16-64 dq
  const int d4 = tid % dq, sh = tid / dq;
  const float* mp = p.m_part + part0 * p.G + g;   // split s at s * G
  const float* lp = p.l_part + part0 * p.G + g;
  const float* ap = p.acc_part + (part0 * p.G + g) * p.D + d4 * 4;
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // every load goes out at once: this thread's first PRE acc rows (four
  // dims of its share of the splits), and m, l of a split per thread
  float4 x[PRE];
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int s = sh + i * shares;
    x[i] = s < p.splits ? *reinterpret_cast<const float4*>(
                              ap + (int64_t)s * p.G * p.D)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float M = NEG;
  for (int s = tid; s < p.splits; s += NT) {
    const float m = mp[s * p.G];
    sW[s] = m;
    sW[p.splits + s] = lp[s * p.G];
    M = fmaxf(M, m);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
  if (lane == 0) sRed[0][warp] = M;
  __syncthreads();
  M = fmaxf(fmaxf(sRed[0][0], sRed[0][1]), fmaxf(sRed[0][2], sRed[0][3]));
  float L = 0.f;
  for (int s = tid; s < p.splits; s += NT) {   // the same s as above
    const float e = sW[s] - M;
    const float w = LOG2 ? exp2f(e) : expf(e);
    sW[s] = w;
    L += sW[p.splits + s] * w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    L += __shfl_xor_sync(FULL, L, off);
  if (lane == 0) sRed[1][warp] = L;
  __syncthreads();
  L = (sRed[1][0] + sRed[1][1]) + (sRed[1][2] + sRed[1][3]);
  const float inv = 1.f / fmaxf(L, 1e-30f);

  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int s = sh + i * shares;
    const float w = s < p.splits ? sW[s] : 0.f;
    a.x += w * x[i].x; a.y += w * x[i].y; a.z += w * x[i].z; a.w += w * x[i].w;
  }
#pragma unroll 4
  for (int s = sh + PRE * shares; s < p.splits; s += shares) {
    const float4 y = *reinterpret_cast<const float4*>(
        ap + (int64_t)s * p.G * p.D);
    const float w = sW[s];
    a.x += w * y.x; a.y += w * y.y; a.z += w * y.z; a.w += w * y.w;
  }
  sSum[tid] = a;
  __syncthreads();
  if (tid < dq) {
    for (int j = 1; j < shares; ++j) {
      const float4 y = sSum[j * dq + tid];
      a.x += y.x; a.y += y.y; a.z += y.z; a.w += y.w;
    }
    T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + d4 * 4;
    ob[0] = from_f32<T>(a.x * inv);
    ob[1] = from_f32<T>(a.y * inv);
    ob[2] = from_f32<T>(a.z * inv);
    ob[3] = from_f32<T>(a.w * inv);
  }
}

template <typename T, int D>
size_t split_smem_bytes(int G) {
  if constexpr (sizeof(T) == 2) return TcLayout<D>::BYTES;
  else return sizeof(float) * smem_floats<D>(G);
}

// the split kernel of an input type: tensor cores for bf16, the CUDA
// cores for fp32, chosen by the type alone
template <typename T, int D>
constexpr auto split_kernel() {
  if constexpr (sizeof(T) == 2) return decode_split_tc<D>;
  else return decode_split_kernel<T, D>;
}

// Launch as a programmatic dependent of the kernel before it in the
// stream: its CTAs may be scheduled while that kernel drains, so the
// launch latency overlaps it. Both kernels here execute griddepcontrol.wait
// before they touch global memory, which holds them until the kernel
// before has finished and its writes are visible.
template <typename K>
cudaError_t launch_dependent(K kernel, dim3 grid, size_t smem,
                             cudaStream_t stream, const Params& p) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<T, D>(p.G);
  constexpr bool TC = sizeof(T) == 2;
  const auto kernel = split_kernel<T, D>();
  const int rows = TC ? p.B * p.Kh * ((p.G + TH - 1) / TH) : p.B * p.Kh;
  if (rows > 65535) return cudaErrorInvalidValue;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = launch_dependent(kernel, dim3(p.splits, rows), smem, stream, p);
  if (err != cudaSuccess) return err;
  return launch_dependent(decode_combine_kernel<T, TC>, dim3(p.B * p.H),
                          2 * p.splits * sizeof(float), stream, p);
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

template <typename T>
long long smem_d(int D, int G) {
  switch (D) {
    case 64: return split_smem_bytes<T, 64>(G);
    case 128: return split_smem_bytes<T, 128>(G);
    case 256: return split_smem_bytes<T, 256>(G);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o). Strides are in elements;
// the last dimension of q, k, v and o is contiguous; for bfloat16, k, v
// and kpos start on 16 bytes and k's and v's (b, h, c) strides are
// multiples of 16 bytes (cp.async). m_part / l_part hold B*Kh*splits*G
// floats and acc_part that times D; split_len is a positive multiple of
// 16 with splits * split_len >= C. Returns a cudaError_t.
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
      split_len % SPLIT_ALIGN != 0 || (int64_t)splits * split_len < C ||
      (int64_t)(splits - 1) * split_len >= C || splits > MAX_SPLITS)
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

// Dynamic shared memory of one split CTA in bytes (-1: no such instance),
// so that the wrapper's plan can be held to the kernel's own layout.
long long decode_attention_smem_bytes(int dtype, int D, int G) {
  if (dtype == 0) return smem_d<float>(D, G);
  if (dtype == 1) return smem_d<__nv_bfloat16>(D, G);
  return -1;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
