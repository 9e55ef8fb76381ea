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
//   asserted: serving runs S = 48. Every tensor is given by strides, so the
//   caller passes transposed [B,S,H,D] projections without a copy and the
//   output is written straight into a [B,S,H,D] buffer.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the serving
// length the kernel is bound by bytes. qwen3-4b (B2 H32 Kh8 S48 D128 bf16)
// moves about 2.0 MB (q, k, v read once, o written once), 0.59 us, against
// 39 MFLOP (0.04 us); recurrentgemma-9b's attention blocks (B4 H16 Kh1 S48
// D256) about 3.4 MB, 1.0 us. From a few thousand tokens on, the S^2 * D
// work bounds it: the 2100-token hybrid prompt (B2 H16 Kh1 D256, window
// 2048) needs 72 GFLOP, 73 us, and a causal S = 4096 (B1 H32 Kh8 D128)
// 137 GFLOP, 139 us, against 73 and 84 MB (22 and 25 us).
//
// bf16 design (the paths' type: tensor cores and an asynchronous K/V ring).
// - Work split: one consumer warpgroup (128 threads) owns a 64-row q tile
//   of one (batch, head), wgmma's M. When 128-row CTAs still cover the
//   card (warpgroups in kernels/flash_attention/kernel.py), two
//   warpgroups share a CTA and its K/V ring, which halves K/V traffic. The
//   q tiles with the most kv tiles start first. kv tiles that the causal,
//   window or chunk mask removes for the whole CTA are never loaded, and
//   a warpgroup skips the math of a tile masked for all its rows.
// - Loads: TMA from 4-D tensor maps (D, S, heads, B) over the strided
//   views, encoded on the host per launch (cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint, so the build needs no -lcuda) and passed as
//   __grid_constant__. Boxes are 64 columns wide (128 bytes, the 128-byte
//   swizzle wgmma reads): 64 rows of Q, a kv tile's rows of K and V (128
//   keys for D <= 128, 64 at D 256, where a 128-key tile's scores would
//   not fit in registers beside the 64 x 256 accumulator); a 96-, 120-
//   or 256-wide head is 2, 2 or 4 boxes, and TMA's zero fill covers
//   ragged Sq / Sk and columns 96-127 of D 96 and 120-127 of D 120 (the
//   maps' D extent is D itself, so the store clips them too). The zero
//   columns add nothing to Q K^T, and P V's columns past D are never
//   stored. The Q tiles load once; K and V go
//   through a 2-stage ring with a full and an empty mbarrier per stage, so
//   tile j + 1 is in flight while tile j is consumed. Thread 0 starts
//   every copy.
// - S = Q K^T: wgmma m64n64k16 bf16 -> fp32 per 64 keys, Q and K from
//   shared memory (K-major descriptors). Masks, scale and the online
//   softmax run on the accumulator fragments in registers (base-2
//   exponent on the special function unit, row statistics reduced over
//   the 4 lanes that share a row; a row with nothing unmasked yet keeps
//   m = -inf, l = 0, acc = 0).
// - O += P V: P rounded to bf16 in registers is wgmma's A operand as it
//   lies (the accumulator's layout is the A fragment's); V is read from
//   shared memory through an MN-major (transposed) descriptor, so it
//   needs no transposed copy. Rounding P to bf16 is the one numerical
//   difference from the fp32 path.
// - Epilogue: divide by l; a row with l = 0 (every key masked) gets
//   mean(v) from a plain loop over v in device memory, as no path reaches
//   it; the tile goes to shared memory (the warpgroup's Q tile, swizzled)
//   and out by a TMA store, which clips at Sq and D.
// Left for later: warp specialisation with setmaxnreg, the ping-pong of
// two warpgroups, overlapping softmax with the next wgmma, persistent
// scheduling, fp8.
//
// fp32 instances (on no path: the models run bf16 on the card) keep the
// CUDA-core design: one CTA per 64-row q tile, fp32 tiles in shared
// memory, 256 threads; thread t serves q row t / 4 and lane c = t % 4 of
// it (keys c, c+4, ... for the scores; columns c, c+4, ... for the
// output). TF32 tensor cores would not hold the fp32 path's tolerance.

#include <cuda.h>            // CUtensorMap and its enums only: no -lcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ------------------------------------------ fp32: CUDA cores (as before)

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
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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
  // above 48 KB only as opted-in dynamic shared memory (D=128: 96.5 KB,
  // D=256: 192.5 KB of the 227 KB a CTA may have, so one CTA per SM);
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


// ------------------------------------------------- bf16: wgmma + TMA ring
namespace tc {

constexpr int BM = 64;               // q rows per consumer warpgroup
constexpr int CB = 64;               // columns per box: 128 bytes of bf16
constexpr int STAGES = 2;            // K/V ring depth

// keys per kv tile: 128 where the registers allow (S and P of a 128-key
// tile beside a 64 x D accumulator), 64 at D 256
__host__ __device__ constexpr int keys_per_tile(int D) {
  return D <= 128 ? 128 : 64;
}

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

// Spin until the phase of ``bar`` with this parity has completed. A wait
// past kWaitLimitNs (a copy that never lands; every wait of a working
// kernel ends within microseconds) traps instead of hanging the card. A
// trap is a sticky error: it breaks the process's CUDA context, so this
// launch and every later CUDA call of the process fail, and the process
// has to be restarted.
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

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3) : "memory");
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
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      ACC32_LIST ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// keys a query row may see: [lo, hi] (the mask is an interval)
__device__ __forceinline__ int row_lo(const Params& p, int qpos) {
  int lo = 0;
  if (p.window >= 0) lo = max(lo, qpos - p.window + 1);
  if (p.chunk > 0) lo = max(lo, qpos / p.chunk * p.chunk);
  return lo;
}
__device__ __forceinline__ int row_hi(const Params& p, int qpos) {
  int hi = p.Sk - 1;
  if (p.causal) hi = min(hi, qpos);
  if (p.chunk > 0) hi = min(hi, qpos / p.chunk * p.chunk + p.chunk - 1);
  return hi;
}

// base-2 exponent on the special function unit (-inf gives +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__host__ __device__ constexpr int boxes() { return (D + CB - 1) / CB; }

template <int D, int WG>
constexpr size_t smem_bytes() {
  // 1 KB of slack to align the swizzled tiles to 1024 bytes; Q tiles, the
  // K and V rings, then qbar, full[STAGES], empty[STAGES]
  return 1024 + static_cast<size_t>(boxes<D>()) * 128 *
         (WG * BM + 2 * STAGES * keys_per_tile(D)) + 8 * (1 + 2 * STAGES);
}

// Thread layout inside a warpgroup (wgmma's accumulator): warp w holds rows
// 16w .. 16w+15; lane l holds rows r = 16w + l/4 and r + 8, and in each
// 8-column group j the columns 8j + 2(l%4) and +1. For a 64-column
// accumulator d[32]: d[4j], d[4j+1] are (r, 8j+2(l%4) + 0/1), d[4j+2],
// d[4j+3] the same columns of row r + 8. A BN-key tile of scores is BN / 64
// such accumulators.
template <int D, int WG>
__global__ void __launch_bounds__(128 * WG, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap to, const Params p) {
  constexpr int NB = boxes<D>();
  constexpr int BN = keys_per_tile(D);
  constexpr int NH = BN / 64;                    // 64-key blocks of a tile
  constexpr uint32_t QBOX = BM * 128, KBOX = BN * 128;   // one box, bytes
  constexpr uint32_t QTILE = NB * QBOX, KTILE = NB * KBOX;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = sQ + WG * QTILE;
  const uint32_t sV = sK + STAGES * KTILE;
  const uint32_t qbar = sV + STAGES * KTILE;
  const uint32_t full0 = qbar + 8, empty0 = qbar + 8 * (1 + STAGES);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kh = h / (p.H / p.Kh);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * (BM * WG);  // longest first
  const int q1 = min(q0 + BM * WG, p.Sq) - 1;
  const int wq0 = q0 + wg * BM;                  // this warpgroup's rows
  const int wq1 = min(wq0 + BM, p.Sq) - 1;
  const bool has_rows = wq0 < p.Sq;              // uniform per warpgroup

  // kv tiles some row of the CTA may see: [kt0, kt0 + nt)
  const int klo = row_lo(p, q0), khi = row_hi(p, q1);
  const int kt0 = klo / BN;
  const int nt = klo <= khi ? khi / BN - kt0 + 1 : 0;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * WG);         // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int j, int s) {             // tile kt0 + j -> stage s
    const uint32_t bar = full0 + 8 * s;
    mbar_expect_tx(bar, 2 * KTILE);              // zero fill counts too
    const int k0 = (kt0 + j) * BN;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load(sK + s * KTILE + c * KBOX, &tk, bar, c * CB, k0, kh, b);
      tma_load(sV + s * KTILE + c * KBOX, &tv, bar, c * CB, k0, kh, b);
    }
  };
  if (tid == 0) {
    int nq = 0;
    for (int w = 0; w < WG; ++w) nq += (q0 + w * BM < p.Sq);
    mbar_expect_tx(qbar, nq * QTILE);
    for (int w = 0; w < WG; ++w) {
      if (q0 + w * BM >= p.Sq) continue;
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load(sQ + w * QTILE + c * QBOX, &tq, qbar, c * CB,
                 q0 + w * BM, h, b);
    }
    for (int j = 0; j < min(nt, STAGES); ++j) load_kv(j, j);
  }

  const int r0 = warp * 16 + lane / 4;          // rows r0 and r0 + 8
  const int qp0 = wq0 + r0, qp1 = qp0 + 8;
  const int lo0 = row_lo(p, qp0), hi0 = row_hi(p, qp0);
  const int lo1 = row_lo(p, qp1), hi1 = row_hi(p, qp1);
  const int cl = 2 * (lane % 4);                 // first column in a group
  const float sl = p.scale * 1.4426950408889634f;  // scale * log2(e)

  float o[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;          // running max, log2 units
  float l0 = 0.f, l1 = 0.f;                      // this lane's partial sums

  const uint32_t qtile = sQ + wg * QTILE;
  mbar_wait(qbar, 0);
  for (int j = 0; j < nt; ++j) {
    const int s = j % STAGES;
    const int k0 = (kt0 + j) * BN;
    const int k1 = min(k0 + BN, p.Sk) - 1;
    __syncwarp();
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    if (has_rows && !tile_masked(p, wq0, wq1, k0, k1)) {
      const uint32_t ktile = sK + s * KTILE, vtile = sV + s * KTILE;
      float sc[NH][32];
#pragma unroll
      for (int hb = 0; hb < NH; ++hb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[hb][i] = 0.f;
        pin(sc[hb]);
      }
      wg_fence();
#pragma unroll
      for (int hb = 0; hb < NH; ++hb)
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int kk = 0; kk < CB / 16; ++kk)
            wgmma_ss(sc[hb], desc(qtile + c * QBOX + 32 * kk),
                     desc(ktile + c * KBOX + hb * 64 * 128 + 32 * kk),
                     c | kk);
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int hb = 0; hb < NH; ++hb) pin(sc[hb]);

      // every pair of the warpgroup's 64 x BN block allowed: no masking
      const bool unmasked = k0 + BN <= p.Sk &&
          row_lo(p, wq0 + BM - 1) <= k0 && row_hi(p, wq0) >= k0 + BN - 1;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int hb = 0; hb < NH; ++hb)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + 64 * hb + 8 * jj + cl + e;
            float x0 = sc[hb][4 * jj + e] * sl;
            float x1 = sc[hb][4 * jj + 2 + e] * sl;
            if (!unmasked) {
              if (kp < lo0 || kp > hi0) x0 = -INFINITY;
              if (kp < lo1 || kp > hi1) x1 = -INFINITY;
            }
            sc[hb][4 * jj + e] = x0;
            sc[hb][4 * jj + 2 + e] = x1;
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
      const float a0 = exp2_approx(m0 - base0), a1 = exp2_approx(m1 - base1);
      m0 = mn0;
      m1 = mn1;
      uint32_t pa[NH][16];                       // P in bf16, A's layout
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int hb = 0; hb < NH; ++hb)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float p00 = exp2_approx(sc[hb][4 * jj] - base0);
          const float p01 = exp2_approx(sc[hb][4 * jj + 1] - base0);
          const float p10 = exp2_approx(sc[hb][4 * jj + 2] - base1);
          const float p11 = exp2_approx(sc[hb][4 * jj + 3] - base1);
          ls0 += p00 + p01;
          ls1 += p10 + p11;
          pa[hb][2 * jj] = pack_bf16(p00, p01);
          pa[hb][2 * jj + 1] = pack_bf16(p10, p11);
        }
      l0 = l0 * a0 + ls0;
      l1 = l1 * a1 + ls1;
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          o[c][4 * jj] *= a0;
          o[c][4 * jj + 1] *= a0;
          o[c][4 * jj + 2] *= a1;
          o[c][4 * jj + 3] *= a1;
        }

#pragma unroll
      for (int c = 0; c < NB; ++c) pin(o[c]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          const uint32_t* a = &pa[kk / 4][4 * (kk % 4)];
          wgmma_rs(o[c], a[0], a[1], a[2], a[3],
                   desc(vtile + c * KBOX + 16 * 128 * kk));
        }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < NB; ++c) pin(o[c]);
    }
    // this warp is done with stage s; thread 0 refills it once all are
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (tid == 0 && j + STAGES < nt) {
      mbar_wait(empty0 + 8 * s, (j / STAGES) & 1);
      load_kv(j + STAGES, s);
    }
  }
  if (!has_rows) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // A row with no unmasked key: the oracle's uniform softmax, mean(v).
  // No path has such a row; a plain loop over v in device memory.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = half ? qp1 : qp0;
    float& l = half ? l1 : l0;
    if (qp >= p.Sq || l != 0.f) continue;
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v)
        + b * p.v_sb + kh * p.v_sh;
    for (int kp = 0; kp < p.Sk; ++kp) {
      const __nv_bfloat16* vr = vb + static_cast<int64_t>(kp) * p.v_ss;
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c * CB + 8 * jj + cl + e;
            if (col < D)
              o[c][4 * jj + 2 * half + e] += __bfloat162float(vr[col]);
          }
    }
    l = static_cast<float>(p.Sk);
  }

  // o / l in bf16 into this warpgroup's Q tile (free now: the last wgmma
  // that read it has completed), swizzled as the output map expects, then
  // one TMA store per box; rows past Sq and columns past D are clipped
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  uint8_t* const otile = gbase + (qtile - base);
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const uint32_t col = ((jj ^ (r0 & 7)) << 4) + 2 * cl;   // bytes
      uint8_t* const blk = otile + c * QBOX;
      *reinterpret_cast<uint32_t*>(blk + r0 * 128 + col) =
          pack_bf16(o[c][4 * jj] * inv0, o[c][4 * jj + 1] * inv0);
      *reinterpret_cast<uint32_t*>(blk + (r0 + 8) * 128 + col) =
          pack_bf16(o[c][4 * jj + 2] * inv1, o[c][4 * jj + 3] * inv1);
    }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" :: "r"(wg + 1) : "memory");
  if (tid % 128 == 0) {
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_store(&to, qtile + c * QBOX, c * CB, wq0, h, b);
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

// 4-D map (D, S, heads, B) of a bf16 tensor given by element strides, in
// boxes of 64 columns x ``rows`` with the 128-byte swizzle; out-of-bounds
// reads give zeros
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
              int B, int64_t ss, int64_t sh, int64_t sb, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * ss),
                                 static_cast<cuuint64_t>(2 * sh),
                                 static_cast<cuuint64_t>(2 * sb)};
  const cuuint32_t box[4] = {CB, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int WG>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, WG>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc<D, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  constexpr int BN = keys_per_tile(D);
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, BM) ||
      !make_map(&tk, p.k, D, p.Sk, p.Kh, p.B, p.k_ss, p.k_sh, p.k_sb, BN) ||
      !make_map(&tv, p.v, D, p.Sk, p.Kh, p.B, p.v_ss, p.v_sh, p.v_sb, BN) ||
      !make_map(&to, p.o, D, p.Sq, p.H, p.B, p.o_ss, p.o_sh, p.o_sb, BM))
    return cudaErrorInvalidValue;
  const dim3 grid((p.Sq + BM * WG - 1) / (BM * WG), p.B * p.H);
  flash_fwd_tc<D, WG><<<grid, 128 * WG, smem, stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wg(const Params& p, int warpgroups, cudaStream_t stream) {
  switch (warpgroups) {
    case 1: return launch<D, 1>(p, stream);
    case 2: return launch<D, 2>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc


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

cudaError_t launch_bf16(const Params& p, int D, int warpgroups,
                        cudaStream_t stream) {
  switch (D) {
    case 64: return tc::launch_wg<64>(p, warpgroups, stream);
    case 96: return tc::launch_wg<96>(p, warpgroups, stream);
    case 120: return tc::launch_wg<120>(p, warpgroups, stream);
    case 128: return tc::launch_wg<128>(p, warpgroups, stream);
    case 256: return tc::launch_wg<256>(p, warpgroups, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of every tensor is contiguous; for bfloat16 every base address
// and stride is a multiple of 16 bytes (the wrapper checks). warpgroups
// (1 or 2: q rows per CTA / 64) is read by the bfloat16 instances only.
// Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int Kh, int Sq, int Sk,
                        int D, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                        int64_t k_sb, int64_t k_sh, int64_t k_ss,
                        int64_t v_sb, int64_t v_sh, int64_t v_ss,
                        int64_t o_sb, int64_t o_sh, int64_t o_ss,
                        int causal, int window, int chunk, float scale,
                        int warpgroups, void* stream) {
  if (B <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, o, B, H, Kh, Sq, Sk,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                 causal, window, chunk, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch_f32(p, D, st);
  else if (dtype == 1) err = launch_bf16(p, D, warpgroups, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
