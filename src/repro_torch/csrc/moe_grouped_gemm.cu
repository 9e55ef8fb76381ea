// Grouped expert product of a served MoE layer for Hopper (sm_90a), CUDA
// C++ with a plain C entry point loaded through ctypes
// (repro_torch/kernels/_build.py).
//
// It replaces no Pallas kernel: the JAX package runs its experts as batched
// products over a padded [E, C, D] buffer (repro.models.moe._moe_ffn_block),
// which at dropless capacity (C = T) computes E / k times the routed work.
// Here each expert runs over its own rows only. Two kernels a call, over N
// rows grouped by expert (the rows of expert e are off[e] .. off[e + 1],
// off[E] <= N), computing exactly moe_grouped_ffn_ref
// (kernels/moe_gemm/ref.py):
//   moe_grouped_gate_up: H[r] = silu(x[src[r]] w1[e]) * (x[src[r]] w3[e]),
//     gathering the token rows itself (no [N, D] copy of the entries), both
//     products accumulated in fp32 and the epilogue applied in fp32 before
//     one rounding to the input type;
//   moe_grouped_down: O[r] = H[r] w2[e], accumulated in fp32.
// x [T, D], w1 and w3 [E, D, F], w2 [E, F, D], H [N, F], O [N, D], all
// contiguous; D and F multiples of 64.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): a served Qwen3-30B-A3B
// layer (T 4096, k 8, D 2048, F 768, E 128: N = 32768 entries) does 309
// GFLOP (0.31 ms) and must read 1.21 GB of expert weights (0.36 ms) plus x
// once, H twice and O once: the product sits at the ridge.
//
// The grid is fixed for the worst case, ceil(N / BM) + E row tiles by the
// column tiles, so a launch depends on shapes alone and a CUDA graph
// captured once is right for any routing. A CTA's first warp finds its
// expert from the offsets (a warp scan of the groups' tile counts), and a
// CTA past the last tile returns at once. The column tiles of one row tile
// are neighbours in the grid, so they share the gathered rows in L2, and
// the row tiles of one expert follow each other, so they share its
// weights. Nothing is read back to the host.
//
// bf16 design (the served path's type: tensor cores).
// - A CTA: two consumer warpgroups of 64 rows each (wgmma's M), 128 rows of
//   one expert by 128 columns of both w1 and w3 (gate and up, 2 x 64
//   fp32 accumulator registers a thread) or 256 columns of w2 (down, 4 x
//   32). Both kernels run the same main loop over 64-deep k steps, four
//   64-column B boxes a step.
// - Loads: the weights by TMA from 2-D tensor maps over [E * K, columns]
//   (box 64 columns x 64 k rows, the 128-byte swizzle; columns past the
//   matrix are zero-filled), started by thread 0; the A rows by cp.async,
//   16 bytes a thread and four rows each, into the same swizzled layout,
//   gathered through src in gate and up (rows past the group are
//   zero-filled). A 4-stage ring: a full mbarrier per stage (the TMA's
//   bytes) and an empty one (one arrival per warp), as in
//   flash_attention.cu; the cp.async groups of a warpgroup complete in
//   order behind a named barrier and a proxy fence.
// - Products: wgmma m64n256k16 bf16 -> fp32 over a step's four B boxes at
//   once (so A is read from shared memory once for 256 columns), A K-major
//   and B MN-major (transposed) from shared memory, so neither operand is
//   copied. One step's 4 wgmma stay in flight while the stage before is
//   refilled.
// - Epilogue: gate and up apply silu(g) * u in fp32 and round to bf16;
//   rows past the group and columns past the matrix are not stored.
//
// fp32 instances (on no served path: the models run bf16 on the card) use
// the CUDA cores: a CTA of 256 threads computes 64 rows by 64 columns (of
// both w1 and w3 in gate and up), 4 x 4 outputs a thread, over 16-deep
// k steps through shared memory. TF32 tensor cores would not hold the fp32
// path's tolerance.

#include <cuda.h>            // CUtensorMap and its enums only: no -lcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  const void* a;          // the rows multiplied: x [T, K] or H [N, K]
  const int64_t* src;     // the token of each row (gate and up), or null
  const int* off;         // [E + 1] the groups' first rows
  void* out;              // [N, ncols]
  int E, K, ncols;        // K: D (gate and up) or F (down)
  int col_tiles;          // column tiles of a row tile
};

// The CTA's group: the expert whose row tiles hold row tile ``tile``, the
// first row of that tile and the group's end; false past the last tile.
// The first warp scans the groups' tile counts, 32 experts a step.
template <int BM>
__device__ __forceinline__ bool find_group(const Params& p, int tile,
                                           int& expert, int& row0,
                                           int& row_end) {
  __shared__ int info[3];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0, found = -1, r0 = 0, r1 = 0;
    for (int e0 = 0; e0 < p.E; e0 += 32) {
      const int e = e0 + lane;
      const int lo = e < p.E ? p.off[e] : 0;
      const int hi = e < p.E ? p.off[e + 1] : 0;
      const int t = (hi - lo + BM - 1) / BM;
      int inc = t;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += v;
      }
      const int first = base + inc - t;
      const unsigned hit = __ballot_sync(
          0xffffffffu, t > 0 && tile >= first && tile < first + t);
      if (hit) {
        const int l = __ffs(hit) - 1;
        found = __shfl_sync(0xffffffffu, e, l);
        r0 = __shfl_sync(0xffffffffu, lo + (tile - first) * BM, l);
        r1 = __shfl_sync(0xffffffffu, hi, l);
        break;
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) {
      info[0] = found;
      info[1] = r0;
      info[2] = r1;
    }
  }
  __syncthreads();
  expert = info[0];
  row0 = info[1];
  row_end = info[2];
  return expert >= 0;
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// ------------------------------------------------------ fp32: CUDA cores
namespace simt {

constexpr int BM = 64, BN = 64, BK = 16, NT = 256;

// NMAT weight matrices (gate and up: 2, down: 1) over one A tile
template <int NMAT>
__device__ __forceinline__ void grouped(const float* w0, const float* w1,
                                        const Params& p, float (&acc)[2][4][4],
                                        int expert, int row0, int row_end,
                                        int col0) {
  __shared__ float sA[BK][BM + 4];
  __shared__ __align__(16) float sB[NMAT][BK][BN];   // float4 stores
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* a = static_cast<const float*>(p.a);
  // this thread's A row and 4 k values of a step
  const int ar = tid / 4, ak = (tid % 4) * 4;
  const int grow = row0 + ar;
  const bool aok = grow < row_end;
  const int64_t arow = aok ? (p.src ? p.src[grow] : grow) : 0;
  const float* asrc = a + arow * p.K + ak;
  // this thread's B row and 4 columns of a step
  const int br = tid / 16, bc = (tid % 16) * 4;
  const int64_t wrow = static_cast<int64_t>(expert) * p.K + br;
  const bool bok = col0 + bc < p.ncols;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.f;
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    const float4 av = aok ? *reinterpret_cast<const float4*>(asrc + k0)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();          // the last step's readers are done
    sA[ak][ar] = av.x;
    sA[ak + 1][ar] = av.y;
    sA[ak + 2][ar] = av.z;
    sA[ak + 3][ar] = av.w;
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      const float* w = m ? w1 : w0;
      const float4 bv = bok ? *reinterpret_cast<const float4*>(
          w + (wrow + k0) * p.ncols + col0 + bc)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&sB[m][br][bc]) = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av4[i] = sA[kk][ty + 16 * i];
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = sB[m][kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][i][j] += av4[i] * b;
        }
    }
  }
}

__global__ void __launch_bounds__(NT)
moe_grouped_gate_up(const float* w1, const float* w3, const Params p) {
  int expert, row0, row_end;
  const int col0 = (blockIdx.x % p.col_tiles) * BN;
  if (!find_group<BM>(p, blockIdx.x / p.col_tiles, expert, row0, row_end))
    return;
  float acc[2][4][4];
  grouped<2>(w1, w3, p, acc, expert, row0, row_end, col0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < p.ncols)
        out[static_cast<int64_t>(row) * p.ncols + col] =
            silu_mul(acc[0][i][j], acc[1][i][j]);
    }
  }
}

__global__ void __launch_bounds__(NT)
moe_grouped_down(const float* w2, const Params p) {
  int expert, row0, row_end;
  const int col0 = (blockIdx.x % p.col_tiles) * BN;
  if (!find_group<BM>(p, blockIdx.x / p.col_tiles, expert, row0, row_end))
    return;
  float acc[2][4][4];
  grouped<1>(w2, w2, p, acc, expert, row0, row_end, col0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < p.ncols)
        out[static_cast<int64_t>(row) * p.ncols + col] = acc[0][i][j];
    }
  }
}

}  // namespace simt


// ------------------------------------------------- bf16: wgmma + TMA ring
namespace tc {

constexpr int WG = 2;                  // consumer warpgroups of 64 rows
constexpr int BM = 64 * WG;            // rows of a CTA
constexpr int BK = 64;                 // k of a step: 128 bytes of bf16
constexpr int NBOX = 4;                // 64-column B boxes a step
constexpr int STAGES = 4;
constexpr uint32_t ABOX = 64 * 128;    // a warpgroup's A rows of a step
constexpr uint32_t BBOX = BK * 128;    // one B box
constexpr uint32_t STAGE = WG * ABOX + NBOX * BBOX;
// 1 KB of slack to align the swizzled tiles to 1024 bytes, the ring, then
// full[STAGES] and empty[STAGES]
constexpr size_t SMEM = 1024 + STAGES * STAGE + 16 * STAGES;

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
// past kWaitLimitNs traps instead of hanging the card (a sticky error:
// the process's CUDA context is lost), as in flash_attention.cu.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint32_t t0 = globaltimer_lo();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer_lo() - t0 > kWaitLimitNs) __trap();
}

// one box (64 columns at column c0, 64 rows at row c1)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1) : "memory");
}

// 16 bytes, or zeros where ``bytes`` is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand in shared memory (as in
// flash_attention.cu): groups of 8 rows, or of 8 k values MN-major, lie
// 1024 bytes apart (the stride byte offset). ``lead`` is the leading byte
// offset: for the MN-major B, the distance between its 64-column swizzle
// atoms, one B box to the next; A (K-major, one atom deep) does not read it.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(lead >> 4) << 16)
       | (static_cast<uint64_t>(1024 >> 4) << 32)
       | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses to the accumulator across a
// wgmma or its wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A B: A 64x16 K-major, B 16x256 MN-major (transposed, four 64-column
// swizzle atoms ``lead`` bytes apart), both from shared memory; d is the
// 64 x 256 accumulator, 128 fp32 registers a thread
__device__ __forceinline__ void wgmma_st(float (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
      "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
      "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
      "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
      "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The main loop shared by both kernels: acc (+)= A B over the K of the
// CTA's expert, B a step's four boxes side by side (gate and up: columns
// col0 and col0 + 64 of w1, then of w3; down: columns col0 + 64 b of w2).
// Thread layout of the accumulator (wgmma's): warp w of a warpgroup holds
// rows 16w .. 16w+15; lane l holds rows r = 16w + l/4 and r + 8, and in
// each 8-column group j the columns 8j + 2(l%4) and +1: acc[4j], acc[4j+1]
// of row r, acc[4j+2], acc[4j+3] of row r + 8; box b's columns are groups
// 8b .. 8b + 7, acc[32b] on.
template <bool GATED>
__device__ __forceinline__ void mainloop(const CUtensorMap* m0,
                                         const CUtensorMap* m1,
                                         const Params& p, int expert,
                                         int row0, int row_end, int col0,
                                         float (&acc)[32 * NBOX]) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full0 = base + STAGES * STAGE;
  const uint32_t empty0 = full0 + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * WG);         // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // this thread's A rows: 4 of its warpgroup's 64, one 16-byte chunk of
  // each a step, written where the 128-byte swizzle puts it
  const int chunk = tid % 8;
  const __nv_bfloat16* arow[4];
  uint32_t abytes[4], adst[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (tid % 128) / 8 + 16 * i;
    const int grow = row0 + wg * 64 + r;
    const bool ok = grow < row_end;
    const int64_t at = ok ? (p.src ? p.src[grow] : grow) : 0;
    arow[i] = static_cast<const __nv_bfloat16*>(p.a) + at * p.K + 8 * chunk;
    abytes[i] = ok ? 16u : 0u;
    adst[i] = wg * ABOX + r * 128 + ((chunk ^ (r & 7)) << 4);
  }
  const int nk = p.K / BK;
  const int wrow = expert * p.K;
  auto load_a = [&](int j, int s) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cp_async16(base + s * STAGE + adst[i], arow[i] + j * BK, abytes[i]);
  };
  auto load_b = [&](int j, int s) {              // thread 0
    const uint32_t bar = full0 + 8 * s;
    mbar_expect_tx(bar, NBOX * BBOX);            // zero fill counts too
#pragma unroll
    for (int b = 0; b < NBOX; ++b) {
      const CUtensorMap* map = (GATED && b >= 2) ? m1 : m0;
      const int c = col0 + 64 * (GATED ? b % 2 : b);
      tma_load(base + s * STAGE + WG * ABOX + b * BBOX, map, bar, c,
               wrow + j * BK);
    }
  };

  for (int j = 0; j < STAGES; ++j) {             // one group per stage
    if (j < nk) load_a(j, j);
    cp_async_commit();
  }
  if (tid == 0)
    for (int j = 0; j < min(nk, STAGES); ++j) load_b(j, j);

#pragma unroll
  for (int i = 0; i < 32 * NBOX; ++i) acc[i] = 0.f;
  pin(acc);
  for (int j = 0; j < nk; ++j) {
    const int s = j % STAGES;
    // this thread's rows of step j have landed, then the warpgroup's,
    // visible to the async proxy. Steps 0 .. STAGES - 1 are groups 0 ..
    // STAGES - 1; iteration i commits one group (step i - 1 + STAGES, or
    // none), so step t >= STAGES is group t + 1, and STAGES + j groups
    // are committed here: at most STAGES - 2 may still be pending
    cp_async_wait<STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" :: "r"(wg + 1) : "memory");
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    const uint32_t at = base + s * STAGE + wg * ABOX;
    const uint32_t bt = base + s * STAGE + WG * ABOX;
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_st(acc, desc(at + 32 * kk, 1024),
               desc(bt + 16 * 128 * kk, BBOX));
    wg_commit();
    // step j - 1's products are done: refill its stage while step j's run
    wg_wait<1>();
    pin(acc);
    const int jp = j - 1, sp = (j + STAGES - 1) % STAGES;
    asm volatile("bar.sync %0, 128;" :: "r"(wg + 1) : "memory");
    if (jp >= 0 && jp + STAGES < nk) load_a(jp + STAGES, sp);
    cp_async_commit();
    if (jp >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * sp);
      if (tid == 0 && jp + STAGES < nk) {
        mbar_wait(empty0 + 8 * sp, (jp / STAGES) & 1);
        load_b(jp + STAGES, sp);
      }
    }
  }
  wg_wait<0>();
  pin(acc);
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(128 * WG, 1)
moe_grouped_gate_up(const __grid_constant__ CUtensorMap w1,
                    const __grid_constant__ CUtensorMap w3, const Params p) {
  int expert, row0, row_end;
  const int col0 = (blockIdx.x % p.col_tiles) * 128;
  if (!find_group<BM>(p, blockIdx.x / p.col_tiles, expert, row0, row_end))
    return;
  float acc[32 * NBOX];
  mainloop<true>(&w1, &w3, p, expert, row0, row_end, col0, acc);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int r = row0 + wg * 64 + warp * 16 + lane / 4;
  const int cl = 2 * (lane % 4);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= row_end) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = col0 + 64 * c + 8 * jj + cl;
        if (col >= p.ncols) continue;
        const int i = 4 * jj + 2 * half;
        *reinterpret_cast<uint32_t*>(
            out + static_cast<int64_t>(row) * p.ncols + col) =
            pack_bf16(silu_mul(acc[32 * c + i], acc[32 * (2 + c) + i]),
                      silu_mul(acc[32 * c + i + 1],
                               acc[32 * (2 + c) + i + 1]));
      }
  }
}

__global__ void __launch_bounds__(128 * WG, 1)
moe_grouped_down(const __grid_constant__ CUtensorMap w2, const Params p) {
  int expert, row0, row_end;
  const int col0 = (blockIdx.x % p.col_tiles) * 256;
  if (!find_group<BM>(p, blockIdx.x / p.col_tiles, expert, row0, row_end))
    return;
  float acc[32 * NBOX];
  mainloop<false>(&w2, &w2, p, expert, row0, row_end, col0, acc);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int r = row0 + wg * 64 + warp * 16 + lane / 4;
  const int cl = 2 * (lane % 4);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= row_end) continue;
#pragma unroll
    for (int c = 0; c < NBOX; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = col0 + 64 * c + 8 * jj + cl;
        if (col >= p.ncols) continue;
        const int i = 4 * jj + 2 * half;
        *reinterpret_cast<uint32_t*>(
            out + static_cast<int64_t>(row) * p.ncols + col) =
            pack_bf16(acc[32 * c + i], acc[32 * c + i + 1]);
      }
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

// 2-D map of the experts' weights [E * K, cols] (bf16, contiguous), in
// boxes of 64 columns x 64 rows with the 128-byte swizzle; columns past
// ``cols`` read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int cols, int64_t rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(2 * cols)};
  const cuuint32_t box[2] = {64, BK};
  const cuuint32_t step[2] = {1, 1};
  auto encode_map = [&] {
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(ptr), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = encode_map();
  // a driver call needs a context current on the calling thread (see
  // flash_attention.cu): make the device's primary context current and
  // encode again
  cudaPointerAttributes a;
  if (r == CUDA_ERROR_INVALID_CONTEXT &&
      cudaPointerGetAttributes(&a, ptr) == cudaSuccess &&
      cudaSetDevice(a.device) == cudaSuccess)
    r = encode_map();
  return r == CUDA_SUCCESS;
}

}  // namespace tc

int row_tiles(int n, int groups, int bm) { return (n + bm - 1) / bm + groups; }

cudaError_t launch_bf16(const void* x, const int64_t* src, const int* off,
                        const void* w1, const void* w3, const void* w2,
                        void* h, void* o, int N, int D, int F, int E,
                        cudaStream_t stream) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        tc::moe_grouped_gate_up, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tc::SMEM));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        tc::moe_grouped_down, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tc::SMEM));
  }();
  if (attr != cudaSuccess) return attr;
  CUtensorMap m1, m3, m2;
  if (!tc::make_map(&m1, w1, F, static_cast<int64_t>(E) * D) ||
      !tc::make_map(&m3, w3, F, static_cast<int64_t>(E) * D) ||
      !tc::make_map(&m2, w2, D, static_cast<int64_t>(E) * F))
    return cudaErrorInvalidValue;
  const int tiles = row_tiles(N, E, tc::BM);
  const Params gu{x, src, off, h, E, D, F, (F + 127) / 128};
  tc::moe_grouped_gate_up<<<tiles * gu.col_tiles, 128 * tc::WG, tc::SMEM,
                            stream>>>(m1, m3, gu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Params dn{h, nullptr, off, o, E, F, D, (D + 255) / 256};
  tc::moe_grouped_down<<<tiles * dn.col_tiles, 128 * tc::WG, tc::SMEM,
                         stream>>>(m2, dn);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const int64_t* src, const int* off,
                       const void* w1, const void* w3, const void* w2,
                       void* h, void* o, int N, int D, int F, int E,
                       cudaStream_t stream) {
  const int tiles = row_tiles(N, E, simt::BM);
  const Params gu{x, src, off, h, E, D, F, (F + simt::BN - 1) / simt::BN};
  simt::moe_grouped_gate_up<<<tiles * gu.col_tiles, simt::NT, 0, stream>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w3), gu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Params dn{h, nullptr, off, o, E, F, D, (D + simt::BN - 1) / simt::BN};
  simt::moe_grouped_down<<<tiles * dn.col_tiles, simt::NT, 0, stream>>>(
      static_cast<const float*>(w2), dn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [T, D]; src [N] int64, the token of each row; off [E + 1] int32 on the
// device, the groups' first rows; w1, w3 [E, D, F], w2 [E, F, D]; h [N, F]
// scratch and o [N, D] out, rows from off[E] on not written. dtype: 0 =
// float32, 1 = bfloat16; every tensor contiguous, D and F multiples of 64
// (the wrapper checks). Launches the two kernels on ``stream``; returns a
// cudaError_t.
int moe_grouped_ffn(const void* x, const void* src, const void* off,
                    const void* w1, const void* w3, const void* w2, void* h,
                    void* o, int dtype, int N, int D, int F, int E,
                    void* stream) {
  if (N < 0 || E <= 0 || D <= 0 || F <= 0 || D % 64 || F % 64)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* s = static_cast<const int64_t*>(src);
  const int* g = static_cast<const int*>(off);
  cudaError_t err;
  if (dtype == 0) err = launch_f32(x, s, g, w1, w3, w2, h, o, N, D, F, E, st);
  else if (dtype == 1)
    err = launch_bf16(x, s, g, w1, w3, w2, h, o, N, D, F, E, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* moe_grouped_ffn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
