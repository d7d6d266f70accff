// Grouped expert GEMM for Hopper (sm_90a): (E,C,d) x (E,d,f) -> (E,C,f).
//
// Replaces the TPU kernel
//   src/repro/kernels/moe_gmm/kernel.py:moe_gmm_kernel (body _gmm_kernel).
// Same contract: per expert e, out[e] = x[e] @ w[e], accumulated in f32 over
// d, written in x's dtype; f32 or bf16 inputs.
//
// What bounds it on this card.  The model's expert FFN (moe_dense) runs it
// three times per MoE layer on every token for every expert.  In prefill
// (dbrx-132b, E 16, d 6144, f 10752, B 2 x S 256: C 512, bf16) each call
// does 1.08 TFLOP on 2.1 GB of weights: bound by operations, 1.1 ms at the
// bf16 tensor-core rate (989 TFLOP/s), which only wgmma reaches.  In decode
// (C = 4 slots) the same weights carry 0.5 GFLOP: bound by bytes, 0.63 ms
// at 3.35 TB/s.
//
// Four variants, one function; the wrapper picks by dtype, C and layout
// (ops.gmm_variant) and the entry point checks that the layout fits:
//  * wgmma (bf16, C >= 64, TMA-addressable operands: 16-byte-aligned x
//    rows and w, f % 8 == 0): the prefill design.  Persistent blocks, one
//    per SM, walk the output tiles of 128 (C) x 256 (f) with the M tiles
//    of one (expert, f tile) next to each other, so the blocks that share
//    a w strip run together and read it from HBM about once (the raster
//    order of the previous kernel sent them 84 tiles apart).  In each
//    block one producer thread keeps a ring of 4 stages of 64-deep d
//    slices full with TMA loads (x 128 x 64, w 64 x 256 as four 64-column
//    boxes, 128-byte swizzle, 48 KB a stage), completing on mbarriers; two
//    consumer warpgroups each issue wgmma m64n256k16 on 64 rows, x K-major
//    and w MN-major as it lies (no copy of w), f32 accumulators in
//    registers (setmaxnreg moves the producer's registers to them), one
//    wgmma group kept in flight while the slice before it is handed back.
//    A tile's epilogue (bf16 stores from registers, ragged rows and
//    columns dropped) overlaps the loads of the next tile.  Ragged C, d
//    and f: TMA fills zeros past every edge.  x's expert stride may be 0
//    (moe_dense passes the tokens expanded over experts, 403 MB at dbrx
//    B 4 x S 512 if materialized): TMA takes no zero stride, so x is then
//    described as the one (C, d) matrix it is.
//  * wgmma_swap (bf16, C < 64, the same layouts): decode, bound by the
//    weight stream.  out^T = w^T x^T: f fills wgmma's 64 rows (w is the
//    MN-major A operand, as it lies) and the C tokens, padded to 8, 16, 32
//    or 64, its columns, so no 64-row tile is spent on 4 tokens.  The same
//    persistent producer / two-consumer structure streams w in 128 (f) x
//    64 (d) slices through an 8-stage ring (136-192 KB in flight an SM).
//  * mma_sync (bf16 rows TMA cannot address): mma.sync m16n8k16 on
//    fragments read with ldmatrix from a 3-stage ring that 16-byte
//    cp.async copies fill where aligned (masked loads elsewhere), 64 x 128
//    tiles: the previous kernel, kept for those layouts.
//  * f32 (parity runs): full f32 on the CUDA cores -- no TF32, which keeps
//    ~3 decimal digits and would break the 2e-5 tolerance.
//
// Translation from the TPU kernel.  The TPU grid (E, C/bc, f/bf, d/bd) ran
// its last dimension in order, with the accumulator in VMEM scratch; here a
// block owns (C, f) tiles of one expert and loops over d itself, with the
// accumulator in registers.
//
// Traps handled here:
//  * x may have any row stride and an expert stride of 0; its last
//    dimension has unit stride.
//  * C, d and f need not divide the tiles: every edge is masked (TMA zero
//    fill; masked loads and stores in the other variants).  The TPU
//    kernel's divisibility asserts do not carry over.
#include "../../hopper.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ---- f32: CUDA cores ------------------------------------------------------
constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int C, int D, int F, long long sxe,
               long long sxc) {
  __shared__ __align__(16) float sA[F_BK][F_BM + 4];  // x tile, transposed
  __shared__ __align__(16) float sB[F_BK][F_BN + 4];  // w tile
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  const float* xe = x + e * sxe;
  const float* we = w + (size_t)e * D * F;
  float* oe = out + (size_t)e * C * F;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += F_BK) {
    for (int idx = tid; idx < F_BM * F_BK; idx += F_THREADS) {
      const int r = idx / F_BK, kk = idx % F_BK;
      const int m = m0 + r, k = k0 + kk;
      sA[kk][r] = (m < C && k < D) ? xe[m * sxc + k] : 0.f;
    }
    for (int idx = tid; idx < F_BK * F_BN; idx += F_THREADS) {
      const int kk = idx / F_BN, cc = idx % F_BN;
      const int k = k0 + kk, n = n0 + cc;
      sB[kk][cc] = (k < D && n < F) ? we[(size_t)k * F + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sA[kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&sB[kk][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < F) oe[(size_t)m * F + n] = acc[i][j];
    }
  }
}

// ---- bf16, rows TMA cannot address: mma.sync m16n8k16 from cp.async ----
constexpr int H_BM = 64, H_BN = 128, H_BK = 32, H_THREADS = 256;
constexpr int STAGES = 3;      // tiles in flight: the ring in shared memory
constexpr int LDA = H_BK + 8;  // bf16 per row of the x tile: 80 bytes, so
                               // eight ldmatrix rows hit distinct banks
constexpr int LDB = H_BN + 8;  // bf16 per row of the w tile: 272 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8x8 b16 matrices: the A fragment of m16n8k16 (rows of k-contiguous x)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, transposed: two B fragments from rows of n-contiguous w
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Tiles {
  __nv_bfloat16 a[STAGES][H_BM][LDA];  // x tiles [m][k]
  __nv_bfloat16 b[STAGES][H_BK][LDB];  // w tiles [k][n]
};

// Stage the (k0..k0+31) slices of x and w: 16-byte cp.async copies where a
// run of eight values is in bounds and aligned, plain masked loads (zeros
// past the edges) elsewhere.  Both complete before the barrier that
// precedes the stage's first read.
__device__ __forceinline__ void load_tiles(
    Tiles& t, int stage, int k0, const __nv_bfloat16* xe,
    const __nv_bfloat16* we, int m0, int n0, int C, int D, int F,
    long long sxc, int vec_x, int vec_w, int tid) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  {  // x tile: 64 x 32, eight values a thread
    const int r = tid / 4, kc = (tid % 4) * 8;
    const int m = m0 + r, k = k0 + kc;
    __nv_bfloat16* dst = &t.a[stage][r][kc];
    if (vec_x && m < C && k + 8 <= D) {
      cp_async16(dst, xe + m * sxc + k);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        dst[u] = (m < C && k + u < D) ? xe[m * sxc + k + u] : zero;
    }
  }
#pragma unroll
  for (int it = 0; it < 2; ++it) {  // w tile: 32 x 128, sixteen a thread
    const int idx = tid + it * H_THREADS;
    const int kr = idx / 16, nc = (idx % 16) * 8;
    const int k = k0 + kr, n = n0 + nc;
    __nv_bfloat16* dst = &t.b[stage][kr][nc];
    if (vec_w && k < D && n + 8 <= F) {
      cp_async16(dst, we + (size_t)k * F + n);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        dst[u] = (k < D && n + u < F) ? we[(size_t)k * F + n + u] : zero;
    }
  }
}

// 8 warps as 2 (rows) x 4 (columns); each warp owns a 32 x 32 output tile:
// 2 x 4 fragments of 16 x 8.  The d loop runs over a ring of STAGES tiles:
// while the warps compute on one, the copies of the next two are in flight.
__global__ void __launch_bounds__(H_THREADS)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ out, int C, int D, int F,
                long long sxe, long long sxc, int vec_x, int vec_w) {
  __shared__ __align__(128) Tiles t;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * H_BM, n0 = blockIdx.x * H_BN;
  const __nv_bfloat16* xe = x + e * sxe;
  const __nv_bfloat16* we = w + (size_t)e * D * F;
  __nv_bfloat16* oe = out + (size_t)e * C * F;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
  const int g = lane >> 2, q = lane & 3;  // fragment group, thread-in-group

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  const int nk = (D + H_BK - 1) / H_BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_tiles(t, s, s * H_BK, xe, we, m0, n0, C, D, F, sxc, vec_x, vec_w, tid);
    cp_async_commit();  // one group a stage, empty or not: the count stays fixed
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt landed
    __syncthreads();  // everyone's landed, and tile kt-1's stage is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_tiles(t, nxt % STAGES, nxt * H_BK, xe, we, m0, n0, C, D, F, sxc,
                 vec_x, vec_w, tid);
    cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int ks = 0; ks < H_BK; ks += 16) {
      uint32_t af[2][4], bfr[4][2];
      // lane l addresses row l % 16 of the fragment, at k offset 8 (l / 16)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], &t.a[st][wm + mi * 16 + (lane % 16)][ks + (lane / 16) * 8]);
      // lane l addresses k row l % 16, at n offset 8 (l / 16): two fragments
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &t.b[st][ks + (lane % 16)][wn + np * 16 + (lane / 16) * 8]);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + 8 * half;
        if (row >= C) continue;
        if (col < F) oe[(size_t)row * F + col] = __float2bfloat16(acc[mi][ni][2 * half]);
        if (col + 1 < F) oe[(size_t)row * F + col + 1] = __float2bfloat16(acc[mi][ni][2 * half + 1]);
      }
    }
  }
}


// ---- bf16: wgmma from a TMA ring, persistent -----------------------------
constexpr int W_BM = 128, W_BN = 256, W_BK = 64, W_STAGES = 4;
constexpr int W_THREADS = 384;  // producer warpgroup + two consumers
constexpr int W_CONSUMER_WARPS = 8;
constexpr int W_A_BYTES = W_BM * W_BK * 2;  // x slice: 128 rows x 128 bytes
constexpr int W_B_SUB = W_BK * 64 * 2;      // w box: 64 d rows x 64 f
constexpr int W_STAGE_BYTES = W_A_BYTES + 4 * W_B_SUB;  // 48 KB
constexpr size_t W_SMEM =
    1024 + (size_t)W_STAGES * W_STAGE_BYTES + 2 * W_STAGES * sizeof(uint64_t);

__global__ void __launch_bounds__(W_THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                 const __grid_constant__ CUtensorMap tmw,
                 __nv_bfloat16* __restrict__ out, int E, int C, int D, int F,
                 int x_per_expert) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W_STAGES * W_STAGE_BYTES);
  uint64_t* empty = full + W_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);                  // the producer's expect_tx
      mbar_init(&empty[s], W_CONSUMER_WARPS);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int mt = (C + W_BM - 1) / W_BM, nt = (F + W_BN - 1) / W_BN;
  const int tiles = mt * nt * E;
  const int nk = (D + W_BK - 1) / W_BK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // producer: one thread issues every load
    regs_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m = t % mt, n = (t / mt) % nt, e = t / (mt * nt);
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // first round passes
          mbar_expect_tx(&full[stage], W_STAGE_BYTES);
          uint8_t* a = smem + stage * W_STAGE_BYTES;
          uint8_t* b = a + W_A_BYTES;
          if (x_per_expert)
            tma_load_3d(a, &tmx, &full[stage], kt * W_BK, m * W_BM, e);
          else
            tma_load_2d(a, &tmx, &full[stage], kt * W_BK, m * W_BM);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load_3d(b + j * W_B_SUB, &tmw, &full[stage],
                        n * W_BN + 64 * j, kt * W_BK, e);
          if (++stage == W_STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {  // consumers: warpgroup 1 rows 0-63, warpgroup 2 rows 64-127
    regs_inc<232>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m = t % mt, n = (t / mt) % nt, e = t / (mt * nt);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint8_t* a = smem + stage * W_STAGE_BYTES + cw * 64 * 128;
        const uint8_t* b = smem + stage * W_STAGE_BYTES + W_A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < W_BK / 16; ++ks)
          wgmma_m64n256k16_ss_k_mn(acc, desc_sw128(a + 32 * ks, 16, 1024),
                                 desc_sw128(b + 2048 * ks, W_B_SUB, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the slice before this one is read: hand it back
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == W_STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_regs<128>(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // acc[4j + 2r + c]: row 16 warp + lane / 4 + 8 r, column 8 j +
      // 2 (lane % 4) + c of this warpgroup's 64 x 256
      __nv_bfloat16* oe = out + (size_t)e * C * F;
      const int row0 = m * W_BM + cw * 64 + warp * 16 + lane / 4;
      const int col0 = n * W_BN + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = col0 + 8 * j;
        if (col >= F) continue;  // F % 8 == 0: both columns or neither
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row < C)
            *reinterpret_cast<__nv_bfloat162*>(&oe[(size_t)row * F + col]) =
                __floats2bfloat162_rn(acc[4 * j + 2 * r],
                                      acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// ---- bf16, C < 64: swap-AB wgmma from a TMA ring, persistent -------------
// out[e]^T = w[e]^T x[e]^T: f fills wgmma's 64 rows (w, MN-major as it
// lies, is the A operand) and the C tokens, padded to N of 8-64, its
// columns (x, K-major, the B operand), so the weight stream, not a mostly
// empty 64-row tile, sets the pace.
constexpr int S_BM = 128, S_BK = 64, S_STAGES = 8;
constexpr int S_A_SUB = S_BK * 64 * 2;  // w box: 64 d rows x 64 f

template <int N>
struct SwapTile {
  static constexpr int STAGE = 2 * S_A_SUB + N * 128;  // w, then x
  static constexpr size_t SMEM =
      1024 + (size_t)S_STAGES * STAGE + 2 * S_STAGES * sizeof(uint64_t);
};

template <int N>
__device__ __forceinline__ void wgmma_swap(float* acc, uint64_t a,
                                           uint64_t b) {
  using namespace hopper;
  if constexpr (N == 8) wgmma_m64n8k16_ss_mn_k(acc, a, b, 1);
  else if constexpr (N == 16) wgmma_m64n16k16_ss_mn_k(acc, a, b, 1);
  else if constexpr (N == 32) wgmma_m64n32k16_ss_mn_k(acc, a, b, 1);
  else wgmma_m64n64k16_ss_mn_k(acc, a, b, 1);
}

template <int N>
__global__ void __launch_bounds__(W_THREADS, 1)
gmm_swap_kernel(const __grid_constant__ CUtensorMap tmx,
                const __grid_constant__ CUtensorMap tmw,
                __nv_bfloat16* __restrict__ out, int E, int C, int D, int F,
                int x_per_expert) {
  using namespace hopper;
  using ST = SwapTile<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S_STAGES * ST::STAGE);
  uint64_t* empty = full + S_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int nt = (F + S_BM - 1) / S_BM;
  const int tiles = nt * E;
  const int nk = (D + S_BK - 1) / S_BK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // producer: one thread issues every load
    regs_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n = t % nt, e = t / nt;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], ST::STAGE);
          uint8_t* a = smem + stage * ST::STAGE;
          uint8_t* b = a + 2 * S_A_SUB;
          tma_load_3d(a, &tmw, &full[stage], n * S_BM, kt * S_BK, e);
          tma_load_3d(a + S_A_SUB, &tmw, &full[stage], n * S_BM + 64,
                      kt * S_BK, e);
          if (x_per_expert)
            tma_load_3d(b, &tmx, &full[stage], kt * S_BK, 0, e);
          else
            tma_load_2d(b, &tmx, &full[stage], kt * S_BK, 0);
          if (++stage == S_STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {  // consumers: warpgroup 1 f 0-63 of the tile, warpgroup 2 f 64-127
    regs_inc<232>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float acc[N / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n = t % nt, e = t / nt;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint8_t* a = smem + stage * ST::STAGE + cw * S_A_SUB;
        const uint8_t* b = smem + stage * ST::STAGE + 2 * S_A_SUB;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < S_BK / 16; ++ks)
          wgmma_swap<N>(acc, desc_sw128(a + 2048 * ks, S_A_SUB, 1024),
                        desc_sw128(b + 32 * ks, 16, 1024));
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == S_STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_regs<N / 2>(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // acc[4j + 2r + c]: f row 16 warp + lane / 4 + 8 r of this
      // warpgroup's 64, token 8 j + 2 (lane % 4) + c
      __nv_bfloat16* oe = out + (size_t)e * C * F;
      const int f0 = n * S_BM + cw * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int f = f0 + 8 * r, token = 8 * j + 2 * (lane % 4) + c;
            if (f < F && token < C)
              oe[(size_t)token * F + f] = __float2bfloat16(acc[4 * j + 2 * r + c]);
          }
        }
      }
    }
  }
}

// the tensor maps of x and w (both variants): x over (C, d), or (E, C, d)
// where it has an expert stride; w over (E, d, f) in 64-column boxes
int encode_operands(CUtensorMap* tmx, CUtensorMap* tmw, const void* x,
                    const void* w, int E, int C, int D, int F, long long sxe,
                    long long sxc, int x_rows, int w_rows) {
  const cuuint64_t xdims[3] = {(cuuint64_t)D, (cuuint64_t)C, (cuuint64_t)E};
  const cuuint64_t xstrides[2] = {(cuuint64_t)sxc * 2, (cuuint64_t)sxe * 2};
  const cuuint32_t xbox[3] = {64, (cuuint32_t)x_rows, 1};
  int err = hopper::encode_bf16(tmx, x, sxe ? 3 : 2, xdims, xstrides, xbox);
  if (err) return err;
  const cuuint64_t wdims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
  const cuuint64_t wstrides[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)w_rows, 1};
  return hopper::encode_bf16(tmw, w, 3, wdims, wstrides, wbox);
}

template <int N>
int launch_swap(const CUtensorMap& tmx, const CUtensorMap& tmw, void* out,
                int E, int C, int D, int F, int x_per_expert,
                cudaStream_t stream) {
  constexpr size_t smem = SwapTile<N>::SMEM;
  auto kernel = gmm_swap_kernel<N>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int tiles = (F + S_BM - 1) / S_BM * E;
  const int grid = tiles < hopper::sm_count() ? tiles : hopper::sm_count();
  kernel<<<grid, W_THREADS, smem, stream>>>(
      tmx, tmw, static_cast<__nv_bfloat16*>(out), E, C, D, F, x_per_expert);
  return (int)cudaGetLastError();
}

// both wgmma variants: C >= 64 the 128 x 256 tiles, C < 64 swap-AB
int launch_wgmma(const void* x, const void* w, void* out, int E, int C,
                 int D, int F, long long sxe, long long sxc,
                 cudaStream_t stream) {
  // the layout the wrapper's choice promises; refuse anything else
  if (F % 8 || sxc % 8 || sxe % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const int x_per_expert = sxe != 0;
  CUtensorMap tmx, tmw;
  if (C < 64) {
    const int n = C <= 8 ? 8 : C <= 16 ? 16 : C <= 32 ? 32 : 64;
    int err = encode_operands(&tmx, &tmw, x, w, E, C, D, F, sxe, sxc, n,
                              S_BK);
    if (err) return err;
    switch (n) {
      case 8: return launch_swap<8>(tmx, tmw, out, E, C, D, F, x_per_expert, stream);
      case 16: return launch_swap<16>(tmx, tmw, out, E, C, D, F, x_per_expert, stream);
      case 32: return launch_swap<32>(tmx, tmw, out, E, C, D, F, x_per_expert, stream);
      default: return launch_swap<64>(tmx, tmw, out, E, C, D, F, x_per_expert, stream);
    }
  }
  int err = encode_operands(&tmx, &tmw, x, w, E, C, D, F, sxe, sxc, W_BM,
                            W_BK);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(gmm_wgmma_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)W_SMEM);
  if (err) return err;
  const long long tiles = (long long)((C + W_BM - 1) / W_BM) *
                          ((F + W_BN - 1) / W_BN) * E;
  const int grid = (int)(tiles < hopper::sm_count() ? tiles
                                                    : hopper::sm_count());
  gmm_wgmma_kernel<<<grid, W_THREADS, W_SMEM, stream>>>(
      tmx, tmw, static_cast<__nv_bfloat16*>(out), E, C, D, F, x_per_expert);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, w and out): 0 = f32, 1 = bf16; variant (bf16 only): 0 =
// mma.sync, 1 = wgmma, its tiles or swap-AB by C (see the note above).  x: (E,C,D) with strides (sxe,
// sxc, 1) in elements, sxe may be 0; w: (E,D,F) contiguous; out: (E,C,F)
// contiguous.  Returns the launch's cudaGetLastError() (0 on success),
// or the error that kept it from launching; does not synchronise.
extern "C" int moe_gmm(const void* x, const void* w, void* out, int E, int C,
                       int D, int F, long long sxe, long long sxc, int dtype,
                       int variant, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || sxe < 0 || sxc < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && variant == 0) {
    const dim3 grid((F + F_BN - 1) / F_BN, (C + F_BM - 1) / F_BM, E);
    gmm_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), C, D, F, sxe, sxc);
    return (int)cudaGetLastError();
  }
  if (dtype == 1 && variant == 1)
    return launch_wgmma(x, w, out, E, C, D, F, sxe, sxc, s);
  if (dtype == 1 && variant == 0) {
    // 16-byte loads where every row start they touch is 16-byte aligned
    const int vec_x = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                      sxe % 8 == 0 && sxc % 8 == 0;
    const int vec_w = (reinterpret_cast<uintptr_t>(w) % 16 == 0) && F % 8 == 0;
    const dim3 grid((F + H_BN - 1) / H_BN, (C + H_BM - 1) / H_BM, E);
    gmm_bf16_kernel<<<grid, H_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), C, D, F, sxe, sxc, vec_x, vec_w);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
