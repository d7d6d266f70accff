// Grouped expert GEMM, backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the Pallas kernel
//   src/repro/kernels/moe_gmm/kernel.py:moe_gmm_kernel
// is forward-only, and the JAX trainer differentiates the jnp einsum.  The
// port runs its forward (csrc/moe_gmm.cu, K5) on the training path, so its
// gradient needs a kernel of its own.  For out_e = x_e w_e, given dy_e:
//   dx_e = dy_e w_e^T       (C, f) x (f, d): w read transposed in place
//   dw_e = x_e^T dy_e       (d, C) x (C, f): x read transposed in place
// f32 or bf16 in and out, accumulated in f32.  Where x is the tokens that
// every expert reads (moe_dense: an expert stride of 0), dx is their one
// (T, d) gradient, sum_e dy_e w_e^T: a single (T, E f) x (E f, d) product
// with the experts in its K loop, never E partial outputs summed after.
//
// What bounds it on this card.  At dbrx-132b's training microbatch (E 16,
// T 512, d 6144, f 10752, bf16) each of the two products does 1.08 TFLOP
// (2 E T d f) on 2.3 GB of operands: bound by operations, 1.1 ms each at
// the bf16 tensor-core rate (989 TFLOP/s), which only wgmma reaches.  An
// expert-parallel rank's (8, 160, 6144, 10752) moves more bytes than it
// computes: w read once by dx and dw written once, 1.06 GB each.
//
// Three variants, one entry point; the wrapper picks by dtype and layout
// (ops.gmm_bwd_variant) and the entry point refuses a layout that does not
// fit the variant it is handed:
//  * wgmma (bf16, TMA-addressable operands: 16-byte-aligned bases, x's
//    row and expert strides, d and f multiples of 8): K5's prefill design
//    (csrc/moe_gmm.cu) for both products.  Persistent blocks, one per SM;
//    one producer thread keeps a ring of 4 stages of 64-deep slices full
//    with TMA loads (128-byte swizzle, 48 KB a stage) completing on
//    mbarriers; two consumer warpgroups issue wgmma m64n256k16 on 64 rows
//    each of a 128 x 256 tile, f32 accumulators in registers (setmaxnreg
//    gives them the producer's), and a tile's epilogue overlaps the next
//    tile's loads.
//    - dx: A = dy, K-major, a 3-D map (f, C, E); B = w_e as it lies, rows
//      d contiguous along f: a K-major B operand, no copy.  The expanded
//      dx is 96 tiles of (512, 6144) at dbrx's step, for 132 SMs, each
//      with a K loop of E f = 172,032: the (expert, k-slice) walk is split
//      into parts (ops.gmm_bwd_split: 4 at that shape, 384 work units), a
//      part's f32 tile goes to a scratch buffer in the consumers' register
//      order (coalesced), and the last part of a tile to arrive, counted
//      by an integer atomic on a per-tile counter that it resets for the
//      next call, sums the parts in the fixed order 0 .. S-1 and writes
//      the bf16 tile: two calls give the same bits, no float atomics.
//      Ragged C (an EP rank's 160 rows): a last tile of at most 64 rows
//      loads its rows once and each warpgroup takes 128 of its 256 columns
//      (m64n128), so it costs half a tile, not a second full one.
//    - dw: A = x^T, MN-major, and B = dy, MN-major: x's and dy's (C, d)
//      and (C, f) boxes taken as they lie with wgmma's transpose bits.
//      Expanded x (expert stride 0) is described as the one (C, d) matrix
//      it is: TMA takes no zero stride.  K = C is short (512, 160 at EP:
//      3 slices, the last half TMA's zeros), so dw has many tiles and a
//      large output (2.1 GB at dbrx): each tile goes to 128-byte-swizzled
//      shared memory and one thread TMA-stores it while the warpgroup
//      starts the next tile (a ring of 3 stages leaves room for it).
//  * mma_sync (bf16 rows TMA cannot address, e.g. d 100): the previous
//    design, kept for those layouts.  One strided product serves both
//    gradients: mma.sync m16n8k16 on 64 x 128 tiles, 8 warps of 32 x 32,
//    a 3-stage ring of 32-deep slices that 16-byte cp.async copies fill
//    where the rows are aligned (masked loads elsewhere, zeros past every
//    edge); ldmatrix reads the fragments, transposed (.trans) for the
//    operand whose contiguous dimension is M or N.
//  * f32 (parity runs): full f32 on the CUDA cores, 64 x 64 tiles, no TF32.
//  Every output element is summed in a fixed order: two runs give the
//  same bits.
#include "../../hopper.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// A_e[m][k] = a[e * sae + m * sam + k * sak], B_e[k][n] likewise; out[z]
// row-major (M, N) at out + z * M * N
struct Operands {
  const void* a;
  const void* b;
  void* out;
  int M, N, K;
  long long sae, sam, sak, sbe, sbk, sbn;
  int experts;  // experts summed into one output (1: grid z is the expert)
};

// ---- f32: CUDA cores ------------------------------------------------------
constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
gemm_f32_kernel(Operands o) {
  __shared__ __align__(16) float sA[F_BK][F_BM + 4];
  __shared__ __align__(16) float sB[F_BK][F_BN + 4];
  const float* a = static_cast<const float*>(o.a);
  const float* b = static_cast<const float*>(o.b);
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int e_begin = o.experts == 1 ? z : 0;
  const int e_end = o.experts == 1 ? z + 1 : o.experts;
  for (int e = e_begin; e < e_end; ++e) {
    const float* ae = a + e * o.sae;
    const float* be = b + e * o.sbe;
    for (int k0 = 0; k0 < o.K; k0 += F_BK) {
      for (int idx = tid; idx < F_BM * F_BK; idx += F_THREADS) {
        // consecutive threads along A's stride-1 dimension where it is M
        const int r = o.sam == 1 ? idx % F_BM : idx / F_BK;
        const int kk = o.sam == 1 ? idx / F_BM : idx % F_BK;
        const int m = m0 + r, k = k0 + kk;
        sA[kk][r] = (m < o.M && k < o.K) ? ae[m * o.sam + k * o.sak] : 0.f;
      }
      for (int idx = tid; idx < F_BK * F_BN; idx += F_THREADS) {
        const int cc = o.sbn == 1 ? idx % F_BN : idx / F_BK;
        const int kk = o.sbn == 1 ? idx / F_BN : idx % F_BK;
        const int k = k0 + kk, n = n0 + cc;
        sB[kk][cc] = (k < o.K && n < o.N) ? be[k * o.sbk + n * o.sbn] : 0.f;
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
  }
  float* out = static_cast<float*>(o.out) + (size_t)z * o.M * o.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= o.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < o.N) out[(size_t)m * o.N + n] = acc[i][j];
    }
  }
}

// ---- bf16: mma.sync m16n8k16 from a cp.async ring --------------------------
constexpr int BM = 64, BN = 128, BK = 32, THREADS = 256, STAGES = 3;

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
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
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

// Shared tiles.  AK: A's contiguous dimension is K, the tile kept [m][k]
// (else [k][m]); BK_: B's is K, kept [n][k] (else [k][n]).  Rows padded by
// 16 bytes, so that the eight rows an ldmatrix reads hit distinct banks.
template <bool AK, bool BK_>
struct Tiles {
  static constexpr int A_ROWS = AK ? BM : BK, A_LD = AK ? BK + 8 : BM + 8;
  static constexpr int B_ROWS = BK_ ? BN : BK, B_LD = BK_ ? BK + 8 : BN + 8;
  __nv_bfloat16 a[STAGES][A_ROWS][A_LD];
  __nv_bfloat16 b[STAGES][B_ROWS][B_LD];
};

// one run of 8 values along a tile row: a 16-byte copy where the whole run
// is in bounds and aligned, masked loads (zeros past the edges) elsewhere
__device__ __forceinline__ void load8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, long long step,
                                      bool row_ok, int valid, bool vec) {
  if (row_ok && vec && valid >= 8) {
    cp_async16(dst, src);
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int u = 0; u < 8; ++u)
    dst[u] = (row_ok && u < valid) ? src[u * step] : zero;
}

template <bool AK, bool BK_>
__device__ __forceinline__ void load_stage(Tiles<AK, BK_>& t, int stage,
                                           const Operands& o, int e, int k0,
                                           int m0, int n0, bool vec_a,
                                           bool vec_b) {
  const __nv_bfloat16* a =
      static_cast<const __nv_bfloat16*>(o.a) + e * o.sae;
  const __nv_bfloat16* b =
      static_cast<const __nv_bfloat16*>(o.b) + e * o.sbe;
  const int tid = threadIdx.x;
  if constexpr (AK) {  // 64 rows of m x 32 k: one run a thread
    const int r = tid / 4, kc = (tid % 4) * 8;
    const int m = m0 + r, k = k0 + kc;
    load8(&t.a[stage][r][kc], a + (long long)m * o.sam + (long long)k * o.sak,
          o.sak, m < o.M, o.K - k, vec_a);
  } else {   // 32 rows of k x 64 m
    const int r = tid / 8, mc = (tid % 8) * 8;
    const int k = k0 + r, m = m0 + mc;
    load8(&t.a[stage][r][mc], a + (long long)k * o.sak + (long long)m * o.sam,
          o.sam, k < o.K, o.M - m, vec_a);
  }
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int idx = tid + it * THREADS;
    if constexpr (BK_) {  // 128 rows of n x 32 k
      const int r = idx / 4, kc = (idx % 4) * 8;
      const int n = n0 + r, k = k0 + kc;
      load8(&t.b[stage][r][kc],
            b + (long long)n * o.sbn + (long long)k * o.sbk, o.sbk, n < o.N,
            o.K - k, vec_b);
    } else {    // 32 rows of k x 128 n
      const int r = idx / 16, nc = (idx % 16) * 8;
      const int k = k0 + r, n = n0 + nc;
      load8(&t.b[stage][r][nc],
            b + (long long)k * o.sbk + (long long)n * o.sbn, o.sbn, k < o.K,
            o.N - n, vec_b);
    }
  }
}

// 8 warps as 2 (rows) x 4 (columns), each 32 x 32 outputs: 2 x 4 fragments
template <bool AK, bool BK_>
__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(Operands o, int vec_a, int vec_b) {
  __shared__ __align__(128) Tiles<AK, BK_> t;
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
  const int g = lane >> 2, q = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  // the K loop over (expert, k-tile) pairs
  const int nk = (o.K + BK - 1) / BK;
  const int e0 = o.experts == 1 ? z : 0;
  const int steps = (o.experts == 1 ? 1 : o.experts) * nk;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      load_stage(t, s, o, e0 + s / nk, (s % nk) * BK, m0, n0, vec_a, vec_b);
    cp_async_commit();  // one group a stage, empty or not
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed for all, tile kt-1's stage is free
    const int nxt = kt + STAGES - 1;
    if (nxt < steps)
      load_stage(t, nxt % STAGES, o, e0 + nxt / nk, (nxt % nk) * BK, m0, n0,
                 vec_a, vec_b);
    cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if constexpr (AK)  // lane l: row l % 16, k offset 8 (l / 16)
          ldmatrix_x4(af[mi], &t.a[st][wm + mi * 16 + (lane % 16)]
                                      [ks + (lane / 16) * 8]);
        else     // lane l: k row (l % 8) + 8 (l / 16), m offset 8 ((l / 8) % 2)
          ldmatrix_x4_trans(af[mi], &t.a[st][ks + (lane % 8) + 8 * (lane / 16)]
                                            [wm + mi * 16 + 8 * ((lane / 8) % 2)]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        if constexpr (BK_)  // lane l: n row (l % 8) + 8 (l / 16), k offset 8 ((l / 8) % 2)
          ldmatrix_x4(r, &t.b[st][wn + np * 16 + (lane % 8) + 8 * (lane / 16)]
                                 [ks + 8 * ((lane / 8) % 2)]);
        else      // lane l: k row l % 16, n offset 8 (l / 16)
          ldmatrix_x4_trans(r, &t.b[st][ks + (lane % 16)]
                                       [wn + np * 16 + (lane / 16) * 8]);
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
  __nv_bfloat16* out =
      static_cast<__nv_bfloat16*>(o.out) + (size_t)z * o.M * o.N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + 8 * half;
        if (row >= o.M) continue;
        if (col < o.N)
          out[(size_t)row * o.N + col] =
              __float2bfloat16(acc[mi][ni][2 * half]);
        if (col + 1 < o.N)
          out[(size_t)row * o.N + col + 1] =
              __float2bfloat16(acc[mi][ni][2 * half + 1]);
      }
    }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16-byte copies of runs along the operand's contiguous dimension: unit
// stride there, the base, the expert stride and the other stride multiples
// of 16 bytes
bool vec_ok(const void* p, long long unit, long long other, long long se) {
  return aligned16(p) && unit == 1 && other % 8 == 0 && se % 8 == 0;
}

template <bool AK, bool BK_>
cudaError_t run_bf16(const Operands& o, int blocks_z, cudaStream_t st) {
  const bool va = AK ? vec_ok(o.a, o.sak, o.sam, o.sae)
                     : vec_ok(o.a, o.sam, o.sak, o.sae);
  const bool vb = BK_ ? vec_ok(o.b, o.sbk, o.sbn, o.sbe)
                      : vec_ok(o.b, o.sbn, o.sbk, o.sbe);
  const dim3 grid((o.N + BN - 1) / BN, (o.M + BM - 1) / BM, blocks_z);
  gemm_bf16_kernel<AK, BK_><<<grid, THREADS, 0, st>>>(o, va ? 1 : 0,
                                                      vb ? 1 : 0);
  return cudaGetLastError();
}

cudaError_t run(const Operands& o, int blocks_z, int dtype, bool a_k,
                cudaStream_t st) {
  if (blocks_z > 65535 || (o.M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    const dim3 grid((o.N + F_BN - 1) / F_BN, (o.M + F_BM - 1) / F_BM,
                    blocks_z);
    gemm_f32_kernel<<<grid, F_THREADS, 0, st>>>(o);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  // dx: A = dy (K contiguous), B = w^T (K contiguous); dw: A = x^T (M
  // contiguous), B = dy (N contiguous)
  return a_k ? run_bf16<true, true>(o, blocks_z, st)
             : run_bf16<false, false>(o, blocks_z, st);
}


// ---- bf16: wgmma from a TMA ring, persistent ------------------------------
constexpr int W_BM = 128, W_BN = 256, W_BK = 64;
constexpr int W_THREADS = 384;  // producer warpgroup + two consumers
constexpr int W_CONSUMERS = 256;
constexpr int W_CONSUMER_WARPS = 8;
constexpr int W_A_BYTES = W_BM * W_BK * 2;              // 128 rows x 128 B
constexpr int W_BOX = 64 * 64 * 2;                      // a 64 x 64 box
constexpr int W_STAGE_BYTES = W_A_BYTES + W_BN * W_BK * 2;  // 48 KB
constexpr int W_PART = W_CONSUMERS * 128;  // f32 of a split part's tile
constexpr int W_OUT_BYTES = W_BM * W_BN * 2;  // dw's bf16 tile, TMA-stored
// dx: a ring of 4 stages; dw: 3, and its output tile
template <bool DW>
struct WRing {
  static constexpr int STAGES = DW ? 3 : 4;
  static constexpr int OUT = STAGES * W_STAGE_BYTES;
  static constexpr int BARS = OUT + (DW ? W_OUT_BYTES : 0);
  static constexpr size_t SMEM = 1024 + (size_t)BARS +
                                 2 * STAGES * sizeof(uint64_t) + 16;
};

// One work unit: output tile (m, n) of slice z (dx: the expert, or 0 for
// the expanded sum; dw: the expert), part s of its K walk [kb, ke);
// ``half``: dx's last tile holds at most 64 rows
struct Unit {
  int m, n, z, s, kb, ke;
  bool half;
};

// The walk of both roles (producer and consumers take the same units).
// dx: rows C, columns d, the K walk (expert, f slice), split parts; dw:
// rows d, columns f, K = C.
template <bool DW>
__device__ __forceinline__ Unit unit_of(long long u, int mt, int nt,
                                        int split, int steps, int rows) {
  Unit t;
  t.m = (int)(u % mt);
  long long r = u / mt;
  t.s = (int)(r % split);
  r /= split;
  t.n = (int)(r % nt);
  t.z = (int)(r / nt);
  t.kb = (int)((long long)t.s * steps / split);
  t.ke = (int)((long long)(t.s + 1) * steps / split);
  t.half = !DW && rows - t.m * W_BM <= 64;
  return t;
}

// A unit's K loop on the consumers' side: MODE 0 dx (m64n256, K-major
// A and B), 1 dx's last tile of at most 64 rows (each warpgroup m64n128 on
// half of the columns), 2 dw (m64n256, MN-major A and B).  One wgmma group
// stays in flight while the slice before it is handed back.
template <int MODE, int STAGES>
__device__ __forceinline__ void mainloop(float* acc, uint8_t* smem,
                                         uint64_t* full, uint64_t* empty,
                                         int& stage, uint32_t& phase, int kb,
                                         int ke, int cw, int lane) {
  using namespace hopper;
  int prev = -1;
  for (int k = kb; k < ke; ++k) {
    mbar_wait(&full[stage], phase);
    const uint8_t* a = smem + stage * W_STAGE_BYTES;
    const uint8_t* b = a + W_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < W_BK / 16; ++ks) {
      if constexpr (MODE == 0)
        wgmma_m64n256k16_ss_k_k(
            acc, desc_sw128(a + cw * 64 * 128 + 32 * ks, 16, 1024),
            desc_sw128(b + 32 * ks, 16, 1024), 1);
      else if constexpr (MODE == 1)
        wgmma_m64n128k16_ss_k_k(
            acc, desc_sw128(a + 32 * ks, 16, 1024),
            desc_sw128(b + cw * 128 * 128 + 32 * ks, 16, 1024), 1);
      else
        wgmma_m64n256k16_ss_mn_mn(
            acc, desc_sw128(a + cw * W_BOX + 2048 * ks, W_BOX, 1024),
            desc_sw128(b + 2048 * ks, W_BOX, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the slice before this one is read: hand it back
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs<128>(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
}

// DW false: dx (A = dy, B = w, both K-major); true: dw (A = x^T, B = dy,
// both MN-major).  part / count: the split's f32 partial tiles and
// per-tile arrival counters (dx with split > 1 only).
template <bool DW>
__global__ void __launch_bounds__(W_THREADS, 1)
gmm_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tma,
                     const __grid_constant__ CUtensorMap tmb,
                     const __grid_constant__ CUtensorMap tmo,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                     int* __restrict__ count, int E, int C, int D, int F,
                     int expanded, int x_per_expert, int split) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  using Ring = WRing<DW>;
  constexpr int W_STAGES = Ring::STAGES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Ring::BARS);
  uint64_t* empty = full + W_STAGES;
  int* last_flag = reinterpret_cast<int*>(empty + W_STAGES);
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);                  // the producer's expect_tx
      mbar_init(&empty[s], W_CONSUMER_WARPS);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int rows = DW ? D : C, cols = DW ? F : D, depth = DW ? C : F;
  const int mt = (rows + W_BM - 1) / W_BM, nt = (cols + W_BN - 1) / W_BN;
  const int nk = (depth + W_BK - 1) / W_BK;  // slices of one expert
  const bool walk_experts = !DW && expanded;
  const int steps = walk_experts ? E * nk : nk;
  const int slices = walk_experts ? 1 : E;
  const long long units = (long long)mt * nt * slices * split;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // producer: one thread issues every load
    regs_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = unit_of<DW>(u, mt, nt, split, steps, rows);
        for (int k = t.kb; k < t.ke; ++k) {
          mbar_wait(&empty[stage], phase ^ 1);  // first round passes
          mbar_expect_tx(&full[stage], W_STAGE_BYTES);
          uint8_t* a = smem + stage * W_STAGE_BYTES;
          uint8_t* b = a + W_A_BYTES;
          if constexpr (DW) {  // x^T: 2 boxes of 64 d; dy: 4 boxes of 64 f
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (x_per_expert)
                tma_load_3d(a + j * W_BOX, &tma, &full[stage],
                            t.m * W_BM + 64 * j, k * W_BK, t.z);
              else
                tma_load_2d(a + j * W_BOX, &tma, &full[stage],
                            t.m * W_BM + 64 * j, k * W_BK);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
              tma_load_3d(b + j * W_BOX, &tmb, &full[stage],
                          t.n * W_BN + 64 * j, k * W_BK, t.z);
          } else {  // dy: 128 rows x 64 f; w: 256 rows of d x 64 f
            const int e = (walk_experts ? 0 : t.z) + k / nk;
            const int kf = (k % nk) * W_BK;
            tma_load_3d(a, &tma, &full[stage], kf, t.m * W_BM, e);
            tma_load_3d(b, &tmb, &full[stage], kf, t.n * W_BN, e);
          }
          if (++stage == W_STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {  // consumers: warpgroup 1 rows 0-63, warpgroup 2 rows 64-127
    regs_inc<232>();
    const int cw = wg - 1, ct = threadIdx.x - 128;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = unit_of<DW>(u, mt, nt, split, steps, rows);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      // straight-line wgmma issue in each loop (a branch among the
      // instructions would have them serialized); every slice takes its 4
      // k-steps, the rows past a ragged C or f being TMA's zeros
      if constexpr (DW)
        mainloop<2, W_STAGES>(acc, smem, full, empty, stage, phase, t.kb,
                              t.ke, cw, lane);
      else if (!t.half)
        mainloop<0, W_STAGES>(acc, smem, full, empty, stage, phase, t.kb,
                              t.ke, cw, lane);
      else
        mainloop<1, W_STAGES>(acc, smem, full, empty, stage, phase, t.kb,
                              t.ke, cw, lane);

      const int nq = t.half ? 16 : 32;  // float4s of acc in use
      if constexpr (!DW) if (split > 1) {
        // this part's tile, in register order: coalesced float4 stores
        const long long tile = ((long long)t.z * nt + t.n) * mt + t.m;
        float4* base = reinterpret_cast<float4*>(part) +
                       tile * split * (W_PART / 4);
#pragma unroll
        for (int q = 0; q < 32; ++q)
          if (q < nq)
            __stcg(&base[t.s * (W_PART / 4) + q * W_CONSUMERS + ct],
                   make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                               acc[4 * q + 3]));
        __threadfence();
        named_sync(1, W_CONSUMERS);
        if (ct == 0) {
          const int last = atomicAdd(&count[tile], 1) == split - 1;
          if (last) count[tile] = 0;  // every part has arrived: reset
          *last_flag = last;
        }
        named_sync(1, W_CONSUMERS);
        if (!*last_flag) continue;
        __threadfence();
        // the parts in the order 0 .. split-1, whichever arrived last (its
        // own read back too: the same bits, and no registers held for it)
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          if (q >= nq) continue;
          const float4* at = base + q * W_CONSUMERS + ct;
          float4 sum = __ldcg(at);
          for (int s = 1; s < split; ++s) {
            const float4 v = __ldcg(at + s * (W_PART / 4));
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
          }
          acc[4 * q] = sum.x;
          acc[4 * q + 1] = sum.y;
          acc[4 * q + 2] = sum.z;
          acc[4 * q + 3] = sum.w;
        }
      }

      // acc[4j + 2r + c]: row 16 warp + lane / 4 + 8 r, column 8 j +
      // 2 (lane % 4) + c of this warpgroup's 64 x 256 (64 x 128 where half)
      if constexpr (DW) {
        // dw's tiles are many (K = C is short) and its output large: the
        // tile goes to shared memory, 128-byte swizzled as TMA reads it
        // (the 16-byte chunk c of row r at c ^ (r % 8)), and one thread
        // stores it with TMA while the warpgroup starts the next tile
        uint8_t* o = smem + Ring::OUT + cw * (W_OUT_BYTES / 2);
        if (tid == 0) bulk_wait_read<0>();  // the last tile's stores read it
        named_sync(2 + cw, 128);
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + lane / 4 + 8 * r;
            *reinterpret_cast<__nv_bfloat162*>(
                o + (j / 8) * W_BOX + row * 128 +
                (((j % 8) ^ (row % 8)) << 4) + 4 * (lane % 4)) =
                __floats2bfloat162_rn(acc[4 * j + 2 * r],
                                      acc[4 * j + 2 * r + 1]);
          }
        fence_async_shared();
        named_sync(2 + cw, 128);
        if (tid == 0) {
#pragma unroll
          for (int box = 0; box < 4; ++box)
            tma_store_3d(&tmo, o + box * W_BOX, t.n * W_BN + 64 * box,
                         t.m * W_BM + cw * 64, t.z);
          bulk_commit();
        }
        continue;
      }
      __nv_bfloat16* o = out + (size_t)t.z * rows * cols;
      const int row0 = t.m * W_BM + (t.half ? 0 : cw * 64) + warp * 16 +
                       lane / 4;
      const int col0 = t.n * W_BN + (t.half ? cw * 128 : 0) + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = col0 + 8 * j;
        if (j >= nq || col >= cols) continue;  // nq: 8-column groups too
        // cols % 8 == 0: both columns or neither
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row < rows)
            *reinterpret_cast<__nv_bfloat162*>(&o[(size_t)row * cols + col]) =
                __floats2bfloat162_rn(acc[4 * j + 2 * r],
                                      acc[4 * j + 2 * r + 1]);
        }
      }
    }
    if constexpr (DW)
      if (tid == 0) bulk_wait_read<0>();  // before the block's memory goes
  }
}

bool tma_aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Both products on the wgmma kernel; split parts of dx's K walk (part and
// count then hold split tiles of W_PART floats each and a zeroed counter a
// tile).  Returns launches in the low four bits, a refused launch's error
// above them.
int launch_bwd_wgmma(const void* x, const void* w, const void* dy, void* dx,
                     void* dw, int E, int C, int D, int F, long long sxe,
                     long long sxc, int expanded, int split, float* part,
                     int* count, cudaStream_t st) {
  // the layout the wrapper's choice promises; refuse anything else
  if (D % 8 || F % 8 || sxc % 8 || sxe % 8 || !tma_aligned(x) ||
      !tma_aligned(w) || !tma_aligned(dy) || (dx && !tma_aligned(dx)) ||
      (dw && !tma_aligned(dw)) || split < 1 ||
      (split > 1 && (!part || !count)))
    return (int)cudaErrorInvalidValue << 4;
  const int walk = (expanded ? E : 1) * ((F + W_BK - 1) / W_BK);
  if (split > walk) return (int)cudaErrorInvalidValue << 4;
  const int sms = hopper::sm_count();
  int launched = 0;
  const cuuint64_t ystrides[2] = {(cuuint64_t)F * 2, (cuuint64_t)C * F * 2};
  const cuuint64_t ydims[3] = {(cuuint64_t)F, (cuuint64_t)C, (cuuint64_t)E};
  if (dx) {
    CUtensorMap ta, tb;
    const cuuint32_t abox[3] = {64, (cuuint32_t)W_BM, 1};
    int err = hopper::encode_bf16(&ta, dy, 3, ydims, ystrides, abox);
    const cuuint64_t wdims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
    const cuuint64_t wstrides[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};
    const cuuint32_t wbox[3] = {64, (cuuint32_t)W_BN, 1};
    if (!err) err = hopper::encode_bf16(&tb, w, 3, wdims, wstrides, wbox);
    if (!err)
      err = (int)cudaFuncSetAttribute(
          gmm_bwd_wgmma_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)WRing<false>::SMEM);
    if (err) return err << 4;
    const long long units = (long long)((C + W_BM - 1) / W_BM) *
                            ((D + W_BN - 1) / W_BN) * (expanded ? 1 : E) *
                            split;
    const int grid = (int)(units < sms ? units : sms);
    gmm_bwd_wgmma_kernel<false>
        <<<grid, W_THREADS, WRing<false>::SMEM, st>>>(
        ta, tb, ta, static_cast<__nv_bfloat16*>(dx), part, count, E, C, D, F,
        expanded, 1, split);
    err = (int)cudaGetLastError();
    if (err) return err << 4;
    ++launched;
  }
  if (dw) {
    CUtensorMap ta, tb;
    const int x_per_expert = !expanded && sxe != 0;
    const cuuint64_t xdims[3] = {(cuuint64_t)D, (cuuint64_t)C, (cuuint64_t)E};
    const cuuint64_t xstrides[2] = {(cuuint64_t)sxc * 2, (cuuint64_t)sxe * 2};
    const cuuint32_t xbox[3] = {64, 64, 1};
    int err = hopper::encode_bf16(&ta, x, x_per_expert ? 3 : 2, xdims,
                                  xstrides, xbox);
    const cuuint32_t ybox[3] = {64, 64, 1};
    if (!err) err = hopper::encode_bf16(&tb, dy, 3, ydims, ystrides, ybox);
    // dw (E, d, f), stored in boxes of 64 f x 64 d
    CUtensorMap to;
    const cuuint64_t odims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
    const cuuint64_t ostrides[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};
    if (!err) err = hopper::encode_bf16(&to, dw, 3, odims, ostrides, ybox);
    if (!err)
      err = (int)cudaFuncSetAttribute(
          gmm_bwd_wgmma_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)WRing<true>::SMEM);
    if (err) return (err << 4) | launched;
    const long long units = (long long)((D + W_BM - 1) / W_BM) *
                            ((F + W_BN - 1) / W_BN) * E;
    const int grid = (int)(units < sms ? units : sms);
    gmm_bwd_wgmma_kernel<true>
        <<<grid, W_THREADS, WRing<true>::SMEM, st>>>(
        ta, tb, to, static_cast<__nv_bfloat16*>(dw), nullptr, nullptr, E, C, D,
        F, expanded, x_per_expert, 1);
    err = (int)cudaGetLastError();
    if (err) return (err << 4) | launched;
    ++launched;
  }
  return launched;
}

}  // namespace

// Both gradients of moe_gmm for out (E,C,f) = x (E,C,d) w (E,d,f), on
// ``stream``, no synchronisation; dtype 0 = f32, 1 = bf16 (x, w, dy, dx,
// dw).  dy and w contiguous.  x (its gradient dx contiguous in the same
// shape) has unit stride along d and strides sxe, sxc in elements;
// expanded != 0: x is (C, d) for every expert (sxe ignored) and dx the one
// (C, d) sum over the experts.  Either output may be null (not computed).
// variant: 0 = f32 (dtype 0) or mma_sync (dtype 1), 1 = wgmma (bf16); for
// wgmma, dx's K walk in ``split`` parts (ops.gmm_bwd_split) with ``part``
// (split x dx's tiles x 32,768 floats) and ``count`` (an int a tile, zero;
// left zero) where split > 1.  Returns the number of kernels launched in
// the low four bits and, above them, the cudaError_t of a refused launch
// (cudaErrorInvalidValue for shapes or layouts it does not take).
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, int E, int C, int D, int F,
                           long long sxe, long long sxc, int expanded,
                           int dtype, int variant, int split, void* part,
                           void* count, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1) return (int)cudaErrorInvalidValue << 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (expanded) sxe = 0;
  if (variant == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue << 4;
    return launch_bwd_wgmma(x, w, dy, dx, dw, E, C, D, F, sxe, sxc, expanded,
                            split, static_cast<float*>(part),
                            static_cast<int*>(count), st);
  }
  if (variant != 0 || split != 1) return (int)cudaErrorInvalidValue << 4;
  int launched = 0;
  if (dx) {  // (C, d) = dy_e (C, f) w_e^T (f, d)
    Operands o{dy, w, dx, C, D, F,
               (long long)C * F, F, 1,     // dy: [e][c][f]
               (long long)D * F, 1, F,     // w^T: B[k=f][n=d] = w[e][d][f]
               expanded ? E : 1};
    const cudaError_t err = run(o, expanded ? 1 : E, dtype, true, st);
    if (err != cudaSuccess) return (int)err << 4;
    ++launched;
  }
  if (dw) {  // (d, f) = x_e^T (d, C) dy_e (C, f)
    Operands o{x, dy, dw, D, F, C,
               sxe, 1, sxc,                // x^T: A[m=d][k=c] = x[e][c][d]
               (long long)C * F, F, 1,     // dy
               1};
    const cudaError_t err = run(o, E, dtype, false, st);
    if (err != cudaSuccess) return ((int)err << 4) | launched;
    ++launched;
  }
  return launched;
}

extern "C" const char* moe_gmm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
