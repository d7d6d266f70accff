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
// the bf16 tensor-core rate (989 TFLOP/s), which only wgmma reaches.
//
// What this design does about it: little yet; it is the simple kernel
// that is right first, kept for a later PR to make fast.
//  * One generic product, out[z] = sum over e in the block's expert range
//    of A_e B_e, with A and B read through strides: dx takes A = dy (K =
//    f contiguous) and B = w^T (K contiguous: w's rows), dw takes A = x^T
//    (M = d contiguous) and B = dy (N = f contiguous).  The expert range
//    is the block's own expert (grid z), or every expert for the expanded
//    dx, its (expert, k-tile) pairs walked as one K loop.
//  * bf16: mma.sync m16n8k16 on 64 x 128 tiles, 8 warps of 32 x 32, a
//    3-stage ring of 32-deep slices that 16-byte cp.async copies fill
//    where the rows are aligned (masked loads elsewhere, zeros past every
//    edge); ldmatrix reads the fragments, transposed (.trans) for the
//    operand whose contiguous dimension is M or N.  The forward's mma_sync
//    variant measured ~170 TFLOP/s on this card (PERF.md), so expect
//    ~6 ms a product at the shape above.
//  * f32 (parity runs): full f32 on the CUDA cores, 64 x 64 tiles, no TF32.
//  * Every output element is one block's sum, taken in a fixed order: two
//    runs give the same bits.  No atomics.
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

}  // namespace

// Both gradients of moe_gmm for out (E,C,f) = x (E,C,d) w (E,d,f), on
// ``stream``, no synchronisation; dtype 0 = f32, 1 = bf16 (x, w, dy, dx,
// dw).  dy and w contiguous.  x (its gradient dx contiguous in the same
// shape) has unit stride along d and strides sxe, sxc in elements;
// expanded != 0: x is (C, d) for every expert (sxe ignored) and dx the one
// (C, d) sum over the experts.  Either output may be null (not computed).
// Returns the number of kernels launched in the low four bits and, above
// them, the cudaError_t of a refused launch (cudaErrorInvalidValue for
// shapes it does not take).
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, int E, int C, int D, int F,
                           long long sxe, long long sxc, int expanded,
                           int dtype, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1) return (int)cudaErrorInvalidValue << 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (expanded) sxe = 0;
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
