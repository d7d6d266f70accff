// Grouped expert GEMM for Hopper (sm_90a): (E,C,d) x (E,d,f) -> (E,C,f).
//
// Replaces the TPU kernel
//   src/repro/kernels/moe_gmm/kernel.py:moe_gmm_kernel (body _gmm_kernel).
// Same contract: per expert e, out[e] = x[e] @ w[e], accumulated in f32 over
// d, written in x's dtype; f32 or bf16 inputs.
//
// What bounds it on this card.  The model's expert FFN (moe_dense) runs it
// three times per MoE layer on every token for every expert.  In decode
// (dbrx-132b, E 16, C 4 slots, d 6144, f 10752, bf16) each call streams the
// 2.1 GB of one weight stack for 0.5 GFLOP: bound by bytes, 0.63 ms at
// 3.35 TB/s.  In prefill (B 2 x S 256, C 512) each call does 1.08 TFLOP on
// the same bytes: bound by operations, 1.1 ms at the bf16 tensor-core rate
// (989 TFLOP/s).  What the design does about it: the bf16 path computes on
// the tensor cores with mma.sync (m16n8k16, f32 accumulation), its
// fragments read with ldmatrix from a ring of three tiles in shared memory
// that 16-byte cp.async copies fill ahead of the compute, so the weight
// stream stays in flight through the math and the barriers, over enough
// blocks (1,344 at the decode shape) to cover the card; the f32 path
// (parity runs) computes in full f32 on the CUDA cores -- no TF32, which
// keeps ~3 decimal digits and would break the 2e-5 tolerance.  wgmma and
// TMA are for a later version.
//
// Translation from the TPU kernel.  The TPU grid (E, C/bc, f/bf, d/bd) ran
// its last dimension in order, with the accumulator in VMEM scratch; here a
// block owns one (C, f) tile of one expert and loops over d itself, with the
// accumulator in registers.  Grid: (ceil(f/BN), ceil(C/BM), E).
//
// Traps handled here:
//  * x's expert stride may be 0: moe_dense computes every expert on every
//    token, and the wrapper passes the tokens expanded over experts without
//    materializing them (403 MB at dbrx B 4 x S 512).  Any row stride of x
//    is taken; its last dimension has unit stride.
//  * C, d and f need not divide the tiles (decode has C = number of slots):
//    every edge is masked, loads past it read 0 and stores past it are
//    dropped.  The TPU kernel's divisibility asserts do not carry over.
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

// ---- bf16: tensor cores (mma.sync m16n8k16, f32 accumulation) -------------
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

}  // namespace

// dtype (of x, w and out): 0 = f32, 1 = bf16.  x: (E,C,D) with strides
// (sxe, sxc, 1) in elements, sxe may be 0; w: (E,D,F) contiguous; out:
// (E,C,F) contiguous.  Returns the launch's cudaGetLastError() (0 on
// success); does not synchronise.
extern "C" int moe_gmm(const void* x, const void* w, void* out, int E, int C,
                       int D, int F, long long sxe, long long sxc, int dtype,
                       void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || sxe < 0 || sxc < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((F + F_BN - 1) / F_BN, (C + F_BM - 1) / F_BM, E);
    gmm_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), C, D, F, sxe, sxc);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
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
