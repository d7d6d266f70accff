// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel (body _ssd_kernel).
// Same contract: x (B,H,L,P), dt (B,H,L) f32, a (H,) f32, b and c (B,L,N)
// shared by all heads; y (B,H,L,P) in x's dtype; all arithmetic in f32.
// Per chunk of Q rows, with cs = cumsum(dt * a):
//   y = ((C B^T) o L o dt_j) x + exp(cs) o (C h^T),  L[i,j] = exp(cs_i - cs_j), j <= i
//   h <- h exp(cs_Q) + x^T (B o exp(cs_Q - cs) dt)       h: (P,N) f32 carry
//
// What bounds it on this card.  At the serving path's shape (mamba2-130m
// prefill, B 4 x S 512, H 24, P 64, N 128, f32) the scan reads x, dt, b, c
// and writes y once: 27.4 MB, 8.2 us at 3.35 TB/s.  Its dual form does
// 2Q(QN + QP + 2PN) operations per (b, h, chunk of Q): 6.4 GFLOP at the
// model's chunk 256, 2.8 GFLOP at this kernel's 64 (42 us at the f32 rate
// of the CUDA cores, 67 TFLOP/s), and least at Q = 1, the recurrence,
// 2(N + P + 2PN) per row: 1.6 GFLOP, 24 us.  So in f32 it is bound by
// operations, at 24 us.  This first version computes in f32 on
// the CUDA cores; what the design does about the operations: every operand
// of the four per-chunk products sits in shared memory, each thread keeps a
// register tile of outputs (4x4 of C B^T, 8 rows of y, 4x4 of h) and reads
// operands as float4 where the layout allows, the chunk is 64 rows (the
// dual form's Q^2 terms cost a quarter of what they cost at 256), and the
// upper triangle of C B^T is not computed.  Tensor cores (TF32 would break
// the f32 tolerance; a bf16 path would change the model's numbers) are for
// a later version.
//
// Translation from the TPU kernel.  The TPU ran grid (B, H, L/Q) with the
// chunk dimension sequential and h in VMEM scratch.  Blocks on Hopper run
// in no order, so one block owns (b, h, 32 columns of P) and loops over the
// chunks itself, with its 32 x N slice of h in shared memory.  The columns
// of P are independent in the scan (y[:, p] and h[p, :] read only x[:, p]),
// so splitting P across blocks costs only the recomputed C B^T, and gives
// 192 blocks instead of 96 at the path shape, two per SM.
// Grid: (P/32, H, B), 256 threads.
//
// Traps handled here:
//  * exp(cs_i - cs_j) is formed only for j <= i.  a reaches -16 in the model
//    and cs falls to -1e3 over a chunk, so above the diagonal the exponent is
//    +1e3, exp overflows to inf, and inf * 0 is NaN.  L is never factored as
//    exp(cs_i) * exp(-cs_j) for the same reason.  exp(cs) and exp(cs_Q - cs)
//    are <= 1 and may underflow to 0 harmlessly.
//  * The function does not depend on the chunk length, so the kernel uses
//    its own (64) whatever the caller's chunk; the wrapper keeps the chunk
//    contract of the JAX package (L a multiple of min(chunk, L)).
//  * A ragged last chunk (L not a multiple of 64) is padded in shared memory
//    with x = b = c = dt = 0: padded rows add no decay and no state, and are
//    not stored.
//  * x and dt are read through strides (the model passes permuted views of
//    its (B,L,H,P) and (B,L,H) tensors, no copy); x has unit stride along P.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr int Q = 64;         // rows per chunk
constexpr int PT = 32;        // columns of P per block
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float dot4(float4 u, float4 v) {
  return fmaf(u.x, v.x, fmaf(u.y, v.y, fmaf(u.z, v.z, u.w * v.w)));
}

// Shared-memory layout (offsets in floats).  Row paddings keep float4 rows
// aligned and make (N + 4) / 4 odd, so eight threads reading eight rows as
// float4 hit eight different bank groups.
template <int N>
struct Layout {
  static constexpr int LDN = N + 4;   // row of the b, c and h tiles
  static constexpr int LDX = PT + 4;  // row of the x tile
  static constexpr int LDG = Q + 4;   // row of the (C B^T) o L o dt tile
  static constexpr int X = 0;                 // [Q][LDX]
  static constexpr int B = X + Q * LDX;       // [Q][LDN]
  static constexpr int C = B + Q * LDN;       // [Q][LDN]
  static constexpr int H = C + Q * LDN;       // [PT][LDN] state slice
  static constexpr int G = H + PT * LDN;      // [Q][LDG]
  static constexpr int CS = G + Q * LDG;      // [Q] cumulative log-decay
  static constexpr int DT = CS + Q;           // [Q]
  static constexpr int W = DT + Q;            // [Q] exp(cs_Q - cs_j) dt_j
  static constexpr int TOTAL = W + Q;
  static constexpr size_t BYTES = sizeof(float) * TOTAL;
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ b,
                const T* __restrict__ c, T* __restrict__ y, int H, int L,
                int P, long long sxb, long long sxh, long long sxl,
                long long sdb, long long sdh, long long sdl) {
  using S = Layout<N>;
  static_assert(N % 16 == 0 && N <= 128, "N in {16, 32, 64, 128}");
  extern __shared__ __align__(16) float smem[];
  float* sX = smem + S::X;
  float* sB = smem + S::B;
  float* sC = smem + S::C;
  float* sH = smem + S::H;
  float* sG = smem + S::G;
  float* sCs = smem + S::CS;
  float* sDt = smem + S::DT;
  float* sW = smem + S::W;

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const float ah = a[h];
  const T* xb = x + bi * sxb + h * sxh + p0;
  const float* dtb = dt + bi * sdb + h * sdh;
  const T* bb = b + (size_t)bi * L * N;
  const T* cb = c + (size_t)bi * L * N;
  T* yb = y + ((size_t)bi * H + h) * (size_t)L * P + p0;

  for (int i = tid; i < PT * S::LDN; i += THREADS) sH[i] = 0.f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    const int rows = min(Q, L - l0);
    __syncthreads();  // the previous chunk is done with every tile

    // 1. cs = inclusive cumsum of dt * a over the chunk (warp 0, two rows a
    //    lane); padded rows get dt = 0, so cs_Q is the last real row's.
    if (tid < 32) {
      const int j0 = 2 * tid, j1 = j0 + 1;
      const float d0 = j0 < rows ? dtb[(l0 + j0) * sdl] : 0.f;
      const float d1 = j1 < rows ? dtb[(l0 + j1) * sdl] : 0.f;
      const float v0 = d0 * ah, v1 = d1 * ah;
      float s = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, s, off);
        if (tid >= off) s += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) excl = 0.f;
      sCs[j0] = excl + v0;
      sCs[j1] = excl + v0 + v1;
      sDt[j0] = d0;
      sDt[j1] = d1;
    }
    // 2. stage the x, b, c tiles in f32
    for (int idx = tid; idx < Q * PT; idx += THREADS) {
      const int r = idx / PT, col = idx % PT;
      sX[r * S::LDX + col] = r < rows ? to_f32(xb[(l0 + r) * sxl + col]) : 0.f;
    }
    for (int idx = tid; idx < Q * N; idx += THREADS) {
      const int r = idx / N, col = idx % N;
      const bool in = r < rows;
      const size_t g = (size_t)(l0 + r) * N + col;
      sB[r * S::LDN + col] = in ? to_f32(bb[g]) : 0.f;
      sC[r * S::LDN + col] = in ? to_f32(cb[g]) : 0.f;
    }
    __syncthreads();
    const float cs_last = sCs[Q - 1];
    if (tid < Q) sW[tid] = expf(cs_last - sCs[tid]) * sDt[tid];  // exponent <= 0

    // 3. G = (C B^T) o L o dt_j on and below the diagonal, 0 above.  Thread
    //    (ty, tx) owns rows ty + 16i and columns tx + 16j; pairs j > i lie
    //    wholly above the diagonal and are skipped.
    {
      const int tx = tid % 16, ty = tid / 16;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(&sC[(ty + 16 * i) * S::LDN + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(&sB[(tx + 16 * j) * S::LDN + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) acc[i][j] += dot4(cv[i], bv[j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          float g = 0.f;
          if (col <= row)  // the exponential only where it is <= 1
            g = acc[i][j] * expf(sCs[row] - sCs[col]) * sDt[col];
          sG[row * S::LDG + col] = g;
        }
      }
    }
    __syncthreads();

    // 4. y = G x + exp(cs) o (C h^T), with h the state before this chunk.
    //    Thread owns column pc of the tile and rows rg + 8k.
    {
      constexpr int RG = THREADS / PT;  // 8 row groups
      constexpr int RPT = Q / RG;       // 8 rows a thread
      const int pc = tid % PT, rg = tid / PT;
      float accd[RPT], acco[RPT];
#pragma unroll
      for (int k = 0; k < RPT; ++k) accd[k] = acco[k] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(&sH[pc * S::LDN + n]);
#pragma unroll
        for (int k = 0; k < RPT; ++k)
          acco[k] += dot4(*reinterpret_cast<const float4*>(&sC[(rg + RG * k) * S::LDN + n]), hv);
      }
#pragma unroll 2
      for (int j = 0; j < Q; j += 4) {
        const float x0 = sX[(j + 0) * S::LDX + pc];
        const float x1 = sX[(j + 1) * S::LDX + pc];
        const float x2 = sX[(j + 2) * S::LDX + pc];
        const float x3 = sX[(j + 3) * S::LDX + pc];
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          const float4 gv = *reinterpret_cast<const float4*>(&sG[(rg + RG * k) * S::LDG + j]);
          accd[k] = fmaf(gv.x, x0, fmaf(gv.y, x1, fmaf(gv.z, x2, fmaf(gv.w, x3, accd[k]))));
        }
      }
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int row = rg + RG * k;
        if (row < rows)
          store(&yb[(size_t)(l0 + row) * P + pc], accd[k] + expf(sCs[row]) * acco[k]);
      }
    }
    __syncthreads();  // every thread has read h before it is updated

    // 5. h <- h exp(cs_Q) + x^T (B o w).  Thread owns columns n = nl + NL t
    //    of the state and rows p = pl + PL s of its slice.
    {
      constexpr int NL = N < 32 ? N : 32;
      constexpr int PL = THREADS / NL;
      constexpr int NPT = N / NL;
      constexpr int PPT = PT / PL;
      static_assert(PPT >= 1 && PT % PL == 0, "state tile");
      const int nl = tid % NL, pl = tid / NL;
      const float decay = expf(cs_last);
      float acc[PPT][NPT];
#pragma unroll
      for (int s = 0; s < PPT; ++s)
#pragma unroll
        for (int t = 0; t < NPT; ++t) acc[s][t] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float wj = sW[j];
        float bv[NPT], xv[PPT];
#pragma unroll
        for (int t = 0; t < NPT; ++t) bv[t] = sB[j * S::LDN + nl + NL * t] * wj;
#pragma unroll
        for (int s = 0; s < PPT; ++s) xv[s] = sX[j * S::LDX + pl + PL * s];
#pragma unroll
        for (int s = 0; s < PPT; ++s)
#pragma unroll
          for (int t = 0; t < NPT; ++t) acc[s][t] = fmaf(xv[s], bv[t], acc[s][t]);
      }
#pragma unroll
      for (int s = 0; s < PPT; ++s)
#pragma unroll
        for (int t = 0; t < NPT; ++t) {
          float* hp = &sH[(pl + PL * s) * S::LDN + nl + NL * t];
          *hp = *hp * decay + acc[s][t];
        }
    }
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* b, const void* c, void* y, int B, int H, int L,
                   int P, long long sxb, long long sxh, long long sxl,
                   long long sdb, long long sdh, long long sdl,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<N>::BYTES;
  auto kernel = ssd_scan_kernel<T, N>;
  // above 48 KB dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(P / PT, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), H, L, P, sxb, sxh, sxl,
      sdb, sdh, sdl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* x, const float* dt, const float* a,
                       const void* b, const void* c, void* y, int B, int H,
                       int L, int P, int N, long long sxb, long long sxh,
                       long long sxl, long long sdb, long long sdh,
                       long long sdl, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, 16>(x, dt, a, b, c, y, B, H, L, P, sxb, sxh, sxl, sdb, sdh, sdl, s);
    case 32: return launch<T, 32>(x, dt, a, b, c, y, B, H, L, P, sxb, sxh, sxl, sdb, sdh, sdl, s);
    case 64: return launch<T, 64>(x, dt, a, b, c, y, B, H, L, P, sxb, sxh, sxl, sdb, sdh, sdl, s);
    case 128: return launch<T, 128>(x, dt, a, b, c, y, B, H, L, P, sxb, sxh, sxl, sdb, sdh, sdl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of x, b, c, y): 0 = f32, 1 = bf16.  Strides in elements.  Returns
// the launch's cudaGetLastError() (0 on success); does not synchronise.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, void* y, int B,
                            int H, int L, int P, int N, long long sxb,
                            long long sxh, long long sxl, long long sdb,
                            long long sdh, long long sdl, int dtype,
                            void* stream) {
  if (B < 1 || H < 1 || L < 1 || (P != 32 && P != 64 && P != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  if (dtype == 0)
    return (int)dispatch_n<float>(x, dtf, af, b, c, y, B, H, L, P, N, sxb, sxh, sxl, sdb, sdh, sdl, s);
  if (dtype == 1)
    return (int)dispatch_n<__nv_bfloat16>(x, dtf, af, b, c, y, B, H, L, P, N, sxb, sxh, sxl, sdb, sdh, sdl, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
