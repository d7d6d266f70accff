// Gradient-compression kernels for Hopper (sm_90a): quantize (K2a),
// dequantize (K2b), sparsify (K3) and the PowerSGD projection matmul (K4).
//
// Replaces the TPU kernels of src/repro/kernels/compress/kernel.py:
//   quantize_kernel   (body _quantize_kernel)   -> compress_quantize
//   dequantize_kernel (body _dequantize_kernel) -> compress_dequantize
//   sparsify_kernel   (body _sparsify_kernel)   -> compress_sparsify
//   matmul_kernel     (body _matmul_kernel)     -> compress_matmul
// Same contracts.  Quantize: per row, scale = max(max|x|, 1e-30) / qmax and
// q = clip(rint(x / scale)) (half to even), or clip(floor(x / scale + u))
// with u = (bits >> 8) * 2^-24 from caller-given uint32 bits; qmax =
// 2^(b-1) - 1; x f32 or bf16 -> q int8, scale f32 (m, 1).  Dequantize: q *
// scale -> f32.  Sparsify: where(|x| >= t_row, x, 0) -> f32.  Matmul: (m,k) x
// (k,n) in f32 with f32 accumulation, any strides, f32 or bf16 inputs.
//
// What bounds them on this card.  All four are bound by bytes at the shapes
// of the codec and collective paths (qwen2-0.5b's gradient: 494,147,584
// values in rows of 256; a 64 MiB bucket's ring chunk of 4,194,304 values;
// the embedding gradient (152064, 896) under PowerSGD rank 4).  Quantize
// reads 4 bytes and writes 1 per value (0.740 ms for the whole gradient at
// 3.35 TB/s), dequantize the reverse, sparsify reads 4 and writes 4
// (1.182 ms); each projection reads or writes the 545 MB embedding
// gradient once (0.163 ms) and does 8 flops per 4-byte value, far below
// the f32 rate.  What the design does about it: every pass is one sweep
// over the payload with coalesced loads (16 bytes a thread for f32, 8 for
// bf16, where the row length and alignment allow, scalar otherwise) and
// grid-stride loops over enough blocks to cover the 132 SMs; nothing is
// read twice from device memory except a short row, which the second pass
// of quantize finds in L1.
//
// Translation from the TPU kernels.  The TPU grid walked blocks of rows
// with the whole row in VMEM.  Here quantize has two regimes:
//  * many short rows (n <= 4096; the payload-level codec's rows of 256):
//    one warp per row, the absmax reduced with shuffles, then the row is
//    quantized; one launch.
//  * few long rows (the codec and the ring's per-tensor scale is m = 1,
//    up to 136M values): one block cannot serve a row, so the absmax is a
//    reduction across blocks.  Pass 1 writes one partial max per block
//    into a workspace; pass 2 has every block reduce its row's partials
//    (a few hundred floats) before it quantizes its slice, and block 0
//    writes the scale.  Two launches, no atomics, no memset.
// The matmul has three shapes on the PowerSGD path and one kernel each,
// chosen from the shape and strides (the TPU kernel tiled m and n and kept
// k whole, which fits none of them).  The skinny operand (k x 4 or 4 x n)
// is staged in shared memory, a slice of at most 200 KB per block, padded
// to rows of 4 or 8 floats, so each value of the large operand costs one
// global load and one 16-byte shared load (through L1, the first version's
// four scattered loads of b per value held it to 30% of the HBM rate).
//  * M @ Q0, (152064, 896) x (896, 4): n <= 8 and a has unit stride along
//    k.  One warp per row of a, lanes along k, n sums in registers,
//    reduced with shuffles; split-K over blocks where the rows are too few
//    to fill the card or k too long for shared memory (the o-projection
//    gradient as 14 x 57,344).
//  * M^T @ P, (896, 152064) x (152064, 4), M^T a strided view (unit stride
//    along m): only 3,584 outputs over k = 152,064.  One thread per row
//    of a (coalesced along m), split-K over blocks to fill the card (each
//    block's slice of P read as a broadcast).
//  * the decode P @ Q^T, k = 4 with a 545 MB output: one warp per output
//    row, its 4 values of P in registers, lanes along n, writes coalesced;
//    n sliced over blocks where b exceeds shared memory.
//  * anything else: a plain 64 x 64 tiled product on the CUDA cores.
// Split-K partials are summed by a second pass in a fixed order
// (deterministic, no atomicAdd).
// All in full f32 on the CUDA cores: no TF32, which keeps ~3 digits and
// would fail the 1e-5 tolerance of the JAX test.
//
// Traps handled here:
//  * bit-equality with the plain version: x / scale is a true IEEE
//    division (no --use_fast_math, so -prec-div stays on), rounding is
//    rintf (half to even, as torch.round and jnp.round), and the scale is
//    max(absmax, 1e-30f) / qmax in f32, as the reference computes it.
//  * rows of any length: the vector paths need n % 4 == 0 and aligned
//    pointers, checked here; otherwise the scalar paths run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long SHORT_ROW = 4096;   // longest row one warp quantizes
constexpr long long LONG_SLICE = 8192;  // least values a block takes
constexpr int MAX_BLOCKS_PER_ROW = 1024;
constexpr int SMALL = 8;                // n (or k) of the skinny products
constexpr int GRID_CAP = 132 * 16;      // grid-stride loops: 16 blocks a SM

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive values from an address aligned to 4 elements
__device__ __forceinline__ void load4(const float* p, float f[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float f[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  f[0] = __low2float(lo); f[1] = __high2float(lo);
  f[2] = __low2float(hi); f[3] = __high2float(hi);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max over the block; every thread gets the result
__device__ float block_max(float v) {
  __shared__ float red[WARPS];
  v = warp_max(v);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[w] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = fmaxf(r, red[i]);
  return r;
}

__device__ __forceinline__ float row_scale(float absmax, float qmax) {
  return fmaxf(absmax, 1e-30f) / qmax;
}

template <bool STOCH>
__device__ __forceinline__ int8_t quant1(float v, float s, float qmax,
                                         uint32_t bits) {
  const float t = v / s;
  float r;
  if (STOCH) {
    r = floorf(t + (float)(bits >> 8) * 5.9604644775390625e-08f);  // 2^-24
  } else {
    r = rintf(t);
  }
  r = fminf(fmaxf(r, -qmax), qmax);
  return (int8_t)__float2int_rn(r);
}

// quantize 4 values at x[i..i+3] (aligned) into q[i..i+3]
template <typename T, bool STOCH>
__device__ __forceinline__ void quant4(const T* x, const uint32_t* rnd,
                                       int8_t* q, long long i, float s,
                                       float qmax) {
  float f[4];
  load4(x + i, f);
  uint4 r = make_uint4(0, 0, 0, 0);
  if (STOCH) r = *reinterpret_cast<const uint4*>(rnd + i);
  char4 o;
  o.x = quant1<STOCH>(f[0], s, qmax, r.x);
  o.y = quant1<STOCH>(f[1], s, qmax, r.y);
  o.z = quant1<STOCH>(f[2], s, qmax, r.z);
  o.w = quant1<STOCH>(f[3], s, qmax, r.w);
  *reinterpret_cast<char4*>(q + i) = o;
}

// ---- K2a, short rows: one warp per row ------------------------------------
template <typename T, bool STOCH, bool VEC>
__global__ void __launch_bounds__(THREADS)
quant_rows_kernel(const T* __restrict__ x, const uint32_t* __restrict__ rnd,
                  int8_t* __restrict__ q, float* __restrict__ scale,
                  long long m, long long n, float qmax) {
  const int lane = threadIdx.x % 32;
  const long long nwarps = (long long)gridDim.x * WARPS;
  for (long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
       row < m; row += nwarps) {
    const long long base = row * n;
    float amax = 0.f;
    if (VEC) {
      for (long long j = lane * 4; j < n; j += 128) {
        float f[4];
        load4(x + base + j, f);
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(f[0]), fabsf(f[1])),
                                 fmaxf(fabsf(f[2]), fabsf(f[3]))));
      }
    } else {
      for (long long j = lane; j < n; j += 32)
        amax = fmaxf(amax, fabsf(to_f(x[base + j])));
    }
    const float s = row_scale(warp_max(amax), qmax);
    if (lane == 0) scale[row] = s;
    if (VEC) {
      for (long long j = lane * 4; j < n; j += 128)
        quant4<T, STOCH>(x, rnd, q, base + j, s, qmax);
    } else {
      for (long long j = lane; j < n; j += 32)
        q[base + j] = quant1<STOCH>(to_f(x[base + j]), s, qmax,
                                    STOCH ? rnd[base + j] : 0u);
    }
  }
}

// ---- K2a, long rows: pass 1, one partial absmax per block -----------------
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
absmax_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                      long long m, long long n, long long slice) {
  const int bpr = gridDim.x;
  for (long long row = blockIdx.y; row < m; row += gridDim.y) {
    const long long lo = blockIdx.x * slice;
    const long long hi = lo + slice < n ? lo + slice : n;
    const T* xr = x + row * n;
    float amax = 0.f;
    if (VEC) {
      for (long long j = lo + threadIdx.x * 4; j < hi; j += THREADS * 4) {
        float f[4];
        load4(xr + j, f);
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(f[0]), fabsf(f[1])),
                                 fmaxf(fabsf(f[2]), fabsf(f[3]))));
      }
    } else {
      for (long long j = lo + threadIdx.x; j < hi; j += THREADS)
        amax = fmaxf(amax, fabsf(to_f(xr[j])));
    }
    amax = block_max(amax);
    if (threadIdx.x == 0) partial[row * bpr + blockIdx.x] = amax;
  }
}

// ---- K2a, long rows: pass 2, reduce the partials, quantize the slice ------
template <typename T, bool STOCH, bool VEC>
__global__ void __launch_bounds__(THREADS)
quant_long_kernel(const T* __restrict__ x, const uint32_t* __restrict__ rnd,
                  const float* __restrict__ partial, int8_t* __restrict__ q,
                  float* __restrict__ scale, long long m, long long n,
                  long long slice, float qmax) {
  const int bpr = gridDim.x;
  for (long long row = blockIdx.y; row < m; row += gridDim.y) {
    float amax = 0.f;
    for (int i = threadIdx.x; i < bpr; i += THREADS)
      amax = fmaxf(amax, partial[row * bpr + i]);
    const float s = row_scale(block_max(amax), qmax);
    if (blockIdx.x == 0 && threadIdx.x == 0) scale[row] = s;
    const long long lo = blockIdx.x * slice;
    const long long hi = lo + slice < n ? lo + slice : n;
    const long long base = row * n;
    if (VEC) {
      for (long long j = lo + threadIdx.x * 4; j < hi; j += THREADS * 4)
        quant4<T, STOCH>(x, rnd, q, base + j, s, qmax);
    } else {
      for (long long j = lo + threadIdx.x; j < hi; j += THREADS)
        q[base + j] = quant1<STOCH>(to_f(x[base + j]), s, qmax,
                                    STOCH ? rnd[base + j] : 0u);
    }
  }
}

// ---- K2b: q * scale -------------------------------------------------------
// I: the index type; 32-bit where the payload allows (cheaper division)
template <typename I, bool VEC>
__global__ void __launch_bounds__(THREADS)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               float* __restrict__ out, I total, I n) {
  const I stride = (I)gridDim.x * THREADS;
  if (VEC) {
    for (I g = (I)blockIdx.x * THREADS + threadIdx.x; g < total / 4;
         g += stride) {
      const float s = scale[(g * 4) / n];
      const char4 c = reinterpret_cast<const char4*>(q)[g];
      reinterpret_cast<float4*>(out)[g] =
          make_float4((float)c.x * s, (float)c.y * s, (float)c.z * s,
                      (float)c.w * s);
    }
  } else {
    for (I i = (I)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride)
      out[i] = (float)q[i] * scale[i / n];
  }
}

// ---- K3: where(|x| >= t_row, x, 0) ----------------------------------------
__device__ __forceinline__ float keep(float v, float t) {
  return fabsf(v) >= t ? v : 0.f;
}

template <typename T, typename I, bool VEC>
__global__ void __launch_bounds__(THREADS)
sparsify_kernel(const T* __restrict__ x, const float* __restrict__ thresh,
                float* __restrict__ out, I total, I n) {
  const I stride = (I)gridDim.x * THREADS;
  if (VEC) {
    for (I g = (I)blockIdx.x * THREADS + threadIdx.x; g < total / 4;
         g += stride) {
      const float t = thresh[(g * 4) / n];
      float f[4];
      load4(x + g * 4, f);
      reinterpret_cast<float4*>(out)[g] = make_float4(
          keep(f[0], t), keep(f[1], t), keep(f[2], t), keep(f[3], t));
    }
  } else {
    for (I i = (I)blockIdx.x * THREADS + threadIdx.x; i < total; i += stride)
      out[i] = keep(to_f(x[i]), thresh[i / n]);
  }
}

// ---- K4: (m,k) x (k,n) -> f32 (m,n), out contiguous -----------------------

// b (k rows from k0, n <= NP columns) into shared memory as rows of NP
// floats, zero-padded: any strides of b, read once per block
template <typename T, int NP>
__device__ void stage_b_rows(const T* __restrict__ b, float* sB, long long k0,
                             long long rows, int n, long long sbk,
                             long long sbn) {
  for (long long e = threadIdx.x; e < rows * NP; e += THREADS) {
    const long long kk = e / NP;
    const int j = (int)(e % NP);
    sB[e] = j < n ? to_f(b[(k0 + kk) * sbk + j * sbn]) : 0.f;
  }
  __syncthreads();
}

// acc[0..NP) += av * the NP floats at sB (16-byte aligned)
template <int NP>
__device__ __forceinline__ void fma_row(float* acc, float av, const float* sB) {
  const float4* r = reinterpret_cast<const float4*>(sB);
#pragma unroll
  for (int q = 0; q < NP / 4; ++q) {
    const float4 v = r[q];
    acc[4 * q + 0] = fmaf(av, v.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(av, v.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(av, v.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(av, v.w, acc[4 * q + 3]);
  }
}

// n <= NP, a with unit stride along m (a transposed view): one thread per
// row of a over one slice of k (blockIdx.y), that slice of b in shared
// memory (every lane reads the same row: a broadcast); writes
// partials[y][row][j], or out when there is one slice
template <typename T, int NP>
__global__ void __launch_bounds__(THREADS)
mm_cols_kernel(const T* __restrict__ a, const T* __restrict__ b,
               float* __restrict__ dst, long long m, long long k, int n,
               long long sak, long long sbk, long long sbn, long long kslice) {
  extern __shared__ float4 smem[];
  float* sB = reinterpret_cast<float*>(smem);
  const long long k0 = blockIdx.y * kslice;
  const long long rows = k0 + kslice < k ? kslice : k - k0;
  stage_b_rows<T, NP>(b, sB, k0, rows, n, sbk, sbn);
  const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (row >= m) return;
  float acc[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) acc[j] = 0.f;
  const T* ap = a + row + k0 * sak;
#pragma unroll 4
  for (long long kk = 0; kk < rows; ++kk, ap += sak)
    fma_row<NP>(acc, to_f(*ap), sB + kk * NP);
  float* d = dst + ((long long)blockIdx.y * m + row) * n;
#pragma unroll
  for (int j = 0; j < NP; ++j)
    if (j < n) d[j] = acc[j];
}

// n <= NP, a with unit stride along k: one warp per row of a over one
// slice of k (blockIdx.y), that slice of b in shared memory; lanes along k
// (consecutive lanes read consecutive rows of b, conflict-free); writes
// partials[y][row][j], or out when there is one slice
template <typename T, int NP>
__global__ void __launch_bounds__(THREADS)
mm_rows_kernel(const T* __restrict__ a, const T* __restrict__ b,
               float* __restrict__ dst, long long m, long long k, int n,
               long long sam, long long sbk, long long sbn, long long kslice) {
  extern __shared__ float4 smem[];
  float* sB = reinterpret_cast<float*>(smem);
  const long long k0 = blockIdx.y * kslice;
  const long long rows = k0 + kslice < k ? kslice : k - k0;
  stage_b_rows<T, NP>(b, sB, k0, rows, n, sbk, sbn);
  const int lane = threadIdx.x % 32;
  const long long nwarps = (long long)gridDim.x * WARPS;
  for (long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
       row < m; row += nwarps) {
    const T* ar = a + row * sam + k0;
    float acc[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (long long kk = lane; kk < rows; kk += 32)
      fma_row<NP>(acc, to_f(ar[kk]), sB + kk * NP);
    float* d = dst + ((long long)blockIdx.y * m + row) * n;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j < n) {
        const float v = warp_sum(acc[j]);
        if (lane == 0) d[j] = v;
      }
    }
  }
}

// k <= SMALL: one warp per row of out over one slice of its columns
// (blockIdx.y), that slice of b in shared memory, the row's k values of a
// in registers (a broadcast load); lanes along n (writes coalesced, shared
// reads conflict-free)
template <typename T>
__global__ void __launch_bounds__(THREADS)
mm_smallk_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 float* __restrict__ out, long long m, long long n, int k,
                 long long sam, long long sak, long long sbk, long long sbn,
                 long long nslice) {
  extern __shared__ float4 smem[];
  float* sB = reinterpret_cast<float*>(smem);
  const long long j0 = blockIdx.y * nslice;
  const long long cols = j0 + nslice < n ? nslice : n - j0;
  for (long long e = threadIdx.x; e < k * cols; e += THREADS)
    sB[e] = to_f(b[(e / cols) * sbk + (j0 + e % cols) * sbn]);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const long long nwarps = (long long)gridDim.x * WARPS;
  for (long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
       row < m; row += nwarps) {
    float av[SMALL];
#pragma unroll
    for (int kk = 0; kk < SMALL; ++kk)
      av[kk] = kk < k ? to_f(a[row * sam + kk * sak]) : 0.f;
    float* o = out + row * n + j0;
    for (long long j = lane; j < cols; j += 32) {
      float acc = 0.f;
#pragma unroll
      for (int kk = 0; kk < SMALL; ++kk)
        if (kk < k) acc = fmaf(av[kk], sB[kk * cols + j], acc);
      o[j] = acc;
    }
  }
}

// out[e] = sum over s of partial[s][e], s in order (deterministic)
__global__ void __launch_bounds__(THREADS)
splitk_reduce_kernel(const float* __restrict__ partial,
                     float* __restrict__ out, long long count, int splits) {
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
       e < count; e += (long long)gridDim.x * THREADS) {
    float s = 0.f;
    for (int i = 0; i < splits; ++i) s += partial[i * count + e];
    out[e] = s;
  }
}

// anything else: 64 x 64 output tiles, 4 x 4 per thread, k in steps of 16
constexpr int TM = 64, TN = 64, TK = 16;

template <typename T>
__global__ void __launch_bounds__(THREADS)
mm_tiled_kernel(const T* __restrict__ a, const T* __restrict__ b,
                float* __restrict__ out, long long m, long long n,
                long long k, long long sam, long long sak, long long sbk,
                long long sbn) {
  __shared__ float sA[TK][TM + 4];
  __shared__ float sB[TK][TN + 4];
  const long long m0 = (long long)blockIdx.y * TM, n0 = (long long)blockIdx.x * TN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (long long k0 = 0; k0 < k; k0 += TK) {
    for (int l = tid; l < TM * TK; l += THREADS) {
      const int r = l / TK, c = l % TK;
      const long long gi = m0 + r, gk = k0 + c;
      sA[c][r] = (gi < m && gk < k) ? to_f(a[gi * sam + gk * sak]) : 0.f;
    }
    for (int l = tid; l < TK * TN; l += THREADS) {
      const int r = l / TN, c = l % TN;
      const long long gk = k0 + r, gj = n0 + c;
      sB[r][c] = (gk < k && gj < n) ? to_f(b[gk * sbk + gj * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gi = m0 + ty * 4 + i;
    if (gi >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long gj = n0 + tx * 4 + j;
      if (gj < n) out[gi * n + gj] = acc[i][j];
    }
  }
}

int grid_for(long long work) {
  const long long g = (work + THREADS - 1) / THREADS;
  return (int)(g < 1 ? 1 : (g > GRID_CAP ? GRID_CAP : g));
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// blocks per row and values per block of the long-row quantize
void long_plan(long long n, int* bpr, long long* slice) {
  long long b = (n + LONG_SLICE - 1) / LONG_SLICE;
  if (b > MAX_BLOCKS_PER_ROW) b = MAX_BLOCKS_PER_ROW;
  long long s = (n + b - 1) / b;
  s = (s + 3) / 4 * 4;  // slices start on a 4-value boundary
  *bpr = (int)((n + s - 1) / s);
  *slice = s;
}

int row_grid(long long m) { return (int)(m < 65535 ? m : 65535); }

template <typename T, bool STOCH>
int quantize_t(const T* x, const uint32_t* rnd, int8_t* q, float* scale,
               float* partial, long long m, long long n, float qmax,
               int* launches, cudaStream_t st) {
  const bool vec = n % 4 == 0 && aligned(x, 4 * sizeof(T)) &&
                   aligned(q, 4) && (!STOCH || aligned(rnd, 16));
  if (n <= SHORT_ROW) {
    const long long blocks = (m + WARPS - 1) / WARPS;
    const int grid = (int)(blocks > GRID_CAP ? GRID_CAP : blocks);
    if (vec)
      quant_rows_kernel<T, STOCH, true><<<grid, THREADS, 0, st>>>(
          x, rnd, q, scale, m, n, qmax);
    else
      quant_rows_kernel<T, STOCH, false><<<grid, THREADS, 0, st>>>(
          x, rnd, q, scale, m, n, qmax);
    *launches = 1;
    return (int)cudaGetLastError();
  }
  int bpr;
  long long slice;
  long_plan(n, &bpr, &slice);
  const dim3 grid(bpr, row_grid(m));
  if (vec)
    absmax_partial_kernel<T, true><<<grid, THREADS, 0, st>>>(x, partial, m, n,
                                                             slice);
  else
    absmax_partial_kernel<T, false><<<grid, THREADS, 0, st>>>(x, partial, m,
                                                              n, slice);
  *launches = 1;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (vec)
    quant_long_kernel<T, STOCH, true><<<grid, THREADS, 0, st>>>(
        x, rnd, partial, q, scale, m, n, slice, qmax);
  else
    quant_long_kernel<T, STOCH, false><<<grid, THREADS, 0, st>>>(
        x, rnd, partial, q, scale, m, n, slice, qmax);
  *launches = 2;
  return (int)cudaGetLastError();
}

template <typename T, typename I>
void sparsify_t(const T* x, const float* t, float* out, long long total,
                long long n, cudaStream_t st) {
  const bool vec = n % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(out, 16);
  const int grid = grid_for(vec ? total / 4 : total);
  if (vec)
    sparsify_kernel<T, I, true><<<grid, THREADS, 0, st>>>(x, t, out, (I)total,
                                                          (I)n);
  else
    sparsify_kernel<T, I, false><<<grid, THREADS, 0, st>>>(x, t, out,
                                                           (I)total, (I)n);
}

constexpr long long SMEM_MAX = 200 * 1024;  // of the 227 KB a block may use

int padded_n(long long n) { return n <= 4 ? 4 : 8; }

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

int warp_row_blocks(long long m) {
  const long long blocks = (m + WARPS - 1) / WARPS;
  return (int)(blocks > GRID_CAP ? GRID_CAP : blocks);
}

// slices of a dimension of `len` over blocks: enough for ~4 blocks a SM
// beside `mblocks` blocks along m, at least `least_slice` a slice, and each
// slice's `bytes_per` bytes a unit of it within shared memory
int slices(long long mblocks, long long len, long long bytes_per,
           long long least_slice) {
  long long s = ceil_div(4 * 132, mblocks);
  const long long most = ceil_div(len, least_slice);
  if (s > most) s = most;
  const long long least = ceil_div(len * bytes_per, SMEM_MAX);
  if (s < least) s = least;
  return (int)(s < 1 ? 1 : s);
}

// split-K slices of the two skinny routes (M @ Q0, M^T @ P; b's rows are
// np floats) and the column slices of the small-k route (the decode)
int rows_splits(long long m, long long n, long long k) {
  return slices(warp_row_blocks(m), k, 4LL * padded_n(n), 256);
}
int cols_splits(long long m, long long n, long long k) {
  return slices(ceil_div(m, THREADS), k, 4LL * padded_n(n), 64);
}
int smallk_slices(long long m, long long n, long long k) {
  return slices(warp_row_blocks(m), n, 4 * k, 256);
}

// launch with `bytes` of dynamic shared memory, opting in above 48 KB
template <typename K>
cudaError_t allow_smem(K kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

enum Route { ROWS = 0, COLS = 1, SMALLK = 2, TILED = 3 };

Route mm_route(long long n, long long k, long long sam, long long sak) {
  if (n <= SMALL && sak == 1) return ROWS;
  if (n <= SMALL && sam == 1) return COLS;
  if (k <= SMALL) return SMALLK;
  return TILED;
}

template <typename T>
int matmul_t(const T* a, const T* b, float* out, float* partial, long long m,
             long long n, long long k, long long sam, long long sak,
             long long sbk, long long sbn, int* launches, cudaStream_t st) {
  *launches = 1;
  const int np = padded_n(n);
  switch (mm_route(n, k, sam, sak)) {
    case ROWS:
    case COLS: {
      const bool rows = mm_route(n, k, sam, sak) == ROWS;
      const int s = rows ? rows_splits(m, n, k) : cols_splits(m, n, k);
      const long long kslice = (k + s - 1) / s;
      const long long bytes = 4 * kslice * np;
      const dim3 grid(rows ? warp_row_blocks(m) : ceil_div(m, THREADS), s);
      float* dst = s > 1 ? partial : out;
      cudaError_t err;
      if (rows && np == 4) {
        err = allow_smem(mm_rows_kernel<T, 4>, bytes);
        if (err == cudaSuccess)
          mm_rows_kernel<T, 4><<<grid, THREADS, bytes, st>>>(
              a, b, dst, m, k, (int)n, sam, sbk, sbn, kslice);
      } else if (rows) {
        err = allow_smem(mm_rows_kernel<T, 8>, bytes);
        if (err == cudaSuccess)
          mm_rows_kernel<T, 8><<<grid, THREADS, bytes, st>>>(
              a, b, dst, m, k, (int)n, sam, sbk, sbn, kslice);
      } else if (np == 4) {
        err = allow_smem(mm_cols_kernel<T, 4>, bytes);
        if (err == cudaSuccess)
          mm_cols_kernel<T, 4><<<grid, THREADS, bytes, st>>>(
              a, b, dst, m, k, (int)n, sak, sbk, sbn, kslice);
      } else {
        err = allow_smem(mm_cols_kernel<T, 8>, bytes);
        if (err == cudaSuccess)
          mm_cols_kernel<T, 8><<<grid, THREADS, bytes, st>>>(
              a, b, dst, m, k, (int)n, sak, sbk, sbn, kslice);
      }
      if (err != cudaSuccess) return (int)err;
      if (s > 1) {
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        splitk_reduce_kernel<<<grid_for(m * n), THREADS, 0, st>>>(
            partial, out, m * n, s);
        *launches = 2;
      }
      break;
    }
    case SMALLK: {
      const int s = smallk_slices(m, n, k);
      const long long nslice = (n + s - 1) / s;
      const long long bytes = 4 * k * nslice;
      const dim3 grid(warp_row_blocks(m), s);
      cudaError_t err = allow_smem(mm_smallk_kernel<T>, bytes);
      if (err != cudaSuccess) return (int)err;
      mm_smallk_kernel<T><<<grid, THREADS, bytes, st>>>(
          a, b, out, m, n, (int)k, sam, sak, sbk, sbn, nslice);
      break;
    }
    case TILED: {
      const dim3 grid((unsigned)((n + TN - 1) / TN),
                      (unsigned)((m + TM - 1) / TM));
      mm_tiled_kernel<T><<<grid, THREADS, 0, st>>>(a, b, out, m, n, k, sam,
                                                   sak, sbk, sbn);
      break;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 f32, 1 bf16.  Each function returns a cudaError_t (0 on
// success) and writes the number of kernels it launched to *launches.

// f32 values of workspace compress_quantize needs for an (m, n) input
extern "C" long long compress_quantize_workspace(long long m, long long n) {
  if (n <= SHORT_ROW) return 0;
  int bpr;
  long long slice;
  long_plan(n, &bpr, &slice);
  return m * bpr;
}

extern "C" int compress_quantize(const void* x, int dtype, const void* rnd,
                                 void* q, void* scale, void* workspace,
                                 long long m, long long n, int bits,
                                 int stochastic, int* launches,
                                 void* stream) {
  *launches = 0;
  if (m < 1 || n < 1 || (bits != 8 && bits != 4) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  auto st = static_cast<cudaStream_t>(stream);
  auto* r = static_cast<const uint32_t*>(rnd);
  auto* qq = static_cast<int8_t*>(q);
  auto* s = static_cast<float*>(scale);
  auto* w = static_cast<float*>(workspace);
  if (dtype == 0) {
    auto* xx = static_cast<const float*>(x);
    return stochastic
        ? quantize_t<float, true>(xx, r, qq, s, w, m, n, qmax, launches, st)
        : quantize_t<float, false>(xx, r, qq, s, w, m, n, qmax, launches, st);
  }
  auto* xx = static_cast<const __nv_bfloat16*>(x);
  return stochastic
      ? quantize_t<__nv_bfloat16, true>(xx, r, qq, s, w, m, n, qmax, launches,
                                        st)
      : quantize_t<__nv_bfloat16, false>(xx, r, qq, s, w, m, n, qmax,
                                         launches, st);
}

extern "C" int compress_dequantize(const void* q, const void* scale, void* out,
                                   long long m, long long n, int* launches,
                                   void* stream) {
  *launches = 0;
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const int8_t*>(q);
  auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  const long long total = m * n;
  const bool vec = n % 4 == 0 && aligned(q, 4) && aligned(out, 16);
  const int grid = grid_for(vec ? total / 4 : total);
  if (total < (1LL << 31)) {
    if (vec)
      dequant_kernel<unsigned, true><<<grid, THREADS, 0, st>>>(
          qq, s, o, (unsigned)total, (unsigned)n);
    else
      dequant_kernel<unsigned, false><<<grid, THREADS, 0, st>>>(
          qq, s, o, (unsigned)total, (unsigned)n);
  } else {
    if (vec)
      dequant_kernel<unsigned long long, true><<<grid, THREADS, 0, st>>>(
          qq, s, o, (unsigned long long)total, (unsigned long long)n);
    else
      dequant_kernel<unsigned long long, false><<<grid, THREADS, 0, st>>>(
          qq, s, o, (unsigned long long)total, (unsigned long long)n);
  }
  *launches = 1;
  return (int)cudaGetLastError();
}

extern "C" int compress_sparsify(const void* x, int dtype, const void* thresh,
                                 void* out, long long m, long long n,
                                 int* launches, void* stream) {
  *launches = 0;
  if (m < 1 || n < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<const float*>(thresh);
  auto* o = static_cast<float*>(out);
  const long long total = m * n;
  const bool small = total < (1LL << 31);
  if (dtype == 0) {
    auto* xx = static_cast<const float*>(x);
    small ? sparsify_t<float, unsigned>(xx, t, o, total, n, st)
          : sparsify_t<float, unsigned long long>(xx, t, o, total, n, st);
  } else {
    auto* xx = static_cast<const __nv_bfloat16*>(x);
    small ? sparsify_t<__nv_bfloat16, unsigned>(xx, t, o, total, n, st)
          : sparsify_t<__nv_bfloat16, unsigned long long>(xx, t, o, total, n,
                                                          st);
  }
  *launches = 1;
  return (int)cudaGetLastError();
}

// f32 values of workspace compress_matmul needs (the split-K partials)
extern "C" long long compress_matmul_workspace(long long m, long long n,
                                               long long k, long long sam,
                                               long long sak) {
  const Route route = mm_route(n, k, sam, sak);
  if (route != ROWS && route != COLS) return 0;
  const int s = route == ROWS ? rows_splits(m, n, k) : cols_splits(m, n, k);
  return s > 1 ? (long long)s * m * n : 0;
}

extern "C" int compress_matmul(const void* a, const void* b, void* out,
                               void* workspace, long long m, long long n,
                               long long k, long long sam, long long sak,
                               long long sbk, long long sbn, int dtype,
                               int* launches, void* stream) {
  *launches = 0;
  if (m < 1 || n < 1 || k < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  auto* w = static_cast<float*>(workspace);
  if (dtype == 0)
    return matmul_t(static_cast<const float*>(a), static_cast<const float*>(b),
                    o, w, m, n, k, sam, sak, sbk, sbn, launches, st);
  return matmul_t(static_cast<const __nv_bfloat16*>(a),
                  static_cast<const __nv_bfloat16*>(b), o, w, m, n, k, sam,
                  sak, sbk, sbn, launches, st);
}

extern "C" const char* compress_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
