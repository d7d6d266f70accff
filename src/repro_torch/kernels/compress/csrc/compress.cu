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
// Dequantize (redesigned): one item of 16 values a thread (one 16-byte
// load of q; the warp's four float4 stores coalesced through shared
// memory) where n % 16 == 0 and q is 16-byte aligned, else items of 4 or 1
// (the variant is the caller's, from the layout: ``dequantize_variant`` in
// ops.py); at most one full wave of blocks, so a ring chunk (262,144
// items) is 1,024 blocks and no thread loops; with one row (every ring
// hop, every per-tensor scale) the scale is read once, else a value's row
// comes from a multiply-shift computed on the host (no integer division on
// the card).
// Sparsify (redesigned): items of 4 values (a 16-byte load of f32, 8 bytes
// of bf16, so that every warp's float4 store stays 512 contiguous bytes)
// where n % 4 == 0 and x is aligned, else single values; one item a
// thread and no loop (tools/sparsify_bench.py at 494M values on the card:
// 1.296 ms; two or four items a thread 1.300 and 1.304, a one-wave grid
// looping over the payload 1.368, the streaming cache hints no gain); the
// payload-level op passes one row with one threshold, other callers' rows
// come from the same multiply-shift as dequantize's.
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
//    along m): only 3,584 outputs over k = 152,064.  Where M's rows are
//    16-byte aligned and M is large (``cols_bulk``, the codec's layout for
//    the embedding gradient): a persistent grid of one wave, a block an
//    SM, each owning a contiguous range of M's rows
//    (and, above 1,024 columns, a slice of them); one producer thread
//    streams M through a ring of up to 8 stages of whole rows (~24 KB a
//    stage) in shared memory with 1-D bulk copies (cp.async.bulk, no
//    tensor map) completing on mbarriers, so ~170 KB of M is in flight per
//    SM; 8 consumer warps read a row as float4s, each thread 4 columns
//    with 4 x n sums in registers, P's value a broadcast.  P's slice is
//    staged into shared memory once, coalesced along k for QR's
//    column-major P (along the row for a row-major P), while the first
//    stages of M are in flight.  The stream costs ~10 us to fill and
//    drain, so below ~48 MiB of M (the MLP's 17 MB and every smaller
//    gradient) and for rows of M under 512 bytes the plain route is
//    faster.  That route (``cols``): one thread per row of a (coalesced
//    along m), split-K over blocks to fill the card (each block's slice of
//    P read as a broadcast).
//  * the decode P @ Q^T, k = 4 with a 545 MB output: one warp per output
//    row, its 4 values of P in registers, lanes along n, writes coalesced;
//    n sliced over blocks where b exceeds shared memory.
//  * anything else: a plain 64 x 64 tiled product on the CUDA cores.
// The route is the caller's, from shape, strides and alignment
// (``matmul_variant`` in ops.py); the entry point refuses a route the
// operands do not fit.  Split-K partials are summed by a second pass in a
// fixed order (deterministic, no atomicAdd).
// All in full f32 on the CUDA cores: no TF32, which keeps ~3 digits and
// would fail the 1e-5 tolerance of the JAX test.
//
// Traps handled here:
//  * bit-equality with the plain version: x / scale is a true IEEE
//    division (no --use_fast_math, so -prec-div stays on), rounding is
//    rintf (half to even, as torch.round and jnp.round), and the scale is
//    max(absmax, 1e-30f) / qmax in f32, as the reference computes it.
//  * rows of any length: the vector paths need n % 4 == 0 (16 for
//    dequantize's) and aligned pointers, checked here; otherwise the
//    scalar paths run.
//  * the return code: every entry point returns the number of kernels it
//    launched in its low four bits and the cudaError_t of a refused launch
//    above them, so the caller counts launches without an out-parameter.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "../../hopper.cuh"

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

// a / d for 0 <= a < 2^63 and a divisor d >= 1 fixed for a launch, as a
// multiply and a shift (division by an invariant integer): mul = ceil(2^p /
// d) with p = 63 + ceil(log2 d) fits 64 bits, and a * (mul d - 2^p) < 2^p
// makes the quotient exact; d == 1 (mul 0) passes a through
struct FastDiv {
  unsigned long long mul;
  int shift;  // p - 64
  __device__ __forceinline__ long long operator()(long long a) const {
    return mul ? (long long)(__umul64hi((unsigned long long)a, mul) >> shift)
               : a;
  }
};

FastDiv fast_div(long long d) {
  FastDiv f{0ull, 0};
  if (d <= 1) return f;
  const int l = 64 - __builtin_clzll((unsigned long long)(d - 1));
  const unsigned __int128 p2 = (unsigned __int128)1 << (63 + l);
  f.mul = (unsigned long long)((p2 + (unsigned long long)(d - 1)) /
                               (unsigned long long)d);
  f.shift = l - 1;
  return f;
}

// four int8 packed in w (lowest byte first), each times s
__device__ __forceinline__ float4 scale4(int w, float s) {
  return make_float4((float)(int8_t)w * s, (float)(int8_t)(w >> 8) * s,
                     (float)(int8_t)(w >> 16) * s,
                     (float)(int8_t)(w >> 24) * s);
}

enum DqVariant { DQ_VEC16 = 0, DQ_VEC4 = 1, DQ_SCALAR = 2 };

// An item is 16 values (vec16), 4 or 1.  vec16: each thread loads one
// 16-byte item, the warp's 32 items go through shared memory, and the
// warp's four float4 stores each write 512 contiguous bytes (a thread's own
// 64 bytes, stored by itself, would leave every store instruction strided:
// 1.7x slower at the gradient rows).  The grid is at most one full wave
// (8 blocks an SM) and loops; a ring chunk's 262,144 items take 1,024
// blocks, one item a thread.  ONE_ROW reads the single scale once; else a
// value's row is its 4-value word (or, scalar, the value) divided by the
// words (values) of a row: row_of, a multiply-shift.
template <int V, bool ONE_ROW>
__global__ void __launch_bounds__(THREADS, 8)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               float* __restrict__ out, long long items, FastDiv row_of) {
  __shared__ int4 stage[V == 16 ? THREADS : 1];
  const float s1 = ONE_ROW ? __ldg(scale) : 0.f;
  const int lane = threadIdx.x % 32, wbase = threadIdx.x - lane;
  const long long step = (long long)gridDim.x * THREADS;
  for (long long b0 = (long long)blockIdx.x * THREADS; b0 < items;
       b0 += step) {
    const long long g = b0 + threadIdx.x;
    if (V == 16) {
      stage[threadIdx.x] = g < items
          ? __ldg(reinterpret_cast<const int4*>(q) + g)
          : make_int4(0, 0, 0, 0);
      __syncwarp();
      const int* words = reinterpret_cast<const int*>(stage + wbase);
      const long long w0 = 4 * (b0 + wbase), words_total = 4 * items;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long w = w0 + 32 * i + lane;
        if (w < words_total)
          reinterpret_cast<float4*>(out)[w] = scale4(
              words[32 * i + lane], ONE_ROW ? s1 : __ldg(scale + row_of(w)));
      }
      __syncwarp();  // the stage is written again next step
    } else if (V == 4) {
      if (g < items)
        reinterpret_cast<float4*>(out)[g] =
            scale4(__ldg(reinterpret_cast<const int*>(q) + g),
                   ONE_ROW ? s1 : __ldg(scale + row_of(g)));
    } else if (g < items) {
      out[g] = (float)__ldg(q + g) * (ONE_ROW ? s1 : __ldg(scale + row_of(g)));
    }
  }
}

// ---- K3: where(|x| >= t_row, x, 0) ----------------------------------------
__device__ __forceinline__ float keep(float v, float t) {
  return fabsf(v) >= t ? v : 0.f;
}

// Vector variant: an item is 4 values (n % 4 == 0, x aligned to them): a
// 16-byte load of f32, 8 bytes of bf16, so that every warp's float4 store
// writes 512 contiguous bytes; one item a thread, a block of consecutive
// items, no loop.  ONE_ROW reads the threshold once; else an item's row
// is its index over the items of a row, a multiply-shift (no integer
// division on the card).
template <typename T, bool ONE_ROW>
__global__ void __launch_bounds__(THREADS)
sparsify_vec_kernel(const T* __restrict__ x, const float* __restrict__ thresh,
                    float* __restrict__ out, long long items,
                    FastDiv row_of) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= items) return;
  float f[4];
  load4(x + 4 * g, f);
  const float t = __ldg(thresh + (ONE_ROW ? 0 : row_of(g)));
  reinterpret_cast<float4*>(out)[g] = make_float4(
      keep(f[0], t), keep(f[1], t), keep(f[2], t), keep(f[3], t));
}

// Scalar variant (n % 4 != 0 or x misaligned): one value an item, one item
// a thread.
template <typename T, bool ONE_ROW>
__global__ void __launch_bounds__(THREADS)
sparsify_scalar_kernel(const T* __restrict__ x,
                       const float* __restrict__ thresh,
                       float* __restrict__ out, long long total,
                       FastDiv row_of) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < total)
    out[i] = keep(to_f(x[i]), __ldg(thresh + (ONE_ROW ? 0 : row_of(i))));
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

__host__ __device__ __forceinline__ long long lmin(long long x, long long y) {
  return x < y ? x : y;
}

constexpr int BULK_CONSUMERS = 256;  // 8 warps, 4 columns a thread
constexpr int BULK_THREADS = BULK_CONSUMERS + 32;  // and one producer warp
constexpr long long BULK_COLS = 4 * BULK_CONSUMERS;  // widest column slice

// n <= NP, a with unit stride along m and 16-byte aligned rows (M^T as a
// view of a row-major M): block (x, y) owns rows [x kslice, +kslice) of M
// (k of a) and columns [y width, +width) of them.  The producer thread
// streams M through ``stages`` slots of ``rows`` rows each (one bulk copy a
// row; full[s] counts the bytes in, empty[s] the consumer warps done); the
// consumers keep acc[column][j] for their 4 columns.  Columns past the
// last 16-byte boundary of a ragged slice come from global memory.  Writes
// partials[x][row][j], or out when there is one split.
template <typename T, int NP>
__global__ void __launch_bounds__(BULK_THREADS, 1)
mm_bulk_kernel(const T* __restrict__ a, const T* __restrict__ b,
               float* __restrict__ dst, long long m, long long k, int n,
               long long sak, long long sbk, long long sbn, long long width,
               long long kslice, int rows, int stages) {
  extern __shared__ float4 bulk_smem[];
  constexpr int QW = 16 / sizeof(T);  // columns in 16 bytes
  T* ring = reinterpret_cast<T*>(bulk_smem);
  float* sP = reinterpret_cast<float*>(ring + (long long)stages * rows * width);
  uint64_t* full = reinterpret_cast<uint64_t*>(sP + (kslice * NP + 3) / 4 * 4);
  uint64_t* empty = full + stages;

  const long long k0 = (long long)blockIdx.x * kslice;
  const long long krows = lmin(kslice, k - k0);
  const long long c0 = (long long)blockIdx.y * width;
  const long long wcols = lmin(width, m - c0);
  const long long wbulk = wcols / QW * QW;  // columns the bulk copies bring
  const int steps = (int)((krows + rows - 1) / rows);
  const int cwarps = (int)((wcols + 127) / 128);  // consumer warps with work
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], cwarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == BULK_CONSUMERS / 32) {  // the producer
    if (lane == 0 && wbulk > 0) {
      const uint32_t row_bytes = (uint32_t)(wbulk * sizeof(T));
      for (int it = 0; it < steps; ++it) {
        const int s = it % stages;
        if (it >= stages) hopper::mbar_wait(&empty[s], ((it / stages) - 1) & 1);
        const long long r0 = (long long)it * rows;
        const int nr = (int)lmin(rows, krows - r0);
        hopper::mbar_expect_tx(&full[s], nr * row_bytes);
        T* slot = ring + (long long)s * rows * width;
        const T* src = a + (k0 + r0) * sak + c0;
        for (int r = 0; r < nr; ++r)
          hopper::bulk_load(slot + r * width, src + r * sak, row_bytes,
                            &full[s]);
      }
    }
    return;
  }

  // P's slice as rows of NP f32 (zero-padded), while the first stages of M
  // are in flight: along k for a column-major P (QR's output), along the
  // row for a row-major one; coalesced either way
  if (sbk == 1) {
    for (int j = 0; j < NP; ++j)
      for (long long kk = threadIdx.x; kk < krows; kk += BULK_CONSUMERS)
        sP[kk * NP + j] = j < n ? to_f(b[k0 + kk + j * sbn]) : 0.f;
  } else {
    for (long long e = threadIdx.x; e < krows * NP; e += BULK_CONSUMERS) {
      const long long kk = e / NP;
      const int j = (int)(e % NP);
      sP[e] = j < n ? to_f(b[(k0 + kk) * sbk + j * sbn]) : 0.f;
    }
  }
  hopper::named_sync(1, BULK_CONSUMERS);
  if (warp >= cwarps) return;

  const long long col = 4LL * threadIdx.x;    // within the slice
  const bool staged = col + 4 <= wbulk;       // all 4 in shared memory
  const bool tail = !staged && col < wcols;   // some past the bulk copies
  float acc[4][NP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NP; ++j) acc[i][j] = 0.f;
  for (int it = 0; it < steps; ++it) {
    const int s = it % stages;
    const long long r0 = (long long)it * rows;
    const int nr = (int)lmin(rows, krows - r0);
    if (wbulk > 0) hopper::mbar_wait(&full[s], (it / stages) & 1);
    const T* slot = ring + (long long)s * rows * width + col;
    for (int r = 0; r < nr; ++r) {
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (staged) {
        load4(slot + r * width, f);
      } else if (tail) {
        const T* g = a + (k0 + r0 + r) * sak + c0 + col;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (col + i < wcols) f[i] = to_f(g[i]);
      }
      const float4* p = reinterpret_cast<const float4*>(sP + (r0 + r) * NP);
#pragma unroll
      for (int jq = 0; jq < NP / 4; ++jq) {
        const float4 v = p[jq];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jq + 0] = fmaf(f[i], v.x, acc[i][4 * jq + 0]);
          acc[i][4 * jq + 1] = fmaf(f[i], v.y, acc[i][4 * jq + 1]);
          acc[i][4 * jq + 2] = fmaf(f[i], v.z, acc[i][4 * jq + 2]);
          acc[i][4 * jq + 3] = fmaf(f[i], v.w, acc[i][4 * jq + 3]);
        }
      }
    }
    __syncwarp();
    if (wbulk > 0 && lane == 0) hopper::mbar_arrive(&empty[s]);
  }
  float* d = dst + ((long long)blockIdx.x * m + c0 + col) * n;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < wcols)
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if (j < n) d[i * n + j] = acc[i][j];
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

// the return code of the entry points: the kernels launched in the low four
// bits, the cudaError_t of a refused launch above them (0 on success).  The
// last of ``launched`` launches is the one cudaGetLastError speaks for.
constexpr int INVALID = (int)cudaErrorInvalidValue << 4;

int done(int launched) {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? launched : ((int)err << 4) | (launched - 1);
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
               cudaStream_t st) {
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
    return done(1);
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
  const int first = done(1);
  if (first != 1) return first;
  if (vec)
    quant_long_kernel<T, STOCH, true><<<grid, THREADS, 0, st>>>(
        x, rnd, partial, q, scale, m, n, slice, qmax);
  else
    quant_long_kernel<T, STOCH, false><<<grid, THREADS, 0, st>>>(
        x, rnd, partial, q, scale, m, n, slice, qmax);
  return done(2);
}

// rows are counted in 4-value words by the vector variants
template <int V>
void dequantize_t(const int8_t* q, const float* scale, float* out,
                  long long m, long long n, cudaStream_t st) {
  const long long items = m * n / V;
  const long long wave = 8LL * hopper::sm_count();
  const long long blocks = (items + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(blocks < wave ? blocks : wave);
  if (m == 1)
    dequant_kernel<V, true><<<grid, THREADS, 0, st>>>(q, scale, out, items,
                                                      FastDiv{0ull, 0});
  else
    dequant_kernel<V, false><<<grid, THREADS, 0, st>>>(
        q, scale, out, items, fast_div(V == 1 ? n : n / 4));
}

// rows are counted in items (4 values or 1)
template <typename T>
void sparsify_t(const T* x, const float* t, float* out, long long m,
                long long n, cudaStream_t st) {
  const bool vec =
      n % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(out, 16);
  const long long items = vec ? m * n / 4 : m * n;
  const unsigned grid = (unsigned)((items + THREADS - 1) / THREADS);
  const FastDiv row_of = m == 1 ? FastDiv{0ull, 0}
                                : fast_div(vec ? n / 4 : n);
  if (vec && m == 1)
    sparsify_vec_kernel<T, true><<<grid, THREADS, 0, st>>>(x, t, out, items,
                                                           row_of);
  else if (vec)
    sparsify_vec_kernel<T, false><<<grid, THREADS, 0, st>>>(x, t, out, items,
                                                            row_of);
  else if (m == 1)
    sparsify_scalar_kernel<T, true><<<grid, THREADS, 0, st>>>(x, t, out,
                                                              items, row_of);
  else
    sparsify_scalar_kernel<T, false><<<grid, THREADS, 0, st>>>(x, t, out,
                                                               items, row_of);
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

// the streamed M^T @ P (cols_bulk): column slices of at most BULK_COLS, a
// split of k for at most one block an SM beside them (one wave; at least
// BULK_MIN_ROWS rows a block, P's slice within BULK_P_MAX bytes, which may
// take more), stages of ~BULK_STAGE
// bytes of whole rows, as many as shared memory holds up to BULK_STAGES
// (and no more than a block's rows fill)
constexpr long long BULK_STAGE = 24 * 1024;
constexpr long long BULK_STAGES = 8;
constexpr long long BULK_MIN_ROWS = 16;
constexpr long long BULK_P_MAX = 64 * 1024;

struct BulkPlan {
  int ksplits, mslices, rows, stages;
  long long kslice, width, smem;
};

BulkPlan bulk_plan(long long m, long long n, long long k, int esize) {
  BulkPlan p;
  const long long qw = 16 / esize;
  p.mslices = ceil_div(m, BULK_COLS);
  p.width = (ceil_div(m, p.mslices) + qw - 1) / qw * qw;
  const long long np = padded_n(n);
  long long s = hopper::sm_count() / p.mslices;  // one wave
  s = lmin(s, ceil_div(k, BULK_MIN_ROWS));
  const long long least = ceil_div(k * np * 4, BULK_P_MAX);
  if (s < least) s = least;
  p.kslice = (k + s - 1) / s;
  p.ksplits = ceil_div(k, p.kslice);  // no block without rows
  const long long row_bytes = p.width * esize;
  const long long rows = lmin(BULK_STAGE / row_bytes > 1
                                  ? BULK_STAGE / row_bytes : 1, p.kslice);
  p.rows = (int)rows;
  const long long pbytes = (p.kslice * np + 3) / 4 * 16;
  p.stages = (int)lmin(lmin(BULK_STAGES, ceil_div(p.kslice, rows)),
                       (SMEM_MAX - pbytes - 16 * BULK_STAGES) /
                           (rows * row_bytes));
  p.smem = p.stages * rows * row_bytes + pbytes + 16LL * p.stages;
  return p;
}

// launch with `bytes` of dynamic shared memory, opting in above 48 KB
template <typename K>
cudaError_t allow_smem(K kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the routes of ops.py's matmul_variant, in its order
enum Route { ROWS = 0, COLS = 1, SMALLK = 2, TILED = 3, COLS_BULK = 4 };

// whether the operands fit the route's kernel
bool route_fits(int route, const void* a, int esize, long long n, long long k,
                long long sam, long long sak) {
  switch (route) {
    case ROWS: return n <= SMALL && sak == 1;
    case COLS: return n <= SMALL && sam == 1;
    case COLS_BULK:
      return n <= SMALL && sam == 1 && aligned(a, 16) &&
             (sak * esize) % 16 == 0;
    case SMALLK: return k <= SMALL;
    case TILED: return true;
  }
  return false;
}

// split-K slices of a route (1: no partials)
int route_splits(int route, long long m, long long n, long long k, int esize) {
  switch (route) {
    case ROWS: return rows_splits(m, n, k);
    case COLS: return cols_splits(m, n, k);
    case COLS_BULK: return bulk_plan(m, n, k, esize).ksplits;
  }
  return 1;
}

template <typename T, int NP>
int launch_bulk(const T* a, const T* b, float* dst, long long m, long long n,
                long long k, long long sak, long long sbk, long long sbn,
                const BulkPlan& p, cudaStream_t st) {
  const cudaError_t err = allow_smem(mm_bulk_kernel<T, NP>, p.smem);
  if (err != cudaSuccess) return (int)err << 4;
  mm_bulk_kernel<T, NP><<<dim3(p.ksplits, p.mslices), BULK_THREADS, p.smem,
                          st>>>(a, b, dst, m, k, (int)n, sak, sbk, sbn,
                                p.width, p.kslice, p.rows, p.stages);
  return done(1);
}

template <typename T>
int matmul_t(const T* a, const T* b, float* out, float* partial, long long m,
             long long n, long long k, long long sam, long long sak,
             long long sbk, long long sbn, int route, cudaStream_t st) {
  const int np = padded_n(n);
  int s = 1, rc = 1;
  switch (route) {
    case ROWS:
    case COLS: {
      const bool rows = route == ROWS;
      s = rows ? rows_splits(m, n, k) : cols_splits(m, n, k);
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
      if (err != cudaSuccess) return (int)err << 4;
      rc = done(1);
      break;
    }
    case COLS_BULK: {
      const BulkPlan p = bulk_plan(m, n, k, sizeof(T));
      s = p.ksplits;
      float* dst = s > 1 ? partial : out;
      rc = np == 4
               ? launch_bulk<T, 4>(a, b, dst, m, n, k, sak, sbk, sbn, p, st)
               : launch_bulk<T, 8>(a, b, dst, m, n, k, sak, sbk, sbn, p, st);
      break;
    }
    case SMALLK: {
      const int ns = smallk_slices(m, n, k);
      const long long nslice = (n + ns - 1) / ns;
      const long long bytes = 4 * k * nslice;
      const dim3 grid(warp_row_blocks(m), ns);
      const cudaError_t err = allow_smem(mm_smallk_kernel<T>, bytes);
      if (err != cudaSuccess) return (int)err << 4;
      mm_smallk_kernel<T><<<grid, THREADS, bytes, st>>>(
          a, b, out, m, n, (int)k, sam, sak, sbk, sbn, nslice);
      return done(1);
    }
    default: {  // TILED
      const dim3 grid((unsigned)((n + TN - 1) / TN),
                      (unsigned)((m + TM - 1) / TM));
      mm_tiled_kernel<T><<<grid, THREADS, 0, st>>>(a, b, out, m, n, k, sam,
                                                   sak, sbk, sbn);
      return done(1);
    }
  }
  if (rc != 1 || s == 1) return rc;
  splitk_reduce_kernel<<<grid_for(m * n), THREADS, 0, st>>>(partial, out,
                                                            m * n, s);
  return done(2);
}

}  // namespace

// dtype codes: 0 f32, 1 bf16.  Each function returns the number of kernels
// it launched in its low four bits and, above them, the cudaError_t of a
// refused launch or cudaErrorInvalidValue for operands it does not take (0
// on success).

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
                                 int stochastic, void* stream) {
  if (m < 1 || n < 1 || (bits != 8 && bits != 4) || dtype < 0 || dtype > 1)
    return INVALID;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  auto st = static_cast<cudaStream_t>(stream);
  auto* r = static_cast<const uint32_t*>(rnd);
  auto* qq = static_cast<int8_t*>(q);
  auto* s = static_cast<float*>(scale);
  auto* w = static_cast<float*>(workspace);
  if (dtype == 0) {
    auto* xx = static_cast<const float*>(x);
    return stochastic
        ? quantize_t<float, true>(xx, r, qq, s, w, m, n, qmax, st)
        : quantize_t<float, false>(xx, r, qq, s, w, m, n, qmax, st);
  }
  auto* xx = static_cast<const __nv_bfloat16*>(x);
  return stochastic
      ? quantize_t<__nv_bfloat16, true>(xx, r, qq, s, w, m, n, qmax, st)
      : quantize_t<__nv_bfloat16, false>(xx, r, qq, s, w, m, n, qmax, st);
}

// variant: a DqVariant, which the layout must allow (16 or 4 values an
// item need n a multiple of it and q aligned to it)
extern "C" int compress_dequantize(const void* q, const void* scale, void* out,
                                   long long m, long long n, int variant,
                                   void* stream) {
  const int v = variant == DQ_VEC16 ? 16 : variant == DQ_VEC4 ? 4
                : variant == DQ_SCALAR ? 1 : 0;
  if (m < 1 || n < 1 || v == 0 || n % v || !aligned(q, v) ||
      !aligned(out, v == 1 ? 4 : 16))
    return INVALID;
  auto st = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const int8_t*>(q);
  auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  if (v == 16)
    dequantize_t<16>(qq, s, o, m, n, st);
  else if (v == 4)
    dequantize_t<4>(qq, s, o, m, n, st);
  else
    dequantize_t<1>(qq, s, o, m, n, st);
  return done(1);
}

extern "C" int compress_sparsify(const void* x, int dtype, const void* thresh,
                                 void* out, long long m, long long n,
                                 void* stream) {
  if (m < 1 || n < 1 || dtype < 0 || dtype > 1) return INVALID;
  auto st = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<const float*>(thresh);
  auto* o = static_cast<float*>(out);
  if (dtype == 0)
    sparsify_t(static_cast<const float*>(x), t, o, m, n, st);
  else
    sparsify_t(static_cast<const __nv_bfloat16*>(x), t, o, m, n, st);
  return done(1);
}

// f32 values of workspace compress_matmul needs on a route (the split-K
// partials)
extern "C" long long compress_matmul_workspace(long long m, long long n,
                                               long long k, int route,
                                               int dtype) {
  const int s = route_splits(route, m, n, k, dtype == 0 ? 4 : 2);
  return s > 1 ? (long long)s * m * n : 0;
}

// route: a Route that the operands fit (route_fits)
extern "C" int compress_matmul(const void* a, const void* b, void* out,
                               void* workspace, long long m, long long n,
                               long long k, long long sam, long long sak,
                               long long sbk, long long sbn, int dtype,
                               int route, void* stream) {
  if (m < 1 || n < 1 || k < 1 || dtype < 0 || dtype > 1 ||
      !route_fits(route, a, dtype == 0 ? 4 : 2, n, k, sam, sak))
    return INVALID;
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  auto* w = static_cast<float*>(workspace);
  if (dtype == 0)
    return matmul_t(static_cast<const float*>(a), static_cast<const float*>(b),
                    o, w, m, n, k, sam, sak, sbk, sbn, route, st);
  return matmul_t(static_cast<const __nv_bfloat16*>(a),
                  static_cast<const __nv_bfloat16*>(b), o, w, m, n, k, sam,
                  sak, sbk, sbn, route, st);
}

extern "C" const char* compress_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
