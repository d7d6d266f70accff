// What the SSD scan's forward (ssd_scan_fwd.cu) and backward
// (ssd_scan_bwd.cu) kernels share: the chunk of Q rows, the block size, the
// warp's cumsum of dt a over a chunk, the layout of the forward's f32
// workspace, which the backward reads, the 3xTF32 products on mma.sync
// (the split, the fragments, a warp's tile of positions), the staging of
// tiles into shared memory, and the host's launch helpers.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;          // rows per chunk
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;

// One warp: cs = inclusive cumsum of dt * a over the chunk's `rows` rows,
// lane l holding rows 2l and 2l + 1; padded rows get dt = 0, so cs_Q is
// the last real row's.  Every block of a chunk computes the same cs, bit
// for bit.
struct LaneCumsum {
  float cs0, cs1, dt0, dt1, last;  // rows 2l, 2l + 1; cs_Q
};
__device__ __forceinline__ LaneCumsum chunk_cumsum(
    const float* __restrict__ dtb, long long sdl, float ah, int rows) {
  const int lane = threadIdx.x % 32;
  const int j0 = 2 * lane, j1 = j0 + 1;
  LaneCumsum r;
  r.dt0 = j0 < rows ? dtb[j0 * sdl] : 0.f;
  r.dt1 = j1 < rows ? dtb[j1 * sdl] : 0.f;
  const float v0 = r.dt0 * ah, v1 = r.dt1 * ah;
  float s = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) excl = 0.f;
  r.cs0 = excl + v0;
  r.cs1 = excl + v0 + v1;
  r.last = __shfl_sync(0xffffffffu, r.cs1, 31);
  return r;
}

// floats of each part of the forward's workspace: the states after chunks
// 0 .. nc-2 (B, H, nc-1, P, N), C B^T per batch row and chunk (B, nc, Q,
// Q), each chunk's exp(cs_Q) (B, H, nc; the last chunk's never written)
struct Workspace {
  long long state, cb, decay;
  Workspace(int B, int H, int L, int P, int N) {
    const long long nc = (L + Q - 1) / Q;
    state = (long long)B * H * (nc - 1) * P * N;
    cb = (long long)B * nc * Q * Q;
    decay = (long long)B * H * nc;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive values from p; vec: p is aligned to four of them
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool vec) {
  if (vec) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                       __high2float(hi));
  }
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
}

__device__ __forceinline__ void store2(float* p, float u, float v) {
  *reinterpret_cast<float2*>(p) = make_float2(u, v);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float u, float v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, v);
}

// ---- 3xTF32 on the tensor cores --------------------------------------------

// v = hi + lo: hi = v rounded to TF32 (half away from zero: add half of
// the 13 dropped bits, mask them; two integer operations, where cvt.rna
// takes the conversion unit), lo = v - hi exactly, passed whole (the
// tensor cores read its top 19 bits)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// D (16 x 8 f32) += A (16 x 8 tf32, row-major) B (8 x 8 tf32, column-major)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's fragments of one k-step, split
template <int MT, int NT>
struct Frags {
  uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
  template <typename FA, typename FB>
  __device__ __forceinline__ void load(int k0, FA& fa, FB& fb) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float v[4];
      fa(i, k0, v);
#pragma unroll
      for (int r = 0; r < 4; ++r) split(v[r], ah[i][r], al[i][r]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float v[2];
      fb(j, k0, v);
#pragma unroll
      for (int r = 0; r < 2; ++r) split(v[r], bh[j][r], bl[j][r]);
    }
  }
  // the three products, term by term over the positions, so that MT x NT
  // independent mmas stand between two on the same accumulator; the small
  // terms first
  __device__ __forceinline__ void mma(float (&acc)[MT][NT][4]) const {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
  }
};

// A warp's MT x NT mma positions (16 x 8 outputs each) over k in
// [k_begin, k_end), steps of 8, in 3xTF32.  With g = lane / 4, t = lane % 4:
//   fa(i, k0, v): v = A[m+g][k0+t], A[m+g+8][k0+t], A[m+g][k0+t+4],
//                 A[m+g+8][k0+t+4] of the i-th row tile;
//   fb(j, k0, v): v = B[k0+t][n+g], B[k0+t+4][n+g] of the j-th column tile.
// acc[i][j] holds outputs (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// PIPE loads and splits the next step's fragments while this step's
// products run (faster for stage (i) on the card); it doubles the
// fragments' registers, which stage (iii), at its register limit, cannot
// spare.
template <int MT, int NT, bool PIPE = false, typename FA, typename FB>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[MT][NT][4],
                                           int k_begin, int k_end, FA fa,
                                           FB fb) {
  if (!PIPE) {
    for (int k0 = k_begin; k0 < k_end; k0 += 8) {
      Frags<MT, NT> f;
      f.load(k0, fa, fb);
      f.mma(acc);
    }
    return;
  }
  if (k_begin >= k_end) return;
  Frags<MT, NT> f0, f1;
  f0.load(k_begin, fa, fb);
  for (int k0 = k_begin; k0 < k_end; k0 += 16) {
    const bool more = k0 + 8 < k_end;
    if (more) f1.load(k0 + 8, fa, fb);
    f0.mma(acc);
    if (!more) break;
    if (k0 + 16 < k_end) f0.load(k0 + 16, fa, fb);
    f1.mma(acc);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

// ---- staging tiles into shared memory --------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // 16 bytes global -> shared without registers; zeros where !valid
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// R rows of W values (W % 4 == 0) from src (row stride ld_src, unit stride
// along the row) into shared memory rows of LD floats, in f32; rows from
// `rows` on are zero.  f32 rows aligned to 16 bytes (vec) go by cp.async
// and land when the caller waits for their group; anything else (bf16,
// misaligned views) is loaded and stored here, all of a thread's loads
// issued before its stores.
template <int R, int W, int LD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld_src, int rows,
                                          bool vec) {
  constexpr int ITEMS = R * W / 4;
  constexpr int ITERS = (ITEMS + THREADS - 1) / THREADS;
  if constexpr (sizeof(T) == sizeof(float)) {
    if (vec) {
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int e = threadIdx.x + it * THREADS;
        const int r = e / (W / 4), c4 = e % (W / 4);
        if (e < ITEMS)
          cp_async16(dst + r * LD + 4 * c4,
                     r < rows ? src + r * ld_src + 4 * c4 : src, r < rows);
      }
      return;
    }
  }
  float4 v[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int r = e / (W / 4), c4 = e % (W / 4);
    v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < ITEMS && r < rows) v[it] = load4(src + r * ld_src + 4 * c4, vec);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int r = e / (W / 4), c4 = e % (W / 4);
    if (e < ITEMS) *reinterpret_cast<float4*>(dst + r * LD + 4 * c4) = v[it];
  }
}

// warps along the columns and rows of a warp grid for an M x NC output of
// 16 x 8 positions: up to 4 along the columns, the rest along the rows
template <int M, int NC>
struct WarpGrid {
  static constexpr int WN = NC / 8 < 4 ? NC / 8 : 4;
  static constexpr int WM = M / 16 < WARPS / WN ? M / 16 : WARPS / WN;
  static constexpr int MT = M / 16 / WM;
  static constexpr int NT = NC / 8 / WN;
  static_assert(MT * WM * 16 == M && NT * WN * 8 == NC, "warp grid");
};

constexpr int MAX_GROUP = WARPS;  // heads a block: one warp's cumsum each


// ---- host ------------------------------------------------------------------

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the number of launches in the low four bits, a refused launch's error
// above them
int done(int launched) {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? launched : ((int)err << 4) | (launched - 1);
}

// above 48 KB dynamic shared memory must be asked for
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return bytes <= 48 * 1024
             ? cudaSuccess
             : cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   (int)bytes);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// heads a block takes so that `tiles` (batch row, chunk, head, slice of P)
// fill about `blocks` blocks: at most MAX_GROUP
int group_for(long long tiles, long long blocks) {
  const long long g = (tiles + blocks - 1) / blocks;
  return (int)(g < 1 ? 1 : (g > MAX_GROUP ? MAX_GROUP : g));
}

}  // namespace
