// Flash-attention forward for Hopper (sm_90a): GQA, causal, sliding window.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:flash_attention_kernel
// (body _attn_kernel).  Same contract: q (B,H,Sq,D), k/v (B,KV,Sk,D), head h
// reads KV head h / (H/KV); scale 1/sqrt(D); running max, denominator and
// accumulator in f32; output in q's dtype; f32 or bf16 inputs.
//
// What bounds it on this card.  Per (64-row Q tile, 64-key K tile) the block
// does 2*64*64*D multiply-adds on 2*64*D loaded values.  Counting q, k, v and
// o once, the least time is set by bytes at short prompts (qwen2-0.5b,
// B 4 x S 512: 8.4 MB against 1.9 GFLOP) and by operations at the tensor-core
// rate (989 TFLOP/s bf16) from S ~ 1k on (S 4096).  This first version
// computes in f32 on the CUDA cores (67 TFLOP/s at most), so it is bound by
// its own operations at every serving shape.  What the design does about
// them: every operand sits in shared memory or registers (each thread owns a
// 4x4 block of the score tile and reads operands as float4, two loads per 16
// FMAs), Q, K and V are read from device memory once per tile, and K tiles
// that the masks empty are skipped.  Tensor cores (wgmma), TMA and a pipelined
// K/V ring are for a later version.
//
// Translation from the TPU kernel.  The TPU grid's sequential 4th dimension
// carried (m, l, acc) in VMEM scratch across K blocks; here one block owns a
// Q tile and loops over the K/V tiles itself, with (m, l, acc) in registers.
// Grid: (ceil(Sq/64), H, B), 256 threads.
//
// Traps handled here:
//  * The causal mask is top-left aligned: qpos >= kpos with both counted
//    from 0, also for Sq != Sk (many GPU kernels align bottom-right).
//  * Masking stays finite (NEG_INF = -1e30, never -inf).  Under a window a
//    row's leading tiles can be wholly masked: they add p = exp(0) = 1 terms
//    that the first real key wipes out through corr = exp(-1e30 - m) = 0;
//    with -inf that step would be exp(-inf + inf) = NaN.
//  * Tiles wholly past the diagonal (causal) are skipped, like the TPU
//    kernel.  Tiles wholly before the window are skipped only when every row
//    of the Q tile keeps at least one real key; then the skipped terms would
//    have been wiped out anyway and the result is the same.
//  * The ragged edges (Sq or Sk not a multiple of 64) are masked here: rows
//    past Sq are not stored, keys past Sk get p = 0 (they are absent, not
//    masked).
//  * Finalize with acc / max(l, 1e-30), as the TPU kernel does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per K/V tile
constexpr int THREADS = 256;      // 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3
constexpr int LDT = BQ + 4;       // padded row (floats) of the transposed Q/K tiles
constexpr int LDP = BK + 4;       // padded row (floats) of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * D * LDT + BK * D + BQ * LDP);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int H,
                      int group, int Sq, int Sk, int causal, int window,
                      float scale) {
  static_assert(D % 16 == 0, "each of the 16 column threads owns D/16 outputs");
  constexpr int DPT = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;              // [D][LDT]  Q tile, transposed
  float* sKt = sQt + D * LDT;     // [D][LDT]  K tile, transposed
  float* sV = sKt + D * LDT;      // [BK][D]   V tile
  float* sP = sV + BK * D;        // [BQ][LDP] probabilities of this K tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // score columns 4tx..4tx+3; output columns tx + 16i
  const int ty = tid / 16;  // rows 4ty..4ty+3 (16 lanes of one half-warp)
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;  // GQA: head h reads KV head h / (H/KV)
  const int num_kv = H / group;

  const T* qb = q + ((size_t)b * H + h) * (size_t)Sq * D;
  const T* kb = k + ((size_t)b * num_kv + kvh) * (size_t)Sk * D;
  const T* vb = v + ((size_t)b * num_kv + kvh) * (size_t)Sk * D;
  T* ob = o + ((size_t)b * H + h) * (size_t)Sq * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    sQt[c * LDT + r] = (q0 + r < Sq) ? to_f32(qb[(size_t)(q0 + r) * D + c]) : 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q_last < Sk - 1 + window)  // every row keeps a real key
    kt_begin = max(0, q0 - window + 1) / BK;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;  // this thread's share of the row's denominator
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sKt/sV/sP are no longer read
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < Sk;
      sKt[c * LDT + r] = in ? to_f32(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      sV[r * D + c] = in ? to_f32(vb[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&sQt[c * LDT + 4 * ty]);
      const float4 bk = *reinterpret_cast<const float4*>(&sKt[c * LDT + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        bool keep = true;
        if (causal) keep = keep && qpos >= kpos;
        if (window > 0) keep = keep && qpos - kpos < window;
        s[i][j] = keep ? s[i][j] * scale : NEG_INF;
        if (kpos < Sk) row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the row's 16 threads
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float p[4];
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = (k0 + 4 * tx + j < Sk) ? expf(s[i][j] - m_new) : 0.f;
        p_sum += p[j];
      }
      *reinterpret_cast<float4*>(&sP[(4 * ty + i) * LDP + 4 * tx]) =
          make_float4(p[0], p[1], p[2], p[3]);
      l[i] = l[i] * corr + p_sum;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[i][dd] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(&sP[(4 * ty + i) * LDP + j]);
        pr[i][0] = t.x; pr[i][1] = t.y; pr[i][2] = t.z; pr[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) {
          const float vv = sV[(j + jj) * D + tx + 16 * dd];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][dd] = fmaf(pr[i][jj], vv, acc[i][dd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l_row = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l_row += __shfl_xor_sync(0xffffffffu, l_row, off);
    const float denom = fmaxf(l_row, 1e-30f);
    const int row = q0 + 4 * ty + i;
    if (row < Sq) {
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd)
        store(&ob[(size_t)row * D + tx + 16 * dd], acc[i][dd] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KV, int Sq, int Sk, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attn_fwd_kernel<T, D>;
  // above 48 KB dynamic shared memory must be asked for, per device
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / KV, Sq, Sk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Sq, int Sk, int D, int causal,
                       int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  window <= 0: no window.  Returns the launch's
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int KV, int Sq, int Sk,
                              int D, int causal, int window, int dtype,
                              float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, B, H, KV, Sq, Sk, D, causal, window, scale, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, D, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
