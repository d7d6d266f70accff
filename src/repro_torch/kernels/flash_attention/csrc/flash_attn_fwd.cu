// Flash-attention forward for Hopper (sm_90a): GQA, causal, sliding window.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:flash_attention_kernel
// (body _attn_kernel).  Same contract: q (B,H,Sq,D), k/v (B,KV,Sk,D), head h
// reads KV head h / (H/KV); scale 1/sqrt(D); running max, denominator and
// accumulator in f32; output in q's dtype; f32 or bf16 inputs.  Every
// tensor is taken through its strides (unit stride along D, the others
// multiples of 16 bytes), so the model's (B,S,H,D) activations are read
// and written in place.
//
// What bounds it on this card.  Counting q, k, v and o once, the least
// time is set by bytes at short prompts (qwen2-0.5b, B 4 x S 512: 8.4 MB
// against 1.9 GFLOP) and by operations at the bf16 tensor-core rate (989
// TFLOP/s) from S ~ 1k on (S 4096), a rate only wgmma reaches; between
// the two products the online softmax (an exponential a score) keeps the
// CUDA cores and the special function unit busy.
//
// bf16 (replaces the previous version's f32 arithmetic on the CUDA cores,
// 67 TFLOP/s at most): the FlashAttention-3 shape.  A block owns 128 query
// rows of one head: two consumer warpgroups of 64 rows each, and one
// producer thread that loads the Q tile once and keeps a ring of 128-key K
// and V tiles full with TMA (4 stages at D 64, 3 at D 128: what shared
// memory holds; 128-byte swizzle, rank-4 tensor maps over the strided
// tensors), completing on mbarriers; setmaxnreg moves the producer's
// registers to the consumers.  Per K/V tile a consumer issues S = Q K^T
// with wgmma m64n128k16 (Q and K K-major from shared memory) and then the
// previous tile's O += P V (wgmma m64nDk16, P from registers, V MN-major
// as it lies: no transpose copy), and runs the masks and the online
// softmax of this tile in f32 registers (quad shuffles for the row max,
// ex2.approx for the exponentials, a branch-free copy for tiles without
// masked or absent keys) while the tensor cores work on P V; then it
// rescales O and turns P into bf16 registers in place -- the accumulator
// layout of S is the register A layout of P V.  Head dims 32 and 80 run
// padded to 64 and 128 columns: the tensor maps read zeros past D, which
// change neither Q K^T nor the stored columns.
//
// f32 (parity runs): full f32 on the CUDA cores (67 TFLOP/s at most) -- no
// TF32, which keeps ~3 decimal digits and would break the 2e-5 tolerance.
// Each thread owns a 4x4 block of a 64 x 64 score tile and reads operands
// as float4, two loads per 16 FMAs; Q, K and V are read once per tile.
//
// Translation from the TPU kernel.  The TPU grid's sequential 4th dimension
// carried (m, l, acc) in VMEM scratch across K blocks; here one block owns a
// Q tile and loops over the K/V tiles itself, with (m, l, acc) in registers.
// Grid: (ceil(Sq/BQ), H, B).
//
// Traps handled here (both variants):
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
//  * The ragged edges (Sq or Sk not a multiple of the tile) are masked here:
//    rows past Sq are not stored, keys past Sk get p = 0 (they are absent,
//    not masked).
//  * Finalize with acc / max(l, 1e-30), as the TPU kernel does.
//
// Row statistics for the backward (flash_attn_bwd.cu), both variants: with a
// non-null ``lse``, each query row's natural-log log-sum-exp of its scaled,
// masked scores, m + log(l), goes to lse[(b * H + h) * Sq + row] (f32); the
// bf16 variant converts its base-2 m + log2(l) with ln 2.  A row that keeps
// no key (m stays NEG_INF; only with a window and Sq > Sk) gets +inf: its
// output averages every key, and -1e30 + log(l) would round to -1e30, from
// which the backward could not recompute P = 1/Sk.  With a null pointer
// nothing more is written.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

#include "../../hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// first K/V tile and the end of the tiles a block of rows q0..q0+bq-1 reads
__device__ __forceinline__ void tile_range(int q0, int bq, int bk, int Sq,
                                           int Sk, int causal, int window,
                                           int* begin, int* end) {
  const int q_last = min(q0 + bq, Sq) - 1;
  int kt_end = (Sk + bk - 1) / bk;
  if (causal) kt_end = min(kt_end, q_last / bk + 1);
  int kt_begin = 0;
  if (window > 0 && q_last < Sk - 1 + window)  // every row keeps a real key
    kt_begin = max(0, q0 - window + 1) / bk;
  *begin = kt_begin;
  *end = kt_end;
}

// ---- f32: CUDA cores -------------------------------------------------------
constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per K/V tile
constexpr int THREADS = 256;      // 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3
constexpr int LDT = BQ + 4;       // padded row (floats) of the transposed Q/K tiles
constexpr int LDP = BK + 4;       // padded row (floats) of the probability tile

// element strides of one (B, heads, S, D) tensor; D has unit stride
struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * D * LDT + BK * D + BQ * LDP);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Strides sq_, Strides sk_,
                      Strides sv_, Strides so_, int group, int Sq, int Sk,
                      int causal, int window, float scale) {
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

  const float* qb = q + b * sq_.b + h * sq_.h;
  const float* kb = k + b * sk_.b + kvh * sk_.h;
  const float* vb = v + b * sv_.b + kvh * sv_.h;
  float* ob = o + b * so_.b + h * so_.h;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    sQt[c * LDT + r] = (q0 + r < Sq) ? qb[(q0 + r) * sq_.s + c] : 0.f;
  }

  int kt_begin, kt_end;
  tile_range(q0, BQ, BK, Sq, Sk, causal, window, &kt_begin, &kt_end);

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
      sKt[c * LDT + r] = in ? kb[(k0 + r) * sk_.s + c] : 0.f;
      sV[r * D + c] = in ? vb[(k0 + r) * sv_.s + c] : 0.f;
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
    if (lse && tx == 0 && row < Sq)
      lse[((long long)b * gridDim.y + h) * Sq + row] =
          m[i] == NEG_INF ? INFINITY : m[i] + logf(l_row);
    if (row < Sq) {
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd)
        ob[row * so_.s + tx + 16 * dd] = acc[i][dd] / denom;
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int KV, int Sq, int Sk,
                       Strides sq,
                       Strides sk, Strides sv, Strides so, int causal,
                       int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attn_f32_kernel<D>;
  // above 48 KB dynamic shared memory must be asked for, per device
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk, sv,
      so, H / KV, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

// ---- bf16: wgmma from a TMA ring ------------------------------------------
constexpr int T_BQ = 128;      // query rows per block: two consumer warpgroups
constexpr int T_BK = 128;      // keys per K/V tile
constexpr int T_THREADS = 384;  // producer warpgroup + two consumers
constexpr int T_CONSUMER_WARPS = 8;

// DP: D padded to a whole number of 64-column (128-byte) sub-tiles; as
// many K/V stages as shared memory holds (4 at DP 64, 3 at DP 128)
template <int DP>
struct TileBytes {
  static constexpr int STAGES = DP == 64 ? 4 : 3;
  static constexpr int Q_SUB = T_BQ * 128;   // 128 rows x 64 columns
  static constexpr int KV_SUB = T_BK * 128;  // 128 keys x 64 columns
  static constexpr int Q = DP / 64 * Q_SUB;
  static constexpr int KV = DP / 64 * KV_SUB;  // one of K, V
  static constexpr int STAGE = 2 * KV;
  static constexpr size_t SMEM = 1024 + Q + STAGES * STAGE +
                                 (1 + 2 * STAGES) * sizeof(uint64_t);
};

// 2^x on the special function unit; x = -1e30 - m gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One K/V tile's step of the online softmax for a thread's two rows, in the
// log2 domain.  s: the scores in the accumulator layout (s[4j + 2r + c] is
// row row0 + 8r, key kcol + 8j + c), replaced by the probabilities; m, l:
// the running max and this thread's share of the denominator; corr: the
// factor for row r's output so far.  EDGE applies the masks and drops
// absent keys; a tile without either takes the branch-free copy.
template <bool EDGE>
__device__ __forceinline__ void online_softmax(float* s, float* m, float* l,
                                               float* corr, int row0,
                                               int kcol, int Sk, int causal,
                                               int window, float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    float mx[2] = {NEG_INF, NEG_INF};  // two chains, for overlap
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = s[4 * j + 2 * r + c] * scale_log2;
        if constexpr (EDGE) {
          const int kpos = kcol + 8 * j + c;
          const bool keep = (!causal || qpos >= kpos) &&
                            (window <= 0 || qpos - kpos < window);
          x = keep ? x : NEG_INF;
          if (kpos < Sk) mx[c] = fmaxf(mx[c], x);
        } else {
          mx[c] = fmaxf(mx[c], x);
        }
        s[4 * j + 2 * r + c] = x;
      }
    }
    float row_max = fmaxf(mx[0], mx[1]);
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    const float m_new = fmaxf(m[r], row_max);
    corr[r] = ex2(m[r] - m_new);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float p = ex2(s[4 * j + 2 * r + c] - m_new);
        if constexpr (EDGE) {
          if (kcol + 8 * j + c >= Sk) p = 0.f;  // absent, not masked
        }
        s[4 * j + 2 * r + c] = p;
        sum[c] += p;
      }
    }
    l[r] = l[r] * corr[r] + sum[0] + sum[1];
    m[r] = m_new;
  }
}

// O (64 x DP) += P (64 x 128, registers) V (128 x DP, MN-major at ``sv``)
template <int DP>
__device__ __forceinline__ void pv_product(float* acc, uint32_t (*pa)[4],
                                           const uint8_t* sv) {
  using namespace hopper;
  using TB = TileBytes<DP>;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const uint64_t dv = desc_sw128(sv + 2048 * t, TB::KV_SUB, 1024);
    if constexpr (DP == 64)
      wgmma_m64n64k16_rs_mn(acc, pa[t], dv);
    else
      wgmma_m64n128k16_rs_mn(acc, pa[t], dv);
  }
}

template <int DP>
__global__ void __launch_bounds__(T_THREADS, 1)
flash_attn_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                       const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, Strides so, int D, int group,
                       int Sq, int Sk, int causal, int window,
                       float scale_log2) {
  using namespace hopper;
  using TB = TileBytes<DP>;
  constexpr int NSUB = DP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem;
  uint8_t* skv = smem + TB::Q;  // stage s: K at s * STAGE, V KV bytes later
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skv + TB::STAGES * TB::STAGE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + TB::STAGES;

  const int q0 = blockIdx.x * T_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;  // GQA: head h reads KV head h / (H/KV)
  int kt_begin, kt_end;
  tile_range(q0, T_BQ, T_BK, Sq, Sk, causal, window, &kt_begin, &kt_end);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < TB::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {  // producer: one thread issues every load
    regs_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, TB::Q);
#pragma unroll
      for (int c = 0; c < NSUB; ++c)
        tma_load_4d(sq + c * TB::Q_SUB, &tmq, q_full, 64 * c, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);  // first round passes
        mbar_expect_tx(&full[stage], TB::STAGE);
        uint8_t* sk = skv + stage * TB::STAGE;
#pragma unroll
        for (int c = 0; c < NSUB; ++c) {
          tma_load_4d(sk + c * TB::KV_SUB, &tmk, &full[stage], 64 * c,
                      kt * T_BK, kvh, b);
          tma_load_4d(sk + TB::KV + c * TB::KV_SUB, &tmv, &full[stage],
                      64 * c, kt * T_BK, kvh, b);
        }
        if (++stage == TB::STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else {  // consumers: warpgroup 1 rows 0-63, warpgroup 2 rows 64-127
    regs_inc<232>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    // this thread's two rows (r = 0, 1) in the accumulator layout:
    // s[4j + 2r + c] / acc[4j + 2r + c] is row row0 + 8r, column 8j + 2 quad + c
    const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;
    const int quad = lane % 4;
    float s[64], acc[DP / 2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;

    // Per tile: issue S = Q K^T, then O += P V of the tile before, and run
    // this tile's softmax on the CUDA cores while the tensor cores work
    // on that product; P is held in registers (pa) until it completes.
    uint32_t pa[8][4] = {};
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    mbar_wait(q_full, 0);
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int k0 = kt * T_BK;
      mbar_wait(&full[stage], phase);
      const uint8_t* sk = skv + stage * TB::STAGE;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {  // 64 x 128, over DP by 16
        const int sub = ks / 4, off = 32 * (ks % 4);
        wgmma_m64n128k16_ss_k_k(
            s, desc_sw128(sq + sub * TB::Q_SUB + cw * 64 * 128 + off, 16, 1024),
            desc_sw128(sk + sub * TB::KV_SUB + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
      const bool has_prev = kt > kt_begin;
      if (has_prev) {
        pv_product<DP>(acc, pa, skv + prev * TB::STAGE + TB::KV);
        wgmma_commit();
        wgmma_wait<1>();  // S is done; P V may still run
      } else {
        wgmma_wait<0>();
      }
      fence_regs<64>(s);

      // masks and the online softmax; ``edge``: some key of this tile is
      // masked or absent for some row of this warpgroup
      const int first = q0 + cw * 64;
      const int kcol = k0 + 2 * quad;
      float corr[2];
      if ((causal && k0 + T_BK - 1 > first) ||
          (window > 0 && first + 63 - k0 >= window) || k0 + T_BK > Sk)
        online_softmax<true>(s, m, l, corr, row0, kcol, Sk, causal, window,
                             scale_log2);
      else
        online_softmax<false>(s, m, l, corr, row0, kcol, Sk, causal, window,
                              scale_log2);

      wgmma_wait<0>();
      fence_regs<DP / 2>(acc);
      fence_uregs<32>(&pa[0][0]);
      if (has_prev && lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[4 * j + i] *= corr[i / 2];
      }
      // P to bf16, in place: S's accumulator layout is the A operand's
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 pr =
              __floats2bfloat162_rn(s[8 * t + 2 * i], s[8 * t + 2 * i + 1]);
          pa[t][i] = *reinterpret_cast<const uint32_t*>(&pr);
        }
      }
      prev = stage;
      if (++stage == TB::STAGES) { stage = 0; phase ^= 1; }
    }
    // the last tile's O += P V
    wgmma_fence();
    pv_product<DP>(acc, pa, skv + prev * TB::STAGE + TB::KV);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(acc);
    fence_uregs<32>(&pa[0][0]);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // finalize: acc / max(l, 1e-30) over the row's four threads
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = 1.f / fmaxf(lr, 1e-30f);
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      if (lse && quad == 0)
        lse[((long long)b * gridDim.y + h) * Sq + row] =
            m[r] == NEG_INF ? INFINITY : (m[r] + log2f(lr)) * LN2;
      __nv_bfloat16* orow = out + b * so.b + h * so.h + row * so.s;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * quad;
        if (col < D)  // D % 8 == 0: both columns or neither
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                    acc[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// hopper's rank-4 map over one (B, heads, S, D) tensor
int encode_bhsd(CUtensorMap* map, const void* base, int B, int heads, int S,
                int D, Strides st, int rows) {
  return hopper::encode_bhsd(map, base, B, heads, S, D, st.b, st.h, st.s,
                             rows);
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int KV, int Sq, int Sk, int D,
                Strides sq, Strides sk,
                Strides sv, Strides so, int causal, int window, float scale,
                cudaStream_t stream) {
  CUtensorMap tmq, tmk, tmv;
  int err = encode_bhsd(&tmq, q, B, H, Sq, D, sq, T_BQ);
  if (!err) err = encode_bhsd(&tmk, k, B, KV, Sk, D, sk, T_BK);
  if (!err) err = encode_bhsd(&tmv, v, B, KV, Sk, D, sv, T_BK);
  if (err) return err;
  constexpr size_t smem = TileBytes<DP>::SMEM;
  auto kernel = flash_attn_bf16_kernel<DP>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid((Sq + T_BQ - 1) / T_BQ, H, B);
  kernel<<<grid, T_THREADS, smem, stream>>>(
      tmq, tmk, tmv, static_cast<__nv_bfloat16*>(o), lse, so, D, H / KV, Sq,
      Sk,
      causal, window, scale * 1.4426950408889634f);  // log2(e)
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 &&
         st.h % 8 == 0 && st.s % 8 == 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  window <= 0: no window.  Strides in elements
// (D has unit stride): q and o over (B, H, Sq), k and v over (B, KV, Sk);
// bf16 needs them, and the pointers, 16-byte aligned.  lse: null, or f32
// (B, H, Sq) contiguous for the row statistics.  Returns the
// launch's cudaGetLastError() (0 on success), or the error that kept it
// from launching; does not synchronise.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int KV, int Sq, int Sk,
                              int D, long long qsb, long long qsh,
                              long long qss, long long ksb, long long ksh,
                              long long kss, long long vsb, long long vsh,
                              long long vss, long long osb, long long osh,
                              long long oss, int causal, int window,
                              int dtype, float scale, float* lse,
                              void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sq{qsb, qsh, qss}, sk{ksb, ksh, kss}, sv{vsb, vsh, vss},
      so{osb, osh, oss};
  if (dtype == 0) {
    cudaError_t err;
    switch (D) {
      case 32: err = launch_f32<32>(q, k, v, o, lse, B, H, KV, Sq, Sk, sq, sk, sv, so, causal, window, scale, s); break;
      case 64: err = launch_f32<64>(q, k, v, o, lse, B, H, KV, Sq, Sk, sq, sk, sv, so, causal, window, scale, s); break;
      case 80: err = launch_f32<80>(q, k, v, o, lse, B, H, KV, Sq, Sk, sq, sk, sv, so, causal, window, scale, s); break;
      case 128: err = launch_f32<128>(q, k, v, o, lse, B, H, KV, Sq, Sk, sq, sk, sv, so, causal, window, scale, s); break;
      default: err = cudaErrorInvalidValue;
    }
    return (int)err;
  }
  if (dtype == 1) {
    if (!(aligned16(q, sq) && aligned16(k, sk) && aligned16(v, sv) &&
          aligned16(o, so)))
      return (int)cudaErrorInvalidValue;
    switch (D) {  // padded to whole 64-column sub-tiles
      case 32:
      case 64:
        return launch_bf16<64>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, sq, sk, sv, so, causal, window, scale, s);
      case 80:
      case 128:
        return launch_bf16<128>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, sq, sk, sv, so, causal, window, scale, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
