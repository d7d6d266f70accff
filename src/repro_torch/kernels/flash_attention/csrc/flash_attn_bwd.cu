// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of K1.
//
// The TPU kernel src/repro/kernels/flash_attention/kernel.py is forward
// only, and the JAX trainer differentiates plain jnp attention; this kernel
// has no TPU twin.  The port's trainer runs K1 (flash_attn_fwd.cu) in the
// forward, so its gradient is a kernel too.  Same contract as the forward:
// q, o, dO (B,H,Sq,D), k, v (B,KV,Sk,D), head h reads KV head h / (H/KV);
// scale 1/sqrt(D); top-left causal mask, window qpos - kpos < window;
// ragged Sq and Sk; D in {32, 64, 80, 128}; f32 or bf16, every tensor
// through its strides (unit stride along D, the others multiples of 16
// bytes, pointers 16-byte aligned); dQ, dK, dV in the inputs' dtype,
// accumulated in f32.  No atomics: the result is the same bits from run to
// run.
//
// Row statistics.  The forward writes, per query row, the natural-log
// log-sum-exp L of the row's scaled, masked scores (f32, (B,H,Sq)
// contiguous), and +inf for a row that keeps no key (only with a window
// and Sq > Sk: qpos >= Sk - 1 + window).  P = exp(S * scale - L) is
// recomputed here.  Such a row averaged every key in the forward (finite
// NEG_INF), so its gradient is dV += dO / Sk on every key with dQ = 0 and
// no dK: the +inf mark selects that case, since -1e30 + log(l) rounds to
// -1e30 in f32 and could not give P = 1/Sk.
//
// What bounds it on this card.  The gradient needs five D-deep products
// per (query, key) pair kept (S, dP, dV, dK, dQ), against the forward's
// two, and two exponentials where the dQ pass recomputes P.  At
// qwen2-0.5b's training shape (B 4 x S 512, H 14, KV 2, D 64, causal,
// bf16) the five take 4.7 GFLOP, 4.8 us at the bf16 tensor-core rate,
// against 16.9 MB of q, k, v, o, dO, the statistics, dQ, dK and dV, 5.0
// us at 3.35 TB/s: the bounds meet, and what sets the time is how long one
// block's chain of steps is and how many blocks share an SM.  A step is
// two products, a pass over 4,096 scores on the CUDA cores and the special
// function unit (16 exponentials a clock a SM: 256 clocks, half the
// tensor cores' 512 for the step's four products), then two more
// products, each phase waiting on the last; three blocks a SM overlap
// their phases.  Ordering the steps inside a block so that the next
// step's products run under this step's exponentials (four commit groups
// a step) was slower: it only lengthens each block's chain.
//
// bf16, three launches a call (LAUNCHES_PER_CALL in ops.py):
//   (a) delta_kernel: D_i = rowsum(dO_i o O_i) in f32, 16-byte loads, a
//       few lanes a row; it also writes L log2(e), both padded to whole
//       64-row tiles (zeros past Sq), so that (b) fetches them with 1-D
//       bulk copies.
//   (b) dkdv_wgmma_kernel: one block per (64-key tile, query head, batch),
//       B x H x Sk/64 blocks (448 at the training shape, three a SM at D
//       <= 64, two at D > 64), the key tiles that walk the most query
//       tiles under causal first.  One warpgroup a block: its thread 0
//       loads the K and V tile once and keeps a ring of three Q and dO
//       tiles (with their rows of L and D) full by TMA, refilling a stage
//       once all four warps have signalled on its mbarrier that they are
//       done with it (a producer warp would cost the registers that the
//       third block a SM needs).  The warpgroup issues S^T = K Q^T and dP^T
//       = V dO^T as SS-wgmma (both operands K-major, as they lie), forms
//       P^T and dS^T = P^T o (dP^T - D) in f32 registers, and issues dV +=
//       P^T dO and dK += dS^T Q as RS-wgmma: P^T and dS^T go from the
//       accumulator layout straight into A registers, and dO and Q are read
//       MN-major as they lie, so no tile is copied transposed.  The block
//       writes its head's partial dK, dV (f32, unscaled) to a workspace
//       (2, B, H, Sk, D) that the wrapper allocates: 14.7 MB at the
//       training shape, which stays in L2.
//   (c) dq_wgmma_kernel: one block per (64-query tile, head, batch), the
//       longest walks first, loading the same way with a ring of K and V
//       tiles: S = Q K^T, dP = dO V^T (SS), dS, dQ += dS K (RS, K read
//       MN-major).  dQ stays a pass of its own: one pass for all three
//       would need atomics on dQ (not deterministic) or per-key-tile
//       partials of dQ (59 MB at the training shape), so S, dP and P are
//       computed twice, 7 products where 5 would do.  The blocks after the
//       dQ blocks sum each KV head's G partials of (b) in head order (a
//       fixed order: deterministic, no float atomics), take `scale` once
//       for dK, and write dK, dV through their strides; they run as the
//       dQ tiles drain.
//   D 32 and 80 run padded to 64 and 128 columns: the tensor maps read
//   zeros past D, and only the D real columns are stored.  Query rows past
//   Sq and keys past Sk read as zeros (Q, dO, K, V by TMA, L and D by the
//   padding), so in (b) they add nothing without a mask; (c) masks keys
//   past Sk, where exp(-L) alone could overflow.  Rows past Sq and keys
//   past Sk are never stored.  Only tiles that cross the causal diagonal,
//   and every tile under a window, apply the masks and the keyless rows.
//
// f32 (parity runs): full f32 on the CUDA cores, no TF32 (which keeps ~3
// decimal digits), like the forward's f32 variant: 256 threads, each
// owning a 4 x 4 block of a 64 x 64 score tile, operands read as float4
// from transposed tiles in shared memory.  (b) has one block per KV head
// and 64-key tile, which walks the G query heads itself; (c) recomputes
// S and dP per query tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// element strides of one (B, heads, S, D) tensor; D has unit stride
struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ bool keeps(int qpos, int kpos, int causal,
                                      int window) {
  return (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window);
}

// the query tile q0..q_end can see the key tile k0..k_last, or holds a row
// that keeps no key (which reads every key)
__device__ __forceinline__ bool tile_needed(int q0, int q_end, int k_last,
                                            int Sk, int window) {
  if (window <= 0) return true;
  return q0 - k_last < window || q_end >= Sk - 1 + window;
}

// key tiles [*begin, *end) that the query rows q0..q_end keep a key in
__device__ __forceinline__ void key_tiles(int q0, int q_end, int bk, int Sk,
                                          int causal, int window, int* begin,
                                          int* end) {
  int kt_end = (Sk + bk - 1) / bk;
  if (causal) kt_end = min(kt_end, q_end / bk + 1);
  *begin = window > 0 ? max(0, q0 - window + 1) / bk : 0;
  *end = kt_end;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---- (a) D = rowsum(dO o O) ------------------------------------------------
// LANES threads a row, each reading 16 bytes of O and of dO at a time; rows
// (b * H + h) * ld + s for s < ld (ld >= Sq; rows past Sq get zeros).  With
// ``lse2``, also L log2(e) of each row there.
template <typename T, int LANES>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta,
             float* __restrict__ lse2, Strides so, Strides sd, int H, int Sq,
             int ld, int D, long long rows) {
  constexpr int VEC = 16 / sizeof(T);
  const long long row =
      (long long)blockIdx.x * (256 / LANES) + threadIdx.x / LANES;
  const int sub = threadIdx.x % LANES;
  const bool valid = row < rows;  // no early return: the shuffles below
  const int s = valid ? (int)(row % ld) : 0;
  const long long bh = valid ? row / ld : 0;
  float acc = 0.f;
  if (valid && s < Sq) {
    const int h = (int)(bh % H), b = (int)(bh / H);
    const T* orow = o + b * so.b + h * so.h + s * so.s;
    const T* drow = dout + b * sd.b + h * sd.h + s * sd.s;
    for (int c = sub * VEC; c < D; c += LANES * VEC) {
      const uint4 x = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 y = *reinterpret_cast<const uint4*>(drow + c);
      const T* xe = reinterpret_cast<const T*>(&x);
      const T* ye = reinterpret_cast<const T*>(&y);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc += to_f(xe[i]) * to_f(ye[i]);
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (valid && sub == 0) {
    delta[row] = acc;
    if (lse2) lse2[row] = s < Sq ? lse[bh * Sq + s] * LOG2E : 0.f;
  }
}

// ---- f32: CUDA cores --------------------------------------------------------
constexpr int FT = 64;          // keys and queries of an f32 tile
constexpr int F_THREADS = 256;  // 16 x 16: thread (ty, tx) owns a 4 x 4 block
constexpr int FLD = FT + 4;     // padded row (floats) of a transposed tile

// Rows row0..row0+FT-1 (zeros past S) of two heads a and b of (B,heads,S,D)
// tensors into shared memory, transposed into [D][FLD].  Consecutive
// threads take consecutive rows of one 16-byte column chunk, so the
// transposed stores of a warp hit 32 different banks; every thread issues
// all its global loads before its first store, so they are in flight
// together.
template <int D>
__device__ __forceinline__ void load_t_f32(float* da, const float* sa,
                                           long long ssa, float* db,
                                           const float* sb, long long ssb,
                                           int row0, int S, int tid) {
  constexpr int TOTAL = FT * (D / 4);
  constexpr int N = (TOTAL + F_THREADS - 1) / F_THREADS;
  float4 xa[N], xb[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = tid + i * F_THREADS, r = idx % FT, c = idx / FT * 4;
    xa[i] = xb[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (idx < TOTAL && row0 + r < S) {
      xa[i] = *reinterpret_cast<const float4*>(sa + (row0 + r) * ssa + c);
      xb[i] = *reinterpret_cast<const float4*>(sb + (row0 + r) * ssb + c);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = tid + i * F_THREADS, r = idx % FT, c = idx / FT * 4;
    if (idx >= TOTAL) continue;
    const float ea[4] = {xa[i].x, xa[i].y, xa[i].z, xa[i].w};
    const float eb[4] = {xb[i].x, xb[i].y, xb[i].z, xb[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      da[(c + e) * FLD + r] = ea[e];
      db[(c + e) * FLD + r] = eb[e];
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <int D>
constexpr size_t f32_dkdv_smem() {
  return sizeof(float) * (4 * D * FLD + 2 * FT * FLD + 2 * FT);
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, Strides sq_,
                Strides sk_, Strides sv_, Strides sd_, Strides sdk,
                Strides sdv, int H, int group, int Sq, int Sk, int causal,
                int window, float scale) {
  constexpr int DPT = D / 16;  // output columns tx + 16i of a thread
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem;             // [D][FLD]
  float* sVt = sKt + D * FLD;    // [D][FLD]
  float* sQt = sVt + D * FLD;    // [D][FLD]
  float* sOt = sQt + D * FLD;    // [D][FLD]  dO, transposed
  float* sP = sOt + D * FLD;     // [key][FLD] P^T
  float* sS = sP + FT * FLD;     // [key][FLD] dS^T
  float* sL = sS + FT * FLD;     // [FT] row statistics
  float* sDl = sL + FT;          // [FT] D

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * FT, kvh = blockIdx.y, b = blockIdx.z;
  load_t_f32<D>(sKt, k + b * sk_.b + kvh * sk_.h, sk_.s, sVt,
                v + b * sv_.b + kvh * sv_.h, sv_.s, k0, Sk, tid);

  float dK[4][DPT], dV[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) dK[i][dd] = dV[i][dd] = 0.f;

  const int k_last = min(k0 + FT, Sk) - 1;
  const int nqt = (Sq + FT - 1) / FT;
  const float inv_sk = 1.f / Sk;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const float* qh = q + b * sq_.b + h * sq_.h;
    const float* dh = dout + b * sd_.b + h * sd_.h;
    const long long rowh = ((long long)b * H + h) * Sq;
    for (int t = causal ? k0 / FT : 0; t < nqt; ++t) {
      const int q0 = t * FT;
      if (!tile_needed(q0, min(q0 + FT, Sq) - 1, k_last, Sk, window)) continue;
      __syncthreads();  // the previous tile is no longer read
      load_t_f32<D>(sQt, qh, sq_.s, sOt, dh, sd_.s, q0, Sq, tid);
      if (tid < FT) {
        const bool in = q0 + tid < Sq;
        sL[tid] = in ? lse[rowh + q0 + tid] : 0.f;
        sDl[tid] = in ? delta[rowh + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: rows keys 4ty.., columns queries 4tx..
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&sKt[c * FLD + 4 * ty]);
        const float4 qq = *reinterpret_cast<const float4*>(&sQt[c * FLD + 4 * tx]);
        const float4 vv = *reinterpret_cast<const float4*>(&sVt[c * FLD + 4 * ty]);
        const float4 oo = *reinterpret_cast<const float4*>(&sOt[c * FLD + 4 * tx]);
        const float ka[4] = {kk.x, kk.y, kk.z, kk.w}, qa[4] = {qq.x, qq.y, qq.z, qq.w};
        const float va[4] = {vv.x, vv.y, vv.z, vv.w}, oa[4] = {oo.x, oo.y, oo.z, oo.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(ka[i], qa[j], s[i][j]);
            dp[i][j] = fmaf(va[i], oa[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + 4 * ty + i;
        float p[4], ds[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ql = 4 * tx + j, qpos = q0 + ql;
          p[j] = ds[j] = 0.f;
          if (qpos < Sq && kpos < Sk) {
            const float L = sL[ql];
            if (isinf(L)) {
              p[j] = inv_sk;  // a row that keeps no key: dV only
            } else if (keeps(qpos, kpos, causal, window)) {
              p[j] = expf(s[i][j] * scale - L);
              ds[j] = p[j] * (dp[i][j] - sDl[ql]);
            }
          }
        }
        *reinterpret_cast<float4*>(&sP[(4 * ty + i) * FLD + 4 * tx]) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(&sS[(4 * ty + i) * FLD + 4 * tx]) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over this tile's queries
#pragma unroll 2
      for (int j = 0; j < FT; j += 4) {
        float4 pr[4], dr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = *reinterpret_cast<const float4*>(&sP[(4 * ty + i) * FLD + j]);
          dr[i] = *reinterpret_cast<const float4*>(&sS[(4 * ty + i) * FLD + j]);
        }
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) {
          const float4 oo = *reinterpret_cast<const float4*>(&sOt[(tx + 16 * dd) * FLD + j]);
          const float4 qq = *reinterpret_cast<const float4*>(&sQt[(tx + 16 * dd) * FLD + j]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dV[i][dd] += dot4(pr[i], oo);
            dK[i][dd] += dot4(dr[i], qq);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + 4 * ty + i;
    if (kpos >= Sk) continue;
    float* dkr = dk + b * sdk.b + kvh * sdk.h + kpos * sdk.s;
    float* dvr = dv + b * sdv.b + kvh * sdv.h + kpos * sdv.s;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      dkr[tx + 16 * dd] = dK[i][dd] * scale;
      dvr[tx + 16 * dd] = dV[i][dd];
    }
  }
}

template <int D>
constexpr size_t f32_dq_smem() {
  return sizeof(float) * (4 * D * FLD + FT * FLD);
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, Strides sq_, Strides sk_, Strides sv_,
              Strides sd_, Strides sdq, int H, int group, int Sq, int Sk,
              int causal, int window, float scale) {
  constexpr int DPT = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;            // [D][FLD]
  float* sOt = sQt + D * FLD;   // [D][FLD]  dO, transposed
  float* sKt = sOt + D * FLD;   // [D][FLD]
  float* sVt = sKt + D * FLD;   // [D][FLD]
  float* sS = sVt + D * FLD;    // [query][FLD] dS

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * FT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  load_t_f32<D>(sQt, q + b * sq_.b + h * sq_.h, sq_.s, sOt,
                dout + b * sd_.b + h * sd_.h, sd_.s, q0, Sq, tid);
  const float* kb = k + b * sk_.b + kvh * sk_.h;
  const float* vb = v + b * sv_.b + kvh * sv_.h;
  const long long rowh = ((long long)b * H + h) * Sq;
  float L[4], Dl[4], dQ[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    L[i] = qpos < Sq ? lse[rowh + qpos] : INFINITY;  // +inf: no p, no dS
    Dl[i] = qpos < Sq ? delta[rowh + qpos] : 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) dQ[i][dd] = 0.f;
  }

  int kt_begin, kt_end;
  key_tiles(q0, min(q0 + FT, Sq) - 1, FT, Sk, causal, window, &kt_begin,
            &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * FT;
    __syncthreads();  // the previous tile is no longer read
    load_t_f32<D>(sKt, kb, sk_.s, sVt, vb, sv_.s, k0, Sk, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 qq = *reinterpret_cast<const float4*>(&sQt[c * FLD + 4 * ty]);
      const float4 kk = *reinterpret_cast<const float4*>(&sKt[c * FLD + 4 * tx]);
      const float4 oo = *reinterpret_cast<const float4*>(&sOt[c * FLD + 4 * ty]);
      const float4 vv = *reinterpret_cast<const float4*>(&sVt[c * FLD + 4 * tx]);
      const float qa[4] = {qq.x, qq.y, qq.z, qq.w}, ka[4] = {kk.x, kk.y, kk.z, kk.w};
      const float oa[4] = {oo.x, oo.y, oo.z, oo.w}, va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        ds[j] = 0.f;
        if (kpos < Sk && keeps(qpos, kpos, causal, window) && !isinf(L[i]))
          ds[j] = expf(s[i][j] * scale - L[i]) * (dp[i][j] - Dl[i]);
      }
      *reinterpret_cast<float4*>(&sS[(4 * ty + i) * FLD + 4 * tx]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dQ += dS K over this tile's keys
#pragma unroll 2
    for (int j = 0; j < FT; j += 4) {
      float4 dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dr[i] = *reinterpret_cast<const float4*>(&sS[(4 * ty + i) * FLD + j]);
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const float4 kk = *reinterpret_cast<const float4*>(&sKt[(tx + 16 * dd) * FLD + j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) dQ[i][dd] += dot4(dr[i], kk);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= Sq) continue;
    float* dqr = dq + b * sdq.b + h * sdq.h + qpos * sdq.s;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) dqr[tx + 16 * dd] = dQ[i][dd] * scale;
  }
}

// ---- bf16: wgmma from TMA rings ---------------------------------------------
typedef __nv_bfloat16 bf16;
constexpr int BT = 64;  // keys of a dK/dV block, queries of a dQ block, keys of
                        // a dQ ring tile; L and D rows are padded to it
constexpr int W_THREADS = 128;  // one warpgroup; its thread 0 issues the loads
constexpr int WARPS = 4;
constexpr int SUM_ROWS = 8;  // key rows of a block that sums the G partials
constexpr int SUM_LOADS = 8;  // partials a thread has in flight

// DP: D padded to whole 64-column (128-byte) sub-tiles.  Every tile is a
// stack of such sub-tiles, 128-byte swizzled by TMA (hopper.cuh).
template <int DP>
struct BwdTiles {
  static constexpr int NSUB = DP / 64;
  // queries of a dK/dV step: at DP 128 the f32 dK and dV take 128
  // registers a thread, so S^T and dP^T are 64 x 32
  static constexpr int BQ = DP == 64 ? 64 : 32;
  static constexpr int KSUB = BT * 128;  // one sub-tile of a 64-row tile
  static constexpr int QSUB = BQ * 128;  // one sub-tile of a BQ-row tile
  static constexpr int KT = NSUB * KSUB;
  static constexpr int QT = NSUB * QSUB;
  static constexpr int STAGES = 3;                    // Q/dO ring of (b)
  static constexpr int DQ_STAGES = DP == 64 ? 3 : 2;  // K/V ring of (c)
  static constexpr size_t DKDV_SMEM =
      1024 + 2 * KT + STAGES * (2 * QT + 2 * BQ * sizeof(float)) +
      (1 + 2 * STAGES) * sizeof(uint64_t);
  static constexpr size_t DQ_SMEM =
      1024 + 2 * KT + DQ_STAGES * 2 * KT + (1 + 2 * DQ_STAGES) * sizeof(uint64_t);
  // blocks a SM: three at DP 64 (168 registers a thread, 68 KB and 66 KB
  // of shared memory); two at DP 128, whose dK and dV need more registers
  static constexpr int MIN_BLOCKS = DP == 64 ? 3 : 2;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// 2^x on the special function unit, as in the forward; -inf gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc (64 x N) = A B^T over DP: A (64 rows) and B (N rows) K-major tiles,
// their sub-tiles a_sub and b_sub bytes apart
template <int DP, int N>
__device__ __forceinline__ void ss_product(float* acc, const uint8_t* a,
                                           int a_sub, const uint8_t* b,
                                           int b_sub) {
  using namespace hopper;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const int sub = ks / 4, off = 32 * (ks % 4);
    const uint64_t da = desc_sw128(a + sub * a_sub + off, 16, 1024);
    const uint64_t db = desc_sw128(b + sub * b_sub + off, 16, 1024);
    if constexpr (N == 64)
      wgmma_m64n64k16_ss_k_k(acc, da, db, ks > 0);
    else
      wgmma_m64n32k16_ss_k_k(acc, da, db, ks > 0);
  }
}

// acc (64 x DP) += X (64 x 16 KS, bf16 A registers) B, B (16 KS x DP) the
// rows of a tile read MN-major as they lie, its sub-tiles b_sub bytes apart
template <int DP, int KS>
__device__ __forceinline__ void rs_product(float* acc, uint32_t (*xa)[4],
                                           const uint8_t* b, int b_sub) {
  using namespace hopper;
#pragma unroll
  for (int t = 0; t < KS; ++t) {
    const uint64_t db = desc_sw128(b + 2048 * t, b_sub, 1024);
    if constexpr (DP == 64)
      wgmma_m64n64k16_rs_mn(acc, xa[t], db);
    else
      wgmma_m64n128k16_rs_mn(acc, xa[t], db);
  }
}

// an accumulator x (64 x 16 KS, f32) as the bf16 A registers of the next
// product: x[4j + 2r + c] is row 8r + lane / 4 of the warp's 16, column 8j
// + 2 (lane % 4) + c, which is the A layout of columns 16t..16t+15
template <int KS>
__device__ __forceinline__ void to_a(const float* x, uint32_t (*xa)[4]) {
#pragma unroll
  for (int t = 0; t < KS; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(x[8 * t + 2 * i], x[8 * t + 2 * i + 1]);
      xa[t][i] = *reinterpret_cast<const uint32_t*>(&v);
    }
}

// (b) one block: the 64 keys k0.. of KV head h / group, against the query
// tiles of head h that see them; its partial dK (unscaled) and dV to ws
template <int DP>
__global__ void __launch_bounds__(W_THREADS, BwdTiles<DP>::MIN_BLOCKS)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv,
                  const __grid_constant__ CUtensorMap tmdo,
                  const float* __restrict__ stats, float* __restrict__ ws,
                  int B, int H, int group, int Sq, int Sk, int ld, int D,
                  int causal, int window, float scale_log2) {
  using namespace hopper;
  using TB = BwdTiles<DP>;
  constexpr int BQ = TB::BQ, STAGES = TB::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + TB::KT;
  uint8_t* sqo = sv + TB::KT;  // stage s: Q at 2 QT s, dO QT after it
  float* sl = reinterpret_cast<float*>(sqo + STAGES * 2 * TB::QT);  // [STAGES][BQ]
  float* sd = sl + STAGES * BQ;                                       // [STAGES][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sd + STAGES * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  // key tile 0 first: under causal it walks the most query tiles
  const int hb = blockIdx.x % (H * B), h = hb % H, b = hb / H;
  const int k0 = blockIdx.x / (H * B) * BT, kvh = h / group;
  const int k_last = min(k0 + BT, Sk) - 1;
  const int t_begin = causal ? k0 / BQ : 0, nqt = (Sq + BQ - 1) / BQ;
  const long long row_h = ((long long)b * H + h) * ld;
  const float* l_rows = stats + row_h;
  const float* d_rows = stats + (long long)B * H * ld + row_h;
  auto needed = [&](int t) {
    return tile_needed(t * BQ, min(t * BQ + BQ, Sq) - 1, k_last, Sk, window);
  };
  // thread 0: the next needed query tile from t on into ``stage``;
  // returns the tile after it (nqt: none left)
  auto load = [&](int t, int stage) {
    while (t < nqt && !needed(t)) ++t;
    if (t == nqt) return nqt;
    const int q0 = t * BQ;
    mbar_expect_tx(&full[stage], 2 * TB::QT + 2 * BQ * (uint32_t)sizeof(float));
    uint8_t* sq = sqo + stage * 2 * TB::QT;
#pragma unroll
    for (int c = 0; c < TB::NSUB; ++c) {
      tma_load_4d(sq + c * TB::QSUB, &tmq, &full[stage], 64 * c, q0, h, b);
      tma_load_4d(sq + TB::QT + c * TB::QSUB, &tmdo, &full[stage], 64 * c,
                  q0, h, b);
    }
    bulk_load(sl + stage * BQ, l_rows + q0, BQ * sizeof(float), &full[stage]);
    bulk_load(sd + stage * BQ, d_rows + q0, BQ * sizeof(float), &full[stage]);
    return t + 1;
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int t_load = t_begin;  // thread 0's cursor: the ring runs STAGES ahead
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    mbar_fence_init();
    mbar_expect_tx(kv_full, 2 * TB::KT);
#pragma unroll
    for (int c = 0; c < TB::NSUB; ++c) {
      tma_load_4d(sk + c * TB::KSUB, &tmk, kv_full, 64 * c, k0, kvh, b);
      tma_load_4d(sv + c * TB::KSUB, &tmv, kv_full, 64 * c, k0, kvh, b);
    }
    for (int s = 0; s < STAGES; ++s) t_load = load(t_load, s);
  }
  __syncthreads();

  // s[4j + 2r + c] is key key0 + 8r, query q0 + 8j + 2 quad + c of the
  // step's tile (dk, dv: key key0 + 8r, column 8j + 2 quad + c)
  const int quad = lane % 4;
  const int key0 = k0 + warp * 16 + lane / 4;
  const float inv_sk = 1.f / Sk;
  float dk[DP / 2], dv[DP / 2], s[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < nqt; ++t) {
    const int q0 = t * BQ;
    if (!needed(t)) continue;
    mbar_wait(&full[stage], phase);
    const uint8_t* sq = sqo + stage * 2 * TB::QT;
    const uint8_t* so = sq + TB::QT;
    wgmma_fence();
    ss_product<DP, BQ>(s, sk, TB::KSUB, sq, TB::QSUB);   // S^T = K Q^T
    ss_product<DP, BQ>(dp, sv, TB::KSUB, so, TB::QSUB);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BQ / 2>(s);
    fence_regs<BQ / 2>(dp);

    // P^T and dS^T in place of S^T and dP^T; L and D are per query, i.e.
    // per column.  Masks and keyless rows only where the tile can hold them.
    const float* lq = sl + stage * BQ;
    const float* dl = sd + stage * BQ;
    const bool edge = window > 0 || (causal && k0 + BT - 1 > q0);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lq + 8 * j + 2 * quad);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * quad);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float lc = c ? l2.y : l2.x, dc = c ? d2.y : d2.x;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * j + 2 * r + c;
          float p = ex2(fmaf(s[e], scale_log2, -lc));
          float ds = p * (dp[e] - dc);
          if (edge) {
            if (isinf(lc)) {  // a row that keeps no key: dV only
              p = inv_sk;
              ds = 0.f;
            } else if (!keeps(q0 + 8 * j + 2 * quad + c, key0 + 8 * r, causal,
                              window)) {
              p = ds = 0.f;
            }
          }
          s[e] = p;
          dp[e] = ds;
        }
      }
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    to_a<BQ / 16>(s, pa);
    to_a<BQ / 16>(dp, da);
    wgmma_fence();
    rs_product<DP, BQ / 16>(dv, pa, so, TB::QSUB);  // dV += P^T dO
    rs_product<DP, BQ / 16>(dk, da, sq, TB::QSUB);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(dv);
    fence_regs<DP / 2>(dk);
    fence_uregs<BQ / 4>(&pa[0][0]);
    fence_uregs<BQ / 4>(&da[0][0]);
    // the stage is read: every warp says so, then thread 0 refills it
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (tid == 0 && t_load < nqt) {
      mbar_wait(&empty[stage], phase);
      t_load = load(t_load, stage);
    }
    __syncwarp();
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

  // this head's partials: ws (2, B, H, Sk, D), keys past Sk not stored
  const long long head = (long long)Sk * D;
  float* wk = ws + ((long long)b * H + h) * head;
  float* wv = wk + (long long)B * H * head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      if (col >= D) continue;  // D % 8 == 0: both columns or neither
      *reinterpret_cast<float2*>(wk + (long long)key * D + col) =
          make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(wv + (long long)key * D + col) =
          make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// SUM_ROWS keys of one KV head: dK = scale * sum of its G heads' partials,
// dV = their sum, added in head order, written through the strides.  A
// thread takes 4 columns of one row and has up to SUM_LOADS partials in
// flight at a time.
__device__ __forceinline__ void sum_heads(const float* __restrict__ ws,
                                          bf16* __restrict__ dk,
                                          bf16* __restrict__ dv, Strides sdk,
                                          Strides sdv, int B, int H, int KV,
                                          int Sk, int D, float scale,
                                          int blk) {
  const int group = H / KV, nrc = (Sk + SUM_ROWS - 1) / SUM_ROWS;
  const int r0 = blk % nrc * SUM_ROWS, kvh = blk / nrc % KV,
            b = blk / (nrc * KV);
  const int rows = min(SUM_ROWS, Sk - r0), c4 = D / 4, per = rows * c4;
  const long long head = (long long)Sk * D;
  const float* base = ws + ((long long)b * H + kvh * group) * head;
  for (int i = threadIdx.x; i < 2 * per; i += blockDim.x) {
    const int tsr = i / per, r = r0 + i % per / c4, c = 4 * (i % c4);
    const float* p = base + tsr * (long long)B * H * head +
                     (long long)r * D + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g0 = 0; g0 < group; g0 += SUM_LOADS) {
      float4 x[SUM_LOADS];
#pragma unroll
      for (int g = 0; g < SUM_LOADS; ++g)
        if (g0 + g < group)
          x[g] = *reinterpret_cast<const float4*>(p + (g0 + g) * head);
#pragma unroll
      for (int g = 0; g < SUM_LOADS; ++g)
        if (g0 + g < group) {
          acc.x += x[g].x;
          acc.y += x[g].y;
          acc.z += x[g].z;
          acc.w += x[g].w;
        }
    }
    const float f = tsr == 0 ? scale : 1.f;
    bf16* out = tsr == 0 ? dk + b * sdk.b + kvh * sdk.h + r * sdk.s
                         : dv + b * sdv.b + kvh * sdv.h + r * sdv.s;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * f, acc.y * f);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * f, acc.w * f);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&lo);
    w.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + c) = w;
  }
}

// (c) blocks [0, n_dq): the 64 queries q0.. of head h against the key tiles
// they keep, dQ through its strides; blocks from n_dq on: sum_heads
template <int DP>
__global__ void __launch_bounds__(W_THREADS, BwdTiles<DP>::MIN_BLOCKS)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv,
                const __grid_constant__ CUtensorMap tmdo,
                const float* __restrict__ stats, const float* __restrict__ ws,
                bf16* __restrict__ dq, bf16* __restrict__ dk,
                bf16* __restrict__ dv, Strides sdq, Strides sdk, Strides sdv,
                int B, int H, int KV, int Sq, int Sk, int ld, int D,
                int causal, int window, float scale_log2, float scale,
                int n_dq) {
  using namespace hopper;
  using TB = BwdTiles<DP>;
  constexpr int STAGES = TB::DQ_STAGES;
  if ((int)blockIdx.x >= n_dq) {
    sum_heads(ws, dk, dv, sdk, sdv, B, H, KV, Sk, D, scale,
              blockIdx.x - n_dq);
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* so = sq + TB::KT;  // dO
  uint8_t* skv = so + TB::KT;  // stage s: K at 2 KT s, V KT after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skv + STAGES * 2 * TB::KT);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // under causal the last query tile keeps the most key tiles: it goes first
  const int hb = blockIdx.x % (H * B), h = hb % H, b = hb / H;
  const int t = blockIdx.x / (H * B), nqt = (Sq + BT - 1) / BT;
  const int q0 = (causal ? nqt - 1 - t : t) * BT, kvh = h / (H / KV);
  int kt_begin, kt_end;
  key_tiles(q0, min(q0 + BT, Sq) - 1, BT, Sk, causal, window, &kt_begin,
            &kt_end);
  // thread 0: K and V tile kt into ``stage``
  auto load = [&](int kt, int stage) {
    mbar_expect_tx(&full[stage], 2 * TB::KT);
    uint8_t* sk = skv + stage * 2 * TB::KT;
#pragma unroll
    for (int c = 0; c < TB::NSUB; ++c) {
      tma_load_4d(sk + c * TB::KSUB, &tmk, &full[stage], 64 * c, kt * BT,
                  kvh, b);
      tma_load_4d(sk + TB::KT + c * TB::KSUB, &tmv, &full[stage], 64 * c,
                  kt * BT, kvh, b);
    }
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    mbar_fence_init();
    mbar_expect_tx(q_full, 2 * TB::KT);
#pragma unroll
    for (int c = 0; c < TB::NSUB; ++c) {
      tma_load_4d(sq + c * TB::KSUB, &tmq, q_full, 64 * c, q0, h, b);
      tma_load_4d(so + c * TB::KSUB, &tmdo, q_full, 64 * c, q0, h, b);
    }
    for (int s = 0; s < STAGES && kt_begin + s < kt_end; ++s)
      load(kt_begin + s, s);
  }
  __syncthreads();

  // consumer: s[4j + 2r + c] is query row0 + 8r, key k0 + 8j + 2 quad + c
  const int quad = lane % 4;
  const int row0 = q0 + warp * 16 + lane / 4;
  const long long row_h = ((long long)b * H + h) * ld;
  float l2[2], dd[2];  // L log2(e) and D of the two rows (zeros past Sq)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l2[r] = stats[row_h + row0 + 8 * r];
    dd[r] = stats[(long long)B * H * ld + row_h + row0 + 8 * r];
  }
  float acc[DP / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    mbar_wait(&full[stage], phase);
    const uint8_t* sk = skv + stage * 2 * TB::KT;
    const uint8_t* sv = sk + TB::KT;
    wgmma_fence();
    ss_product<DP, 64>(s, sq, TB::KSUB, sk, TB::KSUB);   // S = Q K^T
    ss_product<DP, 64>(dp, so, TB::KSUB, sv, TB::KSUB);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);
    fence_regs<32>(dp);

    // keys past Sk meet zero rows of K, but exp(-L) alone may overflow
    const bool edge =
        window > 0 || (causal && k0 + BT - 1 > q0) || k0 + BT > Sk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * r + c, kpos = k0 + 8 * j + 2 * quad + c;
          float ds = ex2(fmaf(s[e], scale_log2, -l2[r])) * (dp[e] - dd[r]);
          if (edge && (isinf(l2[r]) || kpos >= Sk ||
                       !keeps(row0 + 8 * r, kpos, causal, window)))
            ds = 0.f;  // masked, absent, or a row that keeps no key
          dp[e] = ds;
        }
    uint32_t da[4][4];
    to_a<4>(dp, da);
    wgmma_fence();
    rs_product<DP, 4>(acc, da, sk, TB::KSUB);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(acc);
    fence_uregs<16>(&da[0][0]);
    // the stage is read: every warp says so, then thread 0 refills it
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (tid == 0 && kt + STAGES < kt_end) {
      mbar_wait(&empty[stage], phase);
      load(kt + STAGES, stage);
    }
    __syncwarp();
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    bf16* out = dq + b * sdq.b + h * sdq.h + row * sdq.s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// ---- launches ---------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* scratch;
  void *dq, *dk, *dv;
  int B, H, KV, Sq, Sk, D;
  Strides sq, sk, sv, so, sd, sdq, sdk, sdv;
  int causal, window;
  float scale;
  cudaStream_t stream;
};

// D of rows (b * H + h) * ld + s into ``delta`` (and, with ``lse2``, L
// log2(e) beside it)
template <typename T>
cudaError_t launch_delta(const Args& a, float* delta, float* lse2, int ld) {
  const long long rows = (long long)a.B * a.H * ld;
  const int chunks = a.D * (int)sizeof(T) / 16;  // 16-byte loads a row
  const int lanes = chunks <= 4 ? 4 : chunks <= 8 ? 8 : chunks <= 16 ? 16 : 32;
  const unsigned blocks = (unsigned)((rows * lanes + 255) / 256);
  const T* o = static_cast<const T*>(a.o);
  const T* d = static_cast<const T*>(a.dout);
  switch (lanes) {
    case 4: delta_kernel<T, 4><<<blocks, 256, 0, a.stream>>>(o, d, a.lse, delta, lse2, a.so, a.sd, a.H, a.Sq, ld, a.D, rows); break;
    case 8: delta_kernel<T, 8><<<blocks, 256, 0, a.stream>>>(o, d, a.lse, delta, lse2, a.so, a.sd, a.H, a.Sq, ld, a.D, rows); break;
    case 16: delta_kernel<T, 16><<<blocks, 256, 0, a.stream>>>(o, d, a.lse, delta, lse2, a.so, a.sd, a.H, a.Sq, ld, a.D, rows); break;
    default: delta_kernel<T, 32><<<blocks, 256, 0, a.stream>>>(o, d, a.lse, delta, lse2, a.so, a.sd, a.H, a.Sq, ld, a.D, rows); break;
  }
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  // above 48 KB dynamic shared memory must be asked for, per device
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  float* delta = a.scratch;  // (B, H, Sq)
  cudaError_t err = launch_delta<float>(a, delta, nullptr, a.Sq);
  if (err != cudaSuccess) return err;
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *d = static_cast<const float*>(a.dout);
  auto dkdv = dkdv_f32_kernel<D>;
  if ((err = allow_smem(dkdv, f32_dkdv_smem<D>())) != cudaSuccess) return err;
  dkdv<<<dim3((a.Sk + FT - 1) / FT, a.KV, a.B), F_THREADS, f32_dkdv_smem<D>(),
         a.stream>>>(q, k, v, d, a.lse, delta, static_cast<float*>(a.dk),
                     static_cast<float*>(a.dv), a.sq, a.sk, a.sv, a.sd, a.sdk,
                     a.sdv, a.H, a.H / a.KV, a.Sq, a.Sk, a.causal, a.window,
                     a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dqk = dq_f32_kernel<D>;
  if ((err = allow_smem(dqk, f32_dq_smem<D>())) != cudaSuccess) return err;
  dqk<<<dim3((a.Sq + FT - 1) / FT, a.H, a.B), F_THREADS, f32_dq_smem<D>(),
        a.stream>>>(q, k, v, d, a.lse, delta, static_cast<float*>(a.dq),
                    a.sq, a.sk, a.sv, a.sd, a.sdq, a.H, a.H / a.KV, a.Sq,
                    a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// hopper's rank-4 map over one (B, heads, S, D) tensor
cudaError_t encode_bhsd(CUtensorMap* map, const void* base, int B, int heads,
                        int S, int D, Strides st, int rows) {
  return (cudaError_t)hopper::encode_bhsd(map, base, B, heads, S, D, st.b,
                                          st.h, st.s, rows);
}

template <int DP>
cudaError_t launch_bf16(const Args& a) {
  using TB = BwdTiles<DP>;
  const int ld = (a.Sq + BT - 1) / BT * BT;
  const long long rows = (long long)a.B * a.H * ld;
  float* stats = a.scratch;  // L log2(e) rows, then D rows, then ws
  float* ws = a.scratch + 2 * rows;
  cudaError_t err = launch_delta<bf16>(a, stats + rows, stats, ld);
  if (err != cudaSuccess) return err;
  CUtensorMap tmq, tmdo, tmk, tmv, tmq64, tmdo64;
  if ((err = encode_bhsd(&tmq, a.q, a.B, a.H, a.Sq, a.D, a.sq, TB::BQ)) ||
      (err = encode_bhsd(&tmdo, a.dout, a.B, a.H, a.Sq, a.D, a.sd, TB::BQ)) ||
      (err = encode_bhsd(&tmk, a.k, a.B, a.KV, a.Sk, a.D, a.sk, BT)) ||
      (err = encode_bhsd(&tmv, a.v, a.B, a.KV, a.Sk, a.D, a.sv, BT)))
    return err;
  if (TB::BQ == BT) {
    tmq64 = tmq;
    tmdo64 = tmdo;
  } else if ((err = encode_bhsd(&tmq64, a.q, a.B, a.H, a.Sq, a.D, a.sq, BT)) ||
             (err = encode_bhsd(&tmdo64, a.dout, a.B, a.H, a.Sq, a.D, a.sd,
                                BT))) {
    return err;
  }
  const float scale_log2 = a.scale * LOG2E;
  const int nkt = (a.Sk + BT - 1) / BT, nqt = (a.Sq + BT - 1) / BT;
  auto dkdv = dkdv_wgmma_kernel<DP>;
  if ((err = allow_smem(dkdv, TB::DKDV_SMEM)) != cudaSuccess) return err;
  dkdv<<<nkt * a.H * a.B, W_THREADS, TB::DKDV_SMEM, a.stream>>>(
      tmq, tmk, tmv, tmdo, stats, ws, a.B, a.H, a.H / a.KV, a.Sq, a.Sk, ld,
      a.D, a.causal, a.window, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_dq = nqt * a.H * a.B;
  const int n_sum = a.B * a.KV * ((a.Sk + SUM_ROWS - 1) / SUM_ROWS);
  auto dqk = dq_wgmma_kernel<DP>;
  if ((err = allow_smem(dqk, TB::DQ_SMEM)) != cudaSuccess) return err;
  dqk<<<n_dq + n_sum, W_THREADS, TB::DQ_SMEM, a.stream>>>(
      tmq64, tmk, tmv, tmdo64, stats, ws, static_cast<bf16*>(a.dq),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sdq, a.sdk,
      a.sdv, a.B, a.H, a.KV, a.Sq, a.Sk, ld, a.D, a.causal, a.window,
      scale_log2, a.scale, n_dq);
  return cudaGetLastError();
}

bool aligned16(const void* p, Strides st, int elems16) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % elems16 == 0 &&
         st.h % elems16 == 0 && st.s % elems16 == 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  window <= 0: no window.  lse: the forward's
// row statistics, f32 (B, H, Sq) contiguous.  scratch: f32, 16-byte
// aligned, of flash_attn_bwd_scratch(...) floats: f32, D (B, H, Sq); bf16,
// L log2(e) and D (B, H, ld) each, ld = Sq rounded up to 64, then the
// partial dK and dV (2, B, H, Sk, D).  Strides in elements (D has unit
// stride), three per tensor, in the order q, k, v, o, dO, dQ, dK, dV;
// every pointer and stride 16-byte aligned.  Launches three kernels on
// ``stream``; returns the first launch's error (0 on success), or the
// error that kept it from launching; does not synchronise.
extern "C" int flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* scratch, void* dq, void* dk,
    void* dv, int B, int H, int KV, int Sq, int Sk, int D, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, long long dsb, long long dsh, long long dss, long long dqsb,
    long long dqsh, long long dqss, long long dksb, long long dksh,
    long long dkss, long long dvsb, long long dvsh, long long dvss,
    int causal, int window, int dtype, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, KV, Sq, Sk,
               D, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
               {osb, osh, oss}, {dsb, dsh, dss}, {dqsb, dqsh, dqss},
               {dksb, dksh, dkss}, {dvsb, dvsh, dvss}, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  const int e16 = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  if (!(aligned16(q, a.sq, e16) && aligned16(k, a.sk, e16) &&
        aligned16(v, a.sv, e16) && aligned16(o, a.so, e16) &&
        aligned16(dout, a.sd, e16) && aligned16(dq, a.sdq, e16) &&
        aligned16(dk, a.sdk, e16) && aligned16(dv, a.sdv, e16) &&
        reinterpret_cast<uintptr_t>(scratch) % 16 == 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0) {
    switch (D) {
      case 32: err = launch_f32<32>(a); break;
      case 64: err = launch_f32<64>(a); break;
      case 80: err = launch_f32<80>(a); break;
      case 128: err = launch_f32<128>(a); break;
      default: err = cudaErrorInvalidValue;
    }
  } else if (dtype == 1) {
    switch (D) {  // padded to whole 64-column sub-tiles
      case 32:
      case 64: err = launch_bf16<64>(a); break;
      case 80:
      case 128: err = launch_bf16<128>(a); break;
      default: err = cudaErrorInvalidValue;
    }
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// floats of the scratch buffer flash_attn_bwd takes
extern "C" long long flash_attn_bwd_scratch(int B, int H, int Sq, int Sk,
                                            int D, int dtype) {
  if (dtype == 0) return (long long)B * H * Sq;
  const long long ld = (Sq + BT - 1) / BT * BT;
  return 2LL * B * H * ld + 2LL * B * H * Sk * D;
}

extern "C" const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
