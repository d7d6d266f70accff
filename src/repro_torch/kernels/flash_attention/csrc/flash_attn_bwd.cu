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
// accumulated in f32.
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
// Three launches a call (LAUNCHES_PER_CALL in ops.py):
//   (a) delta_kernel: D_i = rowsum(dO_i o O_i), one warp a row, f32;
//   (b) dkdv: one block per KV head and 64-key tile.  It walks the G
//       query heads that share the KV head and the query tiles that can
//       see the key tile (none wholly before the diagonal under causal,
//       none wholly past the window unless it holds a keyless row),
//       recomputes S^T and P^T, dP^T = V dO^T, dS^T = P^T o (dP^T - D),
//       and accumulates dV += P^T dO and dK += dS^T Q in registers.  Two
//       warpgroups take alternate steps of the walk, each on its own query
//       tiles, and the second hands its sums to the first through shared
//       memory at the end: the G heads sum in one block, with no atomics,
//       in a fixed order, so the result is deterministic;
//   (c) dq: one block per query tile and head, looping over the key tiles
//       the forward visits, dQ += dS K, in registers.
//   dK and dQ take the factor `scale` once, when stored.
//
// What bounds it on this card.  The gradient needs five D-deep products
// per (query, key) pair kept (S, dP, dV, dK, dQ), against the forward's
// two; this kernel does seven (S and dP in both (b) and (c)).  At
// qwen2-0.5b's training shape (B 4 x S 512, H 14, KV 2, D 64, causal,
// bf16) the five take 4.7 GFLOP, 4.8 us at the bf16 tensor-core rate,
// against 16.9 MB of q, k, v, o, dO, the statistics, dQ, dK and dV, 5.0
// us at 3.35 TB/s: the two bounds meet.  This first version is bound by
// neither: (b) has B x KV x Sk / 64 blocks (64 at that shape, half the
// SMs), the first key tile's walking G x 8 steps, and within a step the
// loads and the products do not overlap.
//
// bf16: mma.sync m16n8k16 (bf16 operands, f32 accumulators), four warps a
// warpgroup (two in (b), one in (c)), each warp owning 16 rows of the
// block's tile.  Operands come from
// shared memory, where each tile is stored both row-major and, where a
// product contracts over its rows, transposed (rows padded by 8 elements so
// that the 32-bit fragment loads of a warp hit 32 different banks).  P and
// dS go from the accumulator layout of one product straight into the A
// registers of the next (the m16n8 accumulator pair is the m16n8k16 A
// fragment).  wgmma and TMA are later work.
//
// f32 (parity runs): full f32 on the CUDA cores, no TF32 (which keeps ~3
// decimal digits), like the forward's f32 variant: 256 threads, each
// owning a 4 x 4 block of a 64 x 64 score tile, operands read as float4
// from transposed tiles in shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, Strides so, Strides sd, int H, int Sq,
             int D, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = (int)(row % Sq);
  const long long bh = row / Sq;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const T* orow = o + b * so.b + h * so.h + s * so.s;
  const T* drow = dout + b * sd.b + h * sd.h + s * sd.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_f(orow[c]) * to_f(drow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---- loading tiles ----------------------------------------------------------
// One 16-byte chunk of a tile row into the row-major copy d[ROWS][ld] and
// the transposed copy dT[D][ldt] (either may be null).
template <typename T>
__device__ __forceinline__ void store_chunk(T* d, T* dT, int ld, int ldt,
                                            int r, int c, uint4 x) {
  constexpr int VEC = 16 / sizeof(T);
  if (d) *reinterpret_cast<uint4*>(d + r * ld + c) = x;
  if (dT) {
    const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dT[(c + i) * ldt + r] = e[i];
  }
}

// Rows row0..row0+ROWS-1 (zeros past S) of two heads a and b of (B,heads,
// S,D) tensors into shared memory, each row-major and/or transposed.
// Consecutive threads take consecutive rows of one column chunk, so the
// transposed stores of a warp hit 32 different banks (and the row-major
// 16-byte stores, rows padded, 8 a phase); every thread issues all its
// global loads before its first store, so they are in flight together.
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tiles(
    T* da, T* daT, const T* sa, long long ssa, T* db, T* dbT, const T* sb,
    long long ssb, int ld, int ldt, int row0, int S, int tid) {
  constexpr int VEC = 16 / sizeof(T), TOTAL = ROWS * (D / VEC);
  constexpr int N = (TOTAL + THREADS - 1) / THREADS;
  uint4 xa[N], xb[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = tid + i * THREADS, r = idx % ROWS, c = idx / ROWS * VEC;
    xa[i] = xb[i] = make_uint4(0u, 0u, 0u, 0u);
    if (idx < TOTAL && row0 + r < S) {
      xa[i] = *reinterpret_cast<const uint4*>(sa + (row0 + r) * ssa + c);
      xb[i] = *reinterpret_cast<const uint4*>(sb + (row0 + r) * ssb + c);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = tid + i * THREADS, r = idx % ROWS, c = idx / ROWS * VEC;
    if (idx >= TOTAL) continue;
    store_chunk(da, daT, ld, ldt, r, c, xa[i]);
    store_chunk(db, dbT, ld, ldt, r, c, xb[i]);
  }
}

// ---- f32: CUDA cores --------------------------------------------------------
constexpr int FT = 64;          // keys and queries of an f32 tile
constexpr int F_THREADS = 256;  // 16 x 16: thread (ty, tx) owns a 4 x 4 block
constexpr int FLD = FT + 4;     // padded row (floats) of a transposed tile

// two heads' tiles of FT rows, transposed into [D][FLD]
template <int D>
__device__ __forceinline__ void load_t_f32(float* da, const float* sa,
                                           long long ssa, float* db,
                                           const float* sb, long long ssb,
                                           int row0, int S, int tid) {
  load_tiles<float, D, FT, F_THREADS>(nullptr, da, sa, ssa, nullptr, db, sb,
                                      ssb, 0, FLD, row0, S, tid);
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

// ---- bf16: mma.sync on the tensor cores ------------------------------------
typedef __nv_bfloat16 bf16;
constexpr int B_THREADS = 128;  // four warps, 16 rows each
constexpr int BT = 64;          // keys of a dK/dV block; queries of a dQ block

// acc (16 x 8, f32) += A (16 x 16, bf16 pairs) B (16 x 8, bf16 pairs)
__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special function unit, as in the forward; -inf gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc[n] (16 x 8 tiles, n < NT) += A B^T over KD: A (16 x KD) row-major at
// a (row stride lda), B (NT*8 x KD) row-major at b (row stride ldb); lane
// (g, t) = (lane / 4, lane % 4) in the m16n8k16 fragment layout
template <int KD, int NT>
__device__ __forceinline__ void mma_smem(float (*acc)[4], const bf16* a,
                                         int lda, const bf16* b, int ldb,
                                         int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    const bf16* ar = a + g * lda + kk + 2 * t;
    const uint32_t a0 = ld32(ar), a1 = ld32(ar + 8 * lda), a2 = ld32(ar + 8),
                   a3 = ld32(ar + 8 * lda + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* br = b + (n * 8 + g) * ldb + kk + 2 * t;
      mma16816(acc[n], a0, a1, a2, a3, ld32(br), ld32(br + 8));
    }
  }
}

// the accumulator tiles x[KQ/8][4] of one product as the A fragments of the
// next, in bf16: pa[j] covers columns 16j..16j+15
template <int KQ>
__device__ __forceinline__ void to_a_frags(float (*x)[4],
                                           uint32_t (*pa)[4]) {
#pragma unroll
  for (int j = 0; j < KQ / 16; ++j) {
    pa[j][0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    pa[j][1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    pa[j][2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    pa[j][3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
  }
}

// acc[n] (16 x 8 tiles, n < NT) += A B over KQ: A from registers (pa), B^T
// (NT*8 x KQ) row-major at b (row stride ldb)
template <int KQ, int NT>
__device__ __forceinline__ void mma_regs(float (*acc)[4],
                                         uint32_t (*pa)[4],
                                         const bf16* b, int ldb, int g,
                                         int t) {
#pragma unroll
  for (int j = 0; j < KQ / 16; ++j) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* br = b + (n * 8 + g) * ldb + 16 * j + 2 * t;
      mma16816(acc[n], pa[j][0], pa[j][1], pa[j][2], pa[j][3], ld32(br),
               ld32(br + 8));
    }
  }
}

// The dK/dV block: 64 keys and two warpgroups of four warps (each warp 16
// keys) that take alternate steps of the walk over (query head, query
// tile), BQ queries a step (32 at D > 64, where the f32 accumulators of
// dK and dV take 128 registers), each warpgroup with its own query tiles.
constexpr int DKDV_THREADS = 256;

template <int D>
struct DkdvTile {
  static constexpr int BQ = D <= 64 ? 64 : 32;
  static constexpr int LDR = D + 8;   // row-major tiles
  static constexpr int LDT = BQ + 8;  // transposed query tiles
  // one warpgroup's query tiles: Q and dO row-major and transposed, the
  // statistics and D
  static constexpr int WG_BYTES =
      sizeof(bf16) * (2 * BQ * LDR + 2 * D * LDT) + sizeof(float) * 2 * BQ;
  static constexpr size_t SMEM = sizeof(bf16) * 2 * BT * LDR + 2 * WG_BYTES;
  // the second warpgroup hands dK, then dV (D / 2 floats a thread), to the
  // first through its own tiles
  static_assert(WG_BYTES >= B_THREADS * D / 2 * sizeof(float) &&
                WG_BYTES % 16 == 0, "warpgroup tiles");
};

// acc of the first warpgroup's thread += acc of the second's thread of the
// same rank, through red (the second warpgroup's tiles, free by then)
template <int ND>
__device__ __forceinline__ void hand_over(float (*acc)[4], float* red, int wg,
                                          int wtid) {
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(n * 4 + e) * 128 + wtid] = acc[n][e];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += red[(n * 4 + e) * 128 + wtid];
  }
}

// the named barrier of one warpgroup (ids 1 and 2; __syncthreads is 0)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

template <int D>
__global__ void __launch_bounds__(DKDV_THREADS)
dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, Strides sq_, Strides sk_, Strides sv_,
                 Strides sd_, Strides sdk, Strides sdv, int H, int group,
                 int Sq, int Sk, int causal, int window, float scale) {
  using TL = DkdvTile<D>;
  constexpr int BQ = TL::BQ, LDR = TL::LDR, LDT = TL::LDT;
  constexpr int NQ = BQ / 8, ND = D / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [BT][LDR]
  bf16* sV = sK + BT * LDR;                       // [BT][LDR]
  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;  // warp within the warpgroup
  const int g = lane / 4, t = lane % 4;
  uint8_t* own = smem_raw + sizeof(bf16) * 2 * BT * LDR + wg * TL::WG_BYTES;
  bf16* sQ = reinterpret_cast<bf16*>(own);        // [BQ][LDR]
  bf16* sO = sQ + BQ * LDR;                       // [BQ][LDR] dO
  bf16* sQt = sO + BQ * LDR;                      // [D][LDT]
  bf16* sOt = sQt + D * LDT;                      // [D][LDT] dO, transposed
  float* sL = reinterpret_cast<float*>(sOt + D * LDT);  // [BQ] L * log2(e)
  float* sDl = sL + BQ;                                 // [BQ] D

  const int k0 = blockIdx.x * BT, kvh = blockIdx.y, b = blockIdx.z;
  load_tiles<bf16, D, BT, DKDV_THREADS>(
      sK, nullptr, k + b * sk_.b + kvh * sk_.h, sk_.s, sV, nullptr,
      v + b * sv_.b + kvh * sv_.h, sv_.s, LDR, 0, k0, Sk, tid);
  __syncthreads();
  const bf16* kw = sK + warp * 16 * LDR;  // this warp's 16 keys
  const bf16* vw = sV + warp * 16 * LDR;

  float dK[ND][4], dV[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[n][e] = dV[n][e] = 0.f;

  const int k_last = min(k0 + BT, Sk) - 1;
  const int t_begin = causal ? k0 / BQ : 0;
  const int nt = max((Sq + BQ - 1) / BQ - t_begin, 0);
  const float inv_sk = 1.f / Sk, scale_log2 = scale * LOG2E;
  // step it: query head kvh * group + it / nt, query tile t_begin + it % nt
  for (int it = wg; it < group * nt; it += 2) {
    const int h = kvh * group + it / nt, q0 = (t_begin + it % nt) * BQ;
    if (!tile_needed(q0, min(q0 + BQ, Sq) - 1, k_last, Sk, window)) continue;
    const long long rowh = ((long long)b * H + h) * Sq;
    // the rows' statistics (+inf stays +inf) and D, loaded with the tiles
    const bool in = wtid < BQ && q0 + wtid < Sq;
    const float l_row = in ? lse[rowh + q0 + wtid] * LOG2E : 0.f;
    const float d_row = in ? delta[rowh + q0 + wtid] : 0.f;
    wg_sync(wg);  // this warpgroup's previous tile is no longer read
    load_tiles<bf16, D, BQ, B_THREADS>(
        sQ, sQt, q + b * sq_.b + h * sq_.h, sq_.s, sO, sOt,
        dout + b * sd_.b + h * sd_.h, sd_.s, LDR, LDT, q0, Sq, wtid);
    if (wtid < BQ) {
      sL[wtid] = l_row;
      sDl[wtid] = d_row;
    }
    wg_sync(wg);

    // S^T = K Q^T and dP^T = V dO^T: rows this warp's keys, columns queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_smem<D, NQ>(s, kw, LDR, sQ, LDR, g, t);
    mma_smem<D, NQ>(dp, vw, LDR, sO, LDR, g, t);

    // P^T and dS^T in place of S^T and dP^T
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + warp * 16 + g + (e >= 2 ? 8 : 0);
        const int ql = n * 8 + 2 * t + (e & 1), qpos = q0 + ql;
        float p = 0.f, ds = 0.f;
        if (qpos < Sq && kpos < Sk) {
          const float L2 = sL[ql];
          if (isinf(L2)) {
            p = inv_sk;  // a row that keeps no key: dV only
          } else if (keeps(qpos, kpos, causal, window)) {
            p = ex2(s[n][e] * scale_log2 - L2);
            ds = p * (dp[n][e] - sDl[ql]);
          }
        }
        s[n][e] = p;
        dp[n][e] = ds;
      }
    }
    uint32_t pa[BQ / 16][4];
    to_a_frags<BQ>(s, pa);
    mma_regs<BQ, ND>(dV, pa, sOt, LDT, g, t);  // dV += P^T dO
    to_a_frags<BQ>(dp, pa);
    mma_regs<BQ, ND>(dK, pa, sQt, LDT, g, t);  // dK += dS^T Q
  }

  // the second warpgroup's sums into the first's, dK then dV, always in
  // this order: the result does not depend on timing
  float* red = reinterpret_cast<float*>(smem_raw + sizeof(bf16) * 2 * BT * LDR +
                                        TL::WG_BYTES);
  hand_over<ND>(dK, red, wg, wtid);
  hand_over<ND>(dV, red, wg, wtid);
  if (wg == 1) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k0 + warp * 16 + g + 8 * r;
    if (kpos >= Sk) continue;
    bf16* dkr = dk + b * sdk.b + kvh * sdk.h + kpos * sdk.s;
    bf16* dvr = dv + b * sdv.b + kvh * sdv.h + kpos * sdv.s;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkr + col) = __floats2bfloat162_rn(
          dK[n][2 * r] * scale, dK[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + col) =
          __floats2bfloat162_rn(dV[n][2 * r], dV[n][2 * r + 1]);
    }
  }
}

template <int D>
struct DqTile {
  static constexpr int LDR = D + 8;   // row-major tiles
  static constexpr int LDT = BT + 8;  // the transposed key tile
  static constexpr size_t SMEM = sizeof(bf16) * (4 * BT * LDR + D * LDT);
};

template <int D>
__global__ void __launch_bounds__(B_THREADS)
dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dq, Strides sq_, Strides sk_, Strides sv_,
               Strides sd_, Strides sdq, int H, int group, int Sq, int Sk,
               int causal, int window, float scale) {
  using TL = DqTile<D>;
  constexpr int LDR = TL::LDR, LDT = TL::LDT;
  constexpr int NK = BT / 8, ND = D / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BT][LDR]
  bf16* sO = sQ + BT * LDR;                       // [BT][LDR] dO
  bf16* sK = sO + BT * LDR;                       // [BT][LDR]
  bf16* sV = sK + BT * LDR;                       // [BT][LDR]
  bf16* sKt = sV + BT * LDR;                      // [D][LDT]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  load_tiles<bf16, D, BT, B_THREADS>(
      sQ, nullptr, q + b * sq_.b + h * sq_.h, sq_.s, sO, nullptr,
      dout + b * sd_.b + h * sd_.h, sd_.s, LDR, 0, q0, Sq, tid);
  const bf16* kb = k + b * sk_.b + kvh * sk_.h;
  const bf16* vb = v + b * sv_.b + kvh * sv_.h;
  const bf16* qw = sQ + warp * 16 * LDR;  // this warp's 16 queries
  const bf16* ow = sO + warp * 16 * LDR;
  const long long rowh = ((long long)b * H + h) * Sq;
  const float scale_log2 = scale * LOG2E;
  float L2[2], Dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + warp * 16 + g + 8 * r;
    L2[r] = qpos < Sq ? lse[rowh + qpos] * LOG2E : INFINITY;
    Dl[r] = qpos < Sq ? delta[rowh + qpos] : 0.f;
  }
  float dQ[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dQ[n][e] = 0.f;

  int kt_begin, kt_end;
  key_tiles(q0, min(q0 + BT, Sq) - 1, BT, Sk, causal, window, &kt_begin,
            &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile is no longer read
    // K's transposed copy shares the loop; V needs only its rows
    load_tiles<bf16, D, BT, B_THREADS>(sK, sKt, kb, sk_.s, sV, nullptr, vb,
                                       sv_.s, LDR, LDT, k0, Sk, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows this warp's queries, columns keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_smem<D, NK>(s, qw, LDR, sK, LDR, g, t);
    mma_smem<D, NK>(dp, ow, LDR, sV, LDR, g, t);
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qpos = q0 + warp * 16 + g + 8 * r;
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        float ds = 0.f;
        if (kpos < Sk && keeps(qpos, kpos, causal, window) && !isinf(L2[r]))
          ds = ex2(s[n][e] * scale_log2 - L2[r]) * (dp[n][e] - Dl[r]);
        dp[n][e] = ds;
      }
    }
    uint32_t pa[BT / 16][4];
    to_a_frags<BT>(dp, pa);
    mma_regs<BT, ND>(dQ, pa, sKt, LDT, g, t);  // dQ += dS K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + warp * 16 + g + 8 * r;
    if (qpos >= Sq) continue;
    bf16* dqr = dq + b * sdq.b + h * sdq.h + qpos * sdq.s;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqr + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dQ[n][2 * r] * scale, dQ[n][2 * r + 1] * scale);
  }
}

// ---- launches ---------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, H, KV, Sq, Sk, D;
  Strides sq, sk, sv, so, sd, sdq, sdk, sdv;
  int causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_delta(const Args& a) {
  const long long rows = (long long)a.B * a.H * a.Sq;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      a.so, a.sd, a.H, a.Sq, a.D, rows);
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
  cudaError_t err = launch_delta<float>(a);
  if (err != cudaSuccess) return err;
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *d = static_cast<const float*>(a.dout);
  auto dkdv = dkdv_f32_kernel<D>;
  if ((err = allow_smem(dkdv, f32_dkdv_smem<D>())) != cudaSuccess) return err;
  dkdv<<<dim3((a.Sk + FT - 1) / FT, a.KV, a.B), F_THREADS, f32_dkdv_smem<D>(),
         a.stream>>>(q, k, v, d, a.lse, a.delta, static_cast<float*>(a.dk),
                     static_cast<float*>(a.dv), a.sq, a.sk, a.sv, a.sd, a.sdk,
                     a.sdv, a.H, a.H / a.KV, a.Sq, a.Sk, a.causal, a.window,
                     a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dqk = dq_f32_kernel<D>;
  if ((err = allow_smem(dqk, f32_dq_smem<D>())) != cudaSuccess) return err;
  dqk<<<dim3((a.Sq + FT - 1) / FT, a.H, a.B), F_THREADS, f32_dq_smem<D>(),
        a.stream>>>(q, k, v, d, a.lse, a.delta, static_cast<float*>(a.dq),
                    a.sq, a.sk, a.sv, a.sd, a.sdq, a.H, a.H / a.KV, a.Sq,
                    a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  cudaError_t err = launch_delta<bf16>(a);
  if (err != cudaSuccess) return err;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *d = static_cast<const bf16*>(a.dout);
  constexpr size_t dkdv_smem = DkdvTile<D>::SMEM, dq_smem = DqTile<D>::SMEM;
  auto dkdv = dkdv_bf16_kernel<D>;
  if ((err = allow_smem(dkdv, dkdv_smem)) != cudaSuccess) return err;
  dkdv<<<dim3((a.Sk + BT - 1) / BT, a.KV, a.B), DKDV_THREADS, dkdv_smem,
         a.stream>>>(q, k, v, d, a.lse, a.delta, static_cast<bf16*>(a.dk),
                     static_cast<bf16*>(a.dv), a.sq, a.sk, a.sv, a.sd, a.sdk,
                     a.sdv, a.H, a.H / a.KV, a.Sq, a.Sk, a.causal, a.window,
                     a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dqk = dq_bf16_kernel<D>;
  if ((err = allow_smem(dqk, dq_smem)) != cudaSuccess) return err;
  dqk<<<dim3((a.Sq + BT - 1) / BT, a.H, a.B), B_THREADS, dq_smem,
        a.stream>>>(q, k, v, d, a.lse, a.delta, static_cast<bf16*>(a.dq),
                    a.sq, a.sk, a.sv, a.sd, a.sdq, a.H, a.H / a.KV, a.Sq,
                    a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

bool aligned16(const void* p, Strides st, int elems16) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % elems16 == 0 &&
         st.h % elems16 == 0 && st.s % elems16 == 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  window <= 0: no window.  lse: the forward's
// row statistics, f32 (B, H, Sq) contiguous; delta: f32 scratch of the same
// size.  Strides in elements (D has unit stride), three per tensor, in the
// order q, k, v, o, dO, dQ, dK, dV; every pointer and stride 16-byte
// aligned.  Launches three kernels on ``stream``; returns the first
// launch's error (0 on success), or the error that kept it from
// launching; does not synchronise.
extern "C" int flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int KV, int Sq, int Sk, int D, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, long long dsb, long long dsh, long long dss, long long dqsb,
    long long dqsh, long long dqss, long long dksb, long long dksh,
    long long dkss, long long dvsb, long long dvsh, long long dvss,
    int causal, int window, int dtype, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KV, Sq, Sk, D,
               {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
               {osb, osh, oss}, {dsb, dsh, dss}, {dqsb, dqsh, dqss},
               {dksb, dksh, dkss}, {dvsb, dvsh, dvss}, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  const int e16 = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  if (!(aligned16(q, a.sq, e16) && aligned16(k, a.sk, e16) &&
        aligned16(v, a.sv, e16) && aligned16(o, a.so, e16) &&
        aligned16(dout, a.sd, e16) && aligned16(dq, a.sdq, e16) &&
        aligned16(dk, a.sdk, e16) && aligned16(dv, a.sdv, e16)))
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
    switch (D) {
      case 32: err = launch_bf16<32>(a); break;
      case 64: err = launch_bf16<64>(a); break;
      case 80: err = launch_bf16<80>(a); break;
      case 128: err = launch_bf16<128>(a); break;
      default: err = cudaErrorInvalidValue;
    }
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
