// Mamba2 SSD chunked scan, backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the Pallas kernel
//   src/repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel
// is forward-only, and the JAX trainer differentiates the jnp scan
// (src/repro/models/ssm.py:ssd_chunked).  The port runs its forward
// (csrc/ssd_scan_fwd.cu, K6) on the training path, so its gradient needs a
// kernel of its own.  Given dy (B,H,L,P), it returns dx (B,H,L,P), ddt
// (B,H,L), da (H,), db and dc (B,L,N), all f32 (the model always runs the
// scan in f32).  Per chunk of Q rows, with cs = cumsum(dt a), e = exp(cs),
// w = exp(cs_Q - cs) dt, h the state before the chunk and G the gradient
// of the state after it (ref.ssd_scan_bwd_ref writes the same stages out
// in PyTorch):
//   (i)   dH_c = (dy_c o e)^T C_c                               dstate_kernel
//   (ii)  G_{c-1} = dH_c + exp(cs_Q,c) G_c, G_last = 0           carry_kernel
//   (iii) D = dy x^T, L[i,j] = exp(cs_i - cs_j) (j <= i), M = (C B^T) o L,
//         dCB = D o L o dt_j; dx = dt o (M^T dy) + w o (B G^T);
//         dC = dCB B + e o (dy h), dB = dCB^T C + w o (x G), per head;
//         d(dt a) at row m, the sum of d cs over rows k >= m, term by term
//         in forms that do not cancel (below), then ddt and the chunk's
//         share of da                                        chunk_grad_kernel
//   (iv)  db, dc summed over the heads, da over (B, chunks)  reduce_kernel
// The forward's workspace is read, not recomputed: the states after each
// chunk (h), C B^T per (batch row, chunk) and each chunk's exp(cs_Q).
//
// What bounds it on this card.  At mamba2-130m's training microbatch (B 4
// x L 512, H 24, P 64, N 128) the gradient reads x, dt, b, c, dy and the
// forward's states and writes dx, ddt, db, dc: ~89 MB with the per-head
// partials of db and dc, 27 us at 3.35 TB/s.  Its products are ~6 of the
// forward's size: 2 Q P (Q + 4 N) + 4 Q^2 N a row and head, ~4.5 GFLOP,
// 67 us at the f32 rate of the CUDA cores (67 TFLOP/s).  So it is bound by
// operations.
//
// What this design does about it: little yet; it is the simple kernel
// that is right first, kept for a later PR to make fast.
//  * All products in full f32 on the CUDA cores from shared memory (no
//    TF32, which would miss the tolerance, as the forward's notes say).
//  * One block per (batch row, chunk, head) takes all five gradients of
//    its chunk; B, C and the two P x N states pass through shared memory
//    in slices of NS columns of N, so that P = N = 128 fits.
//  * db and dc are shared by the heads and da by the batch rows and
//    chunks: each block writes its own partial, and reduce_kernel sums
//    them in a fixed order.  No float atomics: two runs give the same
//    bits.
//
// Traps handled here:
//  * exp(cs_i - cs_j) only for j <= i (above the diagonal it overflows and
//    inf * 0 is NaN; see the forward's notes).
//  * d(dt a) is never a reverse cumsum of d cs whose terms cancel: L's row
//    and column sums of T = M o D o dt_j over rows k >= m cancel to the
//    sum of T over the rectangle i >= m > j, which is summed as such (each
//    row's prefix over j < m, then those over i >= m), and the w terms
//    (sum_j w_j u_j at the last row, -w_k u_k at each) to the sum over
//    k < m.  Taken as cumsums of the difference, da lost 5e-5 of its scale
//    at the model's decays (ref.ssd_scan_bwd_ref takes the same forms).
//  * A ragged last chunk is zero-padded in shared memory (x = dy = b = c =
//    dt = 0): padded rows add nothing and are not stored; cs_Q is then the
//    last real row's, as in the forward.
//  * The forward never writes the last chunk's exp(cs_Q) (no state follows
//    it), so the carry never reads it.
//  * x, dy and dt are read through strides; x and dy have unit stride
//    along P.
#include "ssd_scan.cuh"

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// The backward's own workspace, in floats, beside the forward's: the
// carried gradients of the states (nc - 1 a (b, h)), the per-head partials
// of db and dc, da's partials
struct BwdWorkspace {
  long long g, pdb, pdc, pda;
  BwdWorkspace(int B, int H, int L, int P, int N) {
    const long long nc = (L + Q - 1) / Q;
    g = (long long)B * H * (nc - 1) * P * N;
    pdb = pdc = (long long)B * H * L * N;
    pda = (long long)B * H * nc;
  }
};

// rows x W values from src (row stride ld, unit stride along the row) into
// shared rows of LD floats, scaled by scale[r] where given; rows from
// `rows` on are zero
__device__ __forceinline__ void load_rows(float* dst, int LD,
                                          const float* src, long long ld,
                                          int W, int rows,
                                          const float* scale = nullptr) {
  for (int idx = threadIdx.x; idx < Q * W; idx += THREADS) {
    const int r = idx / W, k = idx % W;
    float v = r < rows ? src[r * ld + k] : 0.f;
    if (scale) v *= scale[r];
    dst[r * LD + k] = v;
  }
}

// ---- (i) the gradient each chunk sends to the state before it --------------

// grid (max(nc - 1, 1), H, B): dH of chunk c = blockIdx.x + 1, (P, N),
// into g slot c - 1.  Shared: dy o e [Q][P + 1], C [Q][N + 1], e [Q].
__global__ void __launch_bounds__(THREADS)
dstate_kernel(const float* __restrict__ dy, const float* __restrict__ dt,
              const float* __restrict__ a, const float* __restrict__ c,
              float* __restrict__ g, int H, int L, int P, int N,
              long long syb, long long syh, long long syl, long long sdb,
              long long sdh, long long sdl) {
  extern __shared__ float smem[];
  const int nc = (L + Q - 1) / Q;
  if (nc == 1) return;  // no state before any chunk
  const int chunk = blockIdx.x + 1, h = blockIdx.y, bi = blockIdx.z;
  const int l0 = chunk * Q, rows = min(Q, L - l0);
  const int LDY = P + 1, LDC = N + 1;
  float* sY = smem;
  float* sC = sY + Q * LDY;
  float* sE = sC + Q * LDC;
  if (threadIdx.x < 32) {
    const LaneCumsum r =
        chunk_cumsum(dt + bi * sdb + h * sdh + l0 * sdl, sdl, a[h], rows);
    sE[2 * (threadIdx.x % 32)] = expf(r.cs0);  // <= 1
    sE[2 * (threadIdx.x % 32) + 1] = expf(r.cs1);
  }
  __syncthreads();
  load_rows(sY, LDY, dy + bi * syb + h * syh + l0 * syl, syl, P, rows, sE);
  load_rows(sC, LDC, c + ((size_t)bi * L + l0) * N, N, N, rows);
  __syncthreads();
  float* out = g + (((size_t)bi * H + h) * (nc - 1) + chunk - 1) *
                       (size_t)P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += THREADS) {
    const int p = idx / N, n = idx % N;
    float s = 0.f;
    for (int i = 0; i < Q; ++i) s = fmaf(sY[i * LDY + p], sC[i * LDC + n], s);
    out[idx] = s;
  }
}

// ---- (ii) the reverse carry ------------------------------------------------

// One thread per value of a head's (P, N): G_{c-1} = dH_c + exp(cs_Q,c)
// G_c from the last chunk down, in place over dH (slot c - 1 holds chunk
// c's).  The last chunk's G is its dH alone: its exp(cs_Q) is never read
// (the forward does not write it).
__global__ void __launch_bounds__(THREADS)
carry_kernel(float* __restrict__ g, const float* __restrict__ decay,
             long long items, int nc, long long pn) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= items || nc == 1) return;
  const long long bh = e / pn;
  float* s = g + bh * (nc - 1) * pn + e % pn;
  const float* d = decay + bh * nc;
  float acc = s[(nc - 2) * pn];
  for (int c = nc - 2; c >= 1; --c) {  // slot c - 1 holds chunk c's dH
    acc = fmaf(d[c], acc, s[(c - 1) * pn]);
    s[(c - 1) * pn] = acc;
  }
}

// ---- (iii) every gradient of a chunk, per head -----------------------------

// Shared memory (floats) of chunk_grad_kernel<P, NS>
template <int P, int NS>
struct GradSmem {
  static constexpr int LDP = P + 1, LDQ = Q + 1, LDS = NS + 1;
  static constexpr int X = 0, DY = X + Q * LDP, M = DY + Q * LDP;
  static constexpr int DCB = M + Q * LDQ, MD = DCB + Q * LDQ;
  // per row: cs, dt, e, w, wo = exp(cs_Q - cs), u, r, the sum of T over
  // i >= m > j, sum_i M o D, the sum of w u over k < m
  static constexpr int CS = MD + Q * LDQ, DT = CS + Q, E = DT + Q;
  static constexpr int W = E + Q, WO = W + Q, U = WO + Q, R = U + Q;
  static constexpr int SEG = R + Q, MDS = SEG + Q, WU = MDS + Q;
  // an N slice: B, C, x G, dy h [Q][NS + 1]; h, G [P][NS + 1]
  static constexpr int SB = WU + Q, SC = SB + Q * LDS, XG = SC + Q * LDS;
  static constexpr int DH = XG + Q * LDS, HP = DH + Q * LDS;
  static constexpr int GN = HP + P * LDS, RED = GN + P * LDS;
  static constexpr int END = RED + THREADS;
  static constexpr size_t BYTES = sizeof(float) * END;
};

// grid (nc, H, B)
template <int P, int NS>
__global__ void __launch_bounds__(THREADS)
chunk_grad_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ c, const float* __restrict__ dy,
                  const float* __restrict__ ws_state,
                  const float* __restrict__ ws_cb,
                  const float* __restrict__ g, float* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ pdb,
                  float* __restrict__ pdc, float* __restrict__ pda, int H,
                  int L, int N, long long sxb, long long sxh, long long sxl,
                  long long syb, long long syh, long long syl, long long sdb,
                  long long sdh, long long sdl) {
  using S = GradSmem<P, NS>;
  extern __shared__ float smem[];
  float* sX = smem + S::X;
  float* sDY = smem + S::DY;
  float* sM = smem + S::M;
  float* sDCB = smem + S::DCB;
  float* sMD = smem + S::MD;
  const int chunk = blockIdx.x, nc = gridDim.x, h = blockIdx.y;
  const int bi = blockIdx.z, tid = threadIdx.x;
  const int l0 = chunk * Q, rows = min(Q, L - l0);
  const bool has_h = chunk > 0, has_g = chunk < nc - 1;
  const float ah = a[h];
  __shared__ float s_last;

  load_rows(sX, S::LDP, x + bi * sxb + h * sxh + l0 * sxl, sxl, P, rows);
  load_rows(sDY, S::LDP, dy + bi * syb + h * syh + l0 * syl, syl, P, rows);
  if (tid < 32) {
    const LaneCumsum r =
        chunk_cumsum(dt + bi * sdb + h * sdh + l0 * sdl, sdl, ah, rows);
    const int j = 2 * tid;
    smem[S::CS + j] = r.cs0;
    smem[S::CS + j + 1] = r.cs1;
    smem[S::DT + j] = r.dt0;
    smem[S::DT + j + 1] = r.dt1;
    if (tid == 0) s_last = r.last;
  }
  for (int i = tid; i < Q; i += THREADS) {
    smem[S::U + i] = 0.f;
    smem[S::R + i] = 0.f;
  }
  __syncthreads();
  const float last = s_last;
  const float* cs = smem + S::CS;
  const float* dts = smem + S::DT;
  if (tid < Q) {  // exponents <= 0
    const float wo = expf(last - cs[tid]);
    smem[S::E + tid] = expf(cs[tid]);
    smem[S::WO + tid] = wo;
    smem[S::W + tid] = wo * dts[tid];
  }
  // D = dy x^T; M = CB o L, dCB = D o L o dt_j, M o D (zero above the
  // diagonal)
  const float* cb = ws_cb + (size_t)(bi * nc + chunk) * Q * Q;
  for (int idx = tid; idx < Q * Q; idx += THREADS) {
    const int i = idx / Q, j = idx % Q;
    float m = 0.f, dcb = 0.f, md = 0.f;
    if (j <= i) {
      float d = 0.f;
      for (int p = 0; p < P; ++p)
        d = fmaf(sDY[i * S::LDP + p], sX[j * S::LDP + p], d);
      const float l = expf(cs[i] - cs[j]);
      m = cb[idx] * l;
      dcb = d * l * dts[j];
      md = m * d;
    }
    sM[i * S::LDQ + j] = m;
    sDCB[i * S::LDQ + j] = dcb;
    sMD[i * S::LDQ + j] = md;
  }
  __syncthreads();
  const float* e = smem + S::E;
  const float* w = smem + S::W;
  if (tid >= Q && tid < 2 * Q) {  // sum_i (M o D)[i][j]
    const int j = tid - Q;
    float s = 0.f;
    for (int i = j; i < Q; ++i) s += sMD[i * S::LDQ + j];
    smem[S::MDS + j] = s;
  }

  // dx = dt o (M^T dy) + w o (B G^T): 4 x 4 outputs a tile, kept in
  // registers over the N slices
  constexpr int DX_TILES = (Q / 4) * (P / 4);
  constexpr int PER = (DX_TILES + THREADS - 1) / THREADS;
  float acc[PER][4][4];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int tile = tid + t * THREADS;
    const int j0 = (tile / (P / 4)) * 4, p0 = (tile % (P / 4)) * 4;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) acc[t][jj][pp] = 0.f;
    if (tile >= DX_TILES) continue;
    for (int i = j0; i < Q; ++i) {  // M[i][j] = 0 for i < j
      float mv[4], yv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) mv[jj] = sM[i * S::LDQ + j0 + jj];
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) yv[pp] = sDY[i * S::LDP + p0 + pp];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
          acc[t][jj][pp] = fmaf(mv[jj], yv[pp], acc[t][jj][pp]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) acc[t][jj][pp] *= dts[j0 + jj];
  }

  __syncthreads();  // the column sums of M o D are taken
  if (tid < Q) {  // row i of T = M o D o dt_j, in place: its sum over j' < j
    float run = 0.f;
    for (int j = 0; j < Q; ++j) {
      const float t = sMD[tid * S::LDQ + j] * dts[j];
      sMD[tid * S::LDQ + j] = run;
      run += t;
    }
  }
  __syncthreads();
  if (tid < Q) {  // the sum of T over i >= m > j, m = tid
    float s = 0.f;
    for (int i = tid; i < Q; ++i) s += sMD[i * S::LDQ + tid];
    smem[S::SEG + tid] = s;
  }

  float* sB = smem + S::SB;
  float* sC = smem + S::SC;
  float* sXG = smem + S::XG;
  float* sDH = smem + S::DH;
  float* sHp = smem + S::HP;
  float* sGn = smem + S::GN;
  const size_t pn = (size_t)P * N;
  const float* hprev =
      has_h ? ws_state + (((size_t)bi * H + h) * (nc - 1) + chunk - 1) * pn
            : nullptr;
  const float* gnext =
      has_g ? g + (((size_t)bi * H + h) * (nc - 1) + chunk) * pn : nullptr;
  const size_t prow = ((size_t)bi * H + h) * L + l0;  // row l0 of (b, h)
  float gdot = 0.f;  // this thread's share of <G, h>
  for (int n0 = 0; n0 < N; n0 += NS) {
    __syncthreads();  // the previous slice is read
    load_rows(sB, S::LDS, b + ((size_t)bi * L + l0) * N + n0, N, NS, rows);
    load_rows(sC, S::LDS, c + ((size_t)bi * L + l0) * N + n0, N, NS, rows);
    for (int idx = tid; idx < P * NS; idx += THREADS) {
      const int p = idx / NS, n = idx % NS;
      sHp[p * S::LDS + n] = has_h ? hprev[p * N + n0 + n] : 0.f;
      sGn[p * S::LDS + n] = has_g ? gnext[p * N + n0 + n] : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < Q * NS; idx += THREADS) {
      const int j = idx / NS, n = idx % NS;
      float xg = 0.f, dh = 0.f;
      if (has_g)
        for (int p = 0; p < P; ++p)
          xg = fmaf(sX[j * S::LDP + p], sGn[p * S::LDS + n], xg);
      if (has_h)
        for (int p = 0; p < P; ++p)
          dh = fmaf(sDY[j * S::LDP + p], sHp[p * S::LDS + n], dh);
      sXG[j * S::LDS + n] = xg;
      sDH[j * S::LDS + n] = dh;
    }
    if (has_g && has_h)
      for (int idx = tid; idx < P * NS; idx += THREADS) {
        const int p = idx / NS, n = idx % NS;
        gdot = fmaf(sGn[p * S::LDS + n], sHp[p * S::LDS + n], gdot);
      }
    __syncthreads();
    if (tid < Q) {  // u_j += B_j . (x G)_j
      float s = smem[S::U + tid];
      for (int n = 0; n < NS; ++n)
        s = fmaf(sXG[tid * S::LDS + n], sB[tid * S::LDS + n], s);
      smem[S::U + tid] = s;
    } else if (tid < 2 * Q) {  // r_i += C_i . (dy h)_i
      const int i = tid - Q;
      float s = smem[S::R + i];
      for (int n = 0; n < NS; ++n)
        s = fmaf(sDH[i * S::LDS + n], sC[i * S::LDS + n], s);
      smem[S::R + i] = s;
    }
    // this head's dC = dCB B + e o (dy h) and dB = dCB^T C + w o (x G)
    for (int idx = tid; idx < Q * NS; idx += THREADS) {
      const int i = idx / NS, n = idx % NS;
      if (i >= rows) continue;
      float dcv = 0.f, dbv = 0.f;
      for (int j = 0; j <= i; ++j)
        dcv = fmaf(sDCB[i * S::LDQ + j], sB[j * S::LDS + n], dcv);
      for (int k = i; k < Q; ++k)
        dbv = fmaf(sDCB[k * S::LDQ + i], sC[k * S::LDS + n], dbv);
      dcv = fmaf(e[i], sDH[i * S::LDS + n], dcv);
      dbv = fmaf(w[i], sXG[i * S::LDS + n], dbv);
      pdc[(prow + i) * N + n0 + n] = dcv;
      pdb[(prow + i) * N + n0 + n] = dbv;
    }
    if (has_g) {  // dx += w o (B G^T) over this slice
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int tile = tid + t * THREADS;
        if (tile >= DX_TILES) continue;
        const int j0 = (tile / (P / 4)) * 4, p0 = (tile % (P / 4)) * 4;
        float part[4][4] = {};
        for (int n = 0; n < NS; ++n) {
          float bv[4], gv[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) bv[jj] = sB[(j0 + jj) * S::LDS + n];
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) gv[pp] = sGn[(p0 + pp) * S::LDS + n];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int pp = 0; pp < 4; ++pp)
              part[jj][pp] = fmaf(bv[jj], gv[pp], part[jj][pp]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
            acc[t][jj][pp] = fmaf(w[j0 + jj], part[jj][pp], acc[t][jj][pp]);
      }
    }
  }

  // dx, contiguous (B,H,L,P)
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int tile = tid + t * THREADS;
    if (tile >= DX_TILES) continue;
    const int j0 = (tile / (P / 4)) * 4, p0 = (tile % (P / 4)) * 4;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (j0 + jj < rows)
        *reinterpret_cast<float4*>(dx + (prow + j0 + jj) * P + p0) =
            make_float4(acc[t][jj][0], acc[t][jj][1], acc[t][jj][2],
                        acc[t][jj][3]);
  }

  // <G, h>: a tree over the threads, the same order every run
  float* red = smem + S::RED;
  red[tid] = gdot;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) {  // d(dt a), ddt and da's share
    const float* u = smem + S::U;
    const float* r = smem + S::R;
    const float* wo = smem + S::WO;
    float* wu = smem + S::WU;
    float run = 0.f;
    for (int k = 0; k < Q; ++k) {  // sum of w u over k' < k
      wu[k] = run;
      run = fmaf(w[k], u[k], run);
    }
    const float carry = expf(last) * red[0];
    float er = 0.f, da = 0.f;
    for (int k = Q - 1; k >= 0; --k) {
      er = fmaf(e[k], r[k], er);  // sum of e r over k' >= k
      const float dda = smem[S::SEG + k] + er + wu[k] + carry;
      da = fmaf(dts[k], dda, da);
      if (k < rows)
        ddt[prow + k] = smem[S::MDS + k] + wo[k] * u[k] + ah * dda;
    }
    pda[((size_t)bi * H + h) * nc + chunk] = da;
  }
}

// ---- (iv) the sums over heads and chunks -----------------------------------

// Threads over (b, l, n): db, dc = the heads' partials summed in order
// h = 0 .. H-1; the last block: da[h] = sum over (b, chunk) in order.
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ pdb, const float* __restrict__ pdc,
              const float* __restrict__ pda, float* __restrict__ db,
              float* __restrict__ dc, float* __restrict__ da, int B, int H,
              int L, int N, int nc) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += THREADS) {
      float s = 0.f;
      for (int bi = 0; bi < B; ++bi)
        for (int ch = 0; ch < nc; ++ch) s += pda[((size_t)bi * H + h) * nc + ch];
      da[h] = s;
    }
    return;
  }
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long ln = (long long)L * N;
  if (e >= B * ln) return;
  const long long bi = e / ln, rest = e % ln;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    const long long at = (bi * H + h) * ln + rest;
    sb += pdb[at];
    sc += pdc[at];
  }
  db[e] = sb;
  dc[e] = sc;
}

// ---- host ------------------------------------------------------------------

// the number of launches in the low four bits, a refused launch's error
// above them (the launches before it below)
int done(int launched) {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? launched : ((int)err << 4) | (launched - 1);
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return bytes <= 48 * 1024
             ? cudaSuccess
             : cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   (int)bytes);
}

template <int P, int NS>
int launch_grad(const float* x, const float* dt, const float* a,
                const float* b, const float* c, const float* dy,
                const float* ws_state, const float* ws_cb, const float* g,
                float* dx, float* ddt, float* pdb, float* pdc, float* pda,
                int B, int H, int L, int N, long long sxb, long long sxh,
                long long sxl, long long syb, long long syh, long long syl,
                long long sdb, long long sdh, long long sdl, cudaStream_t st,
                int launched) {
  auto k = chunk_grad_kernel<P, NS>;
  constexpr size_t bytes = GradSmem<P, NS>::BYTES;
  const cudaError_t err = allow_smem((const void*)k, bytes);
  if (err != cudaSuccess) return ((int)err << 4) | launched;
  const int nc = (L + Q - 1) / Q;
  k<<<dim3(nc, H, B), THREADS, bytes, st>>>(
      x, dt, a, b, c, dy, ws_state, ws_cb, g, dx, ddt, pdb, pdc, pda, H, L, N,
      sxb, sxh, sxl, syb, syh, syl, sdb, sdh, sdl);
  return done(launched + 1);
}

}  // namespace

// f32 values of workspace ssd_scan_bwd needs beside the forward's
extern "C" long long ssd_scan_bwd_workspace(int B, int H, int L, int P,
                                            int N) {
  const BwdWorkspace w(B, H, L, P, N);
  return w.g + w.pdb + w.pdc + w.pda;
}

// All f32.  x, dy (B,H,L,P) and dt (B,H,L) through strides in elements
// (unit stride along P); a (H,), b, c (B,L,N) contiguous; fwd_workspace
// the forward's (ssd_scan_fwd) after its run on the same inputs; work
// ssd_scan_bwd_workspace floats.  Writes dx (B,H,L,P) and ddt (B,H,L)
// contiguous, da (H,), db, dc (B,L,N).  Four launches on ``stream``, no
// synchronisation.  Returns the number of kernels launched in the low four
// bits and, above them, the cudaError_t of a refused launch or
// cudaErrorInvalidValue for shapes it does not take (0 on success: 4).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* dy,
                            const void* fwd_workspace, void* work, void* dx,
                            void* ddt, void* da, void* db, void* dc, int B,
                            int H, int L, int P, int N, long long sxb,
                            long long sxh, long long sxl, long long syb,
                            long long syh, long long syl, long long sdb,
                            long long sdh, long long sdl, void* stream) {
  if (B < 1 || H < 1 || L < 1 || B > 65535 || H > 65535 ||
      (P != 32 && P != 64 && P != 128) ||
      (N != 16 && N != 32 && N != 64 && N != 128))
    return (int)cudaErrorInvalidValue << 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace fw(B, H, L, P, N);
  const BwdWorkspace w(B, H, L, P, N);
  const float* ws_state = static_cast<const float*>(fwd_workspace);
  const float* ws_cb = ws_state + fw.state;
  const float* ws_decay = ws_cb + fw.cb;
  float* g = static_cast<float*>(work);
  float* pdb = g + w.g;
  float* pdc = pdb + w.pdb;
  float* pda = pdc + w.pdc;
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* dyf = static_cast<const float*>(dy);
  const int nc = (L + Q - 1) / Q;

  // (i)
  const size_t smem1 = sizeof(float) * (Q * (P + 1) + Q * (N + 1) + Q);
  cudaError_t err = allow_smem((const void*)dstate_kernel, smem1);
  if (err != cudaSuccess) return (int)err << 4;
  dstate_kernel<<<dim3(nc > 1 ? nc - 1 : 1, H, B), THREADS, smem1, st>>>(
      dyf, dtf, af, cf, g, H, L, P, N, syb, syh, syl, sdb, sdh, sdl);
  int rc = done(1);
  if (rc != 1) return rc;

  // (ii)
  const long long pn = (long long)P * N;
  const long long items = (long long)B * H * pn;
  carry_kernel<<<(unsigned)((items + THREADS - 1) / THREADS), THREADS, 0,
                 st>>>(g, ws_decay, items, nc, pn);
  rc = done(2);
  if (rc != 2) return rc;

  // (iii)
  float* dxf = static_cast<float*>(dx);
  float* ddtf = static_cast<float*>(ddt);
#define SSD_GRAD(PP, NN)                                                    \
  launch_grad<PP, NN>(xf, dtf, af, bf, cf, dyf, ws_state, ws_cb, g, dxf,    \
                      ddtf, pdb, pdc, pda, B, H, L, N, sxb, sxh, sxl, syb,  \
                      syh, syl, sdb, sdh, sdl, st, 2)
  if (N == 16)
    rc = P == 32 ? SSD_GRAD(32, 16) : P == 64 ? SSD_GRAD(64, 16)
                                              : SSD_GRAD(128, 16);
  else
    rc = P == 32 ? SSD_GRAD(32, 32) : P == 64 ? SSD_GRAD(64, 32)
                                              : SSD_GRAD(128, 32);
#undef SSD_GRAD
  if (rc != 3) return rc;

  // (iv)
  const long long cells = (long long)B * L * N;
  reduce_kernel<<<(unsigned)((cells + THREADS - 1) / THREADS) + 1, THREADS, 0,
                  st>>>(pdb, pdc, pda, static_cast<float*>(db),
                        static_cast<float*>(dc), static_cast<float*>(da), B,
                        H, L, N, nc);
  return done(4);
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
