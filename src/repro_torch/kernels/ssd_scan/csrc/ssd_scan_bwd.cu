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
//         dCB = D o L o dt_j; dx = (M o dt_j)^T dy + (w o B) G^T;
//         dC = dCB B + e o (dy h), dB = dCB^T C + w o (x G), summed over
//         the heads; d(dt a) at row m, the sum of d cs over rows k >= m,
//         term by term in forms that do not cancel (below), then ddt and
//         the chunk's share of da                            chunk_grad_kernel
//   (iv)  db, dc summed over the groups of heads, da over (B, chunks)
//                                                                reduce_kernel
// The forward's workspace is read, not recomputed: the states after each
// chunk (h), C B^T per (batch row, chunk) and each chunk's exp(cs_Q).
//
// What bounds it on this card.  At mamba2-130m's training microbatch (B 4
// x L 512, H 24, P 64, N 128) the gradient reads x, dt, b, c, dy and the
// forward's states and writes dx, ddt, db, dc: ~89 MB with the partials of
// db and dc, 27 us at 3.35 TB/s.  Its products are ~6 of the forward's
// size: 2 Q P (Q + 4 N) + 4 Q^2 N a row and head, ~4.5 GFLOP, 67 us at the
// f32 rate of the CUDA cores (67 TFLOP/s); on the tensor cores in 3xTF32,
// with the triangles skipped, ~3.6 GFLOP three times over, 22 us at the
// dense TF32 rate (495 TFLOP/s).  So it is bound by operations.
//
// What the design does about it:
//  * Every product on the tensor cores, mma.sync m16n8k8 in 3xTF32, as the
//    forward (ssd_scan.cuh: each f32 operand split once into hi + lo, the
//    split shared by the positions that use it, the three products issued
//    term by term into the f32 sum).  One TF32 product misses the 5e-5
//    tolerance by 10x and more; the split form is as accurate as f32
//    products (tests/test_torch_ssd_bwd.py rehearses both on the CPU), so
//    no product stays on the CUDA cores.
//  * chunk_grad: a block takes a group of heads of one (b, chunk), sized so
//    that the blocks fill the SMs about once (6 heads, 128 blocks at the
//    path shape); B and C (all of N) are staged once for the group, each
//    head's x and dy and slices of its h and G arrive by cp.async while the
//    previous product runs, and dB and dC are summed over the group's heads
//    in registers, so the partials that reduce_kernel sums are per group.
//    Per head: D on and below the diagonal (warps wholly above it skip),
//    from which M o dt_j, dCB and T = M o D o dt_j go to shared memory once;
//    the triangular products skip the k-steps wholly above the diagonal
//    and pair the row tiles (0, 3) and (1, 2) so that the warps share the
//    triangle evenly, as the forward's chunk_out.
//  * dstate: the forward's chunk_state layout, (dy o e)^T C per (b, chunk,
//    group of heads, slice of P), C staged once for the group.
//  * db and dc are shared by the heads and da by the batch rows and
//    chunks: each block writes its own partial, and reduce_kernel sums
//    them in a fixed order.  Every other sum is taken in a fixed order by a
//    fixed thread: two runs give the same bits.  No float atomics.
//
// Traps handled here:
//  * exp(cs_i - cs_j) only for j <= i (above the diagonal it overflows and
//    inf * 0 is NaN; see the forward's notes).
//  * d(dt a) is never a reverse cumsum of d cs whose terms cancel: L's row
//    and column sums of T over rows k >= m cancel to the sum of T over the
//    rectangle i >= m > j, which is summed as such (each row's prefix over
//    j < m, then those over i >= m), and the w terms (sum_j w_j u_j at the
//    last row, -w_k u_k at each) to the sum over k < m.  Taken as cumsums
//    of the difference, da lost 5e-5 of its scale at the model's decays
//    (ref.ssd_scan_bwd_ref takes the same forms).
//  * A ragged last chunk is zero-padded in shared memory (x = dy = b = c =
//    dt = 0): padded rows add nothing and are not stored; cs_Q is then the
//    last real row's, as in the forward.
//  * The forward never writes the last chunk's exp(cs_Q) (no state follows
//    it), so the carry never reads it.
//  * x, dy and dt are read through strides; x and dy have unit stride
//    along P.
#include "ssd_scan.cuh"

namespace {

// The backward's own workspace, in floats, beside the forward's: the
// carried gradients of the states (nc - 1 a (b, h)), the partials of db
// and dc (at most one a head), da's partials
struct BwdWorkspace {
  long long g, pdb, pdc, pda;
  BwdWorkspace(int B, int H, int L, int P, int N) {
    const long long nc = (L + Q - 1) / Q;
    g = (long long)B * H * (nc - 1) * P * N;
    pdb = pdc = (long long)B * H * L * N;
    pda = (long long)B * H * nc;
  }
};

// ---- (i) the gradient each chunk sends to the state before it --------------

// Shared memory (floats): C [Q][N + 8] (B operand, 4 rows x 8 columns a
// fragment), the dy slice [Q][PT + 8] (A^T), e of each head [8][Q]
template <int N, int PT>
struct DstateSmem {
  static constexpr int LDY = PT + 8, LDC = N + 8;
  static constexpr int C = 0, Y = C + Q * LDC, E = Y + Q * LDY;
  static constexpr int END = E + MAX_GROUP * Q;
  static constexpr size_t BYTES = sizeof(float) * END;
};

constexpr int DSTATE_BLOCKS = 2;  // blocks of stage (i) an SM

// grid (max(nc - 1, 1), groups * P/PT, B): PT rows of dH of chunk c =
// blockIdx.x + 1, (P, N), into g slot c - 1, for a group of heads; C
// staged once for the group
template <int N, int PT>
__global__ void __launch_bounds__(THREADS, DSTATE_BLOCKS)
dstate_kernel(const float* __restrict__ dy, const float* __restrict__ dt,
              const float* __restrict__ a, const float* __restrict__ c,
              float* __restrict__ g, int H, int L, int P, int group,
              long long syb, long long syh, long long syl, long long sdb,
              long long sdh, long long sdl, bool yvec, bool cvec) {
  using S = DstateSmem<N, PT>;
  extern __shared__ __align__(16) float smem[];
  const int nc = (L + Q - 1) / Q;
  if (nc == 1) return;  // no state before any chunk
  const int chunk = blockIdx.x + 1, bi = blockIdx.z;
  const int slices = P / PT;
  const int h0 = (blockIdx.y / slices) * group;
  const int p0 = (blockIdx.y % slices) * PT;
  const int heads = min(group, H - h0);
  const int l0 = chunk * Q, rows = min(Q, L - l0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t = lane % 4;
  float* sC = smem + S::C;
  float* sE = smem + S::E;
  const float* yb = dy + bi * syb + l0 * syl + p0;
  load_tile<Q, N, S::LDC>(sC, c + ((size_t)bi * L + l0) * N, N, rows, cvec);
  load_tile<Q, PT, S::LDY>(smem + S::Y, yb + h0 * syh, syl, rows, yvec);
  cp_async_commit();
  if (warp < heads) {  // warp k: head h0 + k's e = exp(cs) <= 1
    const int h = h0 + warp;
    const LaneCumsum r =
        chunk_cumsum(dt + bi * sdb + h * sdh + l0 * sdl, sdl, a[h], rows);
    sE[warp * Q + 2 * lane] = expf(r.cs0);
    sE[warp * Q + 2 * lane + 1] = expf(r.cs1);
  }

  // dH (PT x N) = (dy o e)^T C: A[p][j] = dy[j][p] e[j], B[j][n] = C[j][n]
  using WG = WarpGrid<PT, N>;
  const int wm = warp / WG::WN, wn = warp % WG::WN;
  const int m0 = wm * WG::MT * 16, n0 = wn * WG::NT * 8;
  for (int k = 0; k < heads; ++k) {
    if (k > 0)  // this head's dy (head 0's came with C)
      load_tile<Q, PT, S::LDY>(smem + S::Y, yb + (h0 + k) * syh, syl, rows,
                               yvec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float* sY = smem + S::Y;
    const float* e = sE + k * Q;
    if (wm < WG::WM) {  // idle warps of small shapes
      float acc[WG::MT][WG::NT][4];
      zero(acc);
      mma_3xtf32<WG::MT, WG::NT, true>(
          acc, 0, Q,
          [&](int i, int k0, float* v) {
            const float* r0 = sY + (k0 + t) * S::LDY + m0 + 16 * i + g8;
            const float e0 = e[k0 + t], e1 = e[k0 + t + 4];
            v[0] = r0[0] * e0;
            v[1] = r0[8] * e0;
            v[2] = r0[4 * S::LDY] * e1;
            v[3] = r0[4 * S::LDY + 8] * e1;
          },
          [&](int j, int k0, float* v) {
            const float* r0 = sC + (k0 + t) * S::LDC + n0 + 8 * j + g8;
            v[0] = r0[0];
            v[1] = r0[4 * S::LDC];
          });
      float* out = g + (((size_t)bi * H + h0 + k) * (nc - 1) + chunk - 1) *
                           (size_t)P * N +
                   (size_t)p0 * N;
#pragma unroll
      for (int i = 0; i < WG::MT; ++i)
#pragma unroll
        for (int j = 0; j < WG::NT; ++j) {
          const int row = m0 + 16 * i + g8, col = n0 + 8 * j + 2 * t;
          store2(out + row * N + col, acc[i][j][0], acc[i][j][1]);
          store2(out + (row + 8) * N + col, acc[i][j][2], acc[i][j][3]);
        }
    }
    __syncthreads();  // every warp is done with this dy slice
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

// ---- (iii) every gradient of a chunk, for a group of heads ------------------

// Shared memory (floats) of chunk_grad_kernel<P, N>.  Row strides keep a
// warp's fragment loads on distinct banks (A operands read 8 rows x 4
// columns: a stride of 4 mod 32; B operands 4 rows x 8 columns: 8 mod 32;
// 12 mod 32 where a tile is read both ways, 2-way at worst).  h and G pass
// in slices of NS columns of N; B and C are staged whole.
template <int P, int N>
struct GradSmem {
  static constexpr int NS = P <= 64 ? (N < 64 ? N : 64)
                                    : (N == 128 ? 16 : (N < 32 ? N : 32));
  static constexpr int SL = N / NS;
  static constexpr int LDX = P + 4, LDY = P + 12;
  static constexpr int LDM = Q + 8, LDD = Q + 12, LDT = Q + 1;
  static constexpr int LDB = N + 12, LDC = N + 8;
  static constexpr int LDH = NS + 8, LDG = NS + 12;
  static constexpr int X = 0, DY = X + Q * LDX, MDT = DY + Q * LDY;
  static constexpr int DCB = MDT + Q * LDM, T = DCB + Q * LDD;
  static constexpr int SB = T + Q * LDT, SC = SB + Q * LDB;
  static constexpr int HS = SC + Q * LDC, GS = HS + P * LDH;
  // every head's cs and dt [8][Q]; the current head's rows: e, w, wo =
  // exp(cs_Q - cs), sum_i M o D, the rectangle sums of T, u, r, the sum
  // of w u over k < m; partial row sums [4][Q] of u and r; <G, h>
  static constexpr int CS = GS + P * LDG, DT = CS + MAX_GROUP * Q;
  static constexpr int E = DT + MAX_GROUP * Q, W = E + Q, WO = W + Q;
  static constexpr int MDS = WO + Q, SEG = MDS + Q, U = SEG + Q, R = U + Q;
  static constexpr int WU = R + Q, RU = WU + Q, RR = RU + 4 * Q;
  static constexpr int GH = RR + 4 * Q;
  static constexpr int END = GH + THREADS;
  static constexpr size_t BYTES = sizeof(float) * END;
  static_assert(BYTES <= 232448, "chunk_grad shared memory");
  static_assert(X % 4 == 0 && DY % 4 == 0 && SB % 4 == 0 && SC % 4 == 0 &&
                    HS % 4 == 0 && GS % 4 == 0,
                "16-byte cp.async destinations");
};

// A warp's fragments of 16 x 8 positions, A = row-major [rows][ld] tile
__device__ __forceinline__ void frag_rows(const float* m, int ld, int row,
                                          int k0, int t, float* v) {
  const float* r0 = m + row * ld + k0 + t;
  v[0] = r0[0];
  v[1] = r0[8 * ld];
  v[2] = r0[4];
  v[3] = r0[8 * ld + 4];
}

// the same of A = m^T, m row-major [k][rows]
__device__ __forceinline__ void frag_cols(const float* m, int ld, int row,
                                          int k0, int t, float* v) {
  const float* r0 = m + (k0 + t) * ld + row;
  v[0] = r0[0];
  v[1] = r0[8];
  v[2] = r0[4 * ld];
  v[3] = r0[4 * ld + 8];
}

// B[k][n] from a row-major [k][n] tile; from a [n][k] tile
__device__ __forceinline__ void frag_kn(const float* m, int ld, int col,
                                        int k0, int t, float* v) {
  v[0] = m[(k0 + t) * ld + col];
  v[1] = m[(k0 + t + 4) * ld + col];
}
__device__ __forceinline__ void frag_nk(const float* m, int ld, int col,
                                        int k0, int t, float* v) {
  v[0] = m[col * ld + k0 + t];
  v[1] = m[col * ld + k0 + t + 4];
}

// acc over k in [k_begin, k_end) of row tile i = 1 alone
template <int NT>
__device__ __forceinline__ float (&second(float (&acc)[2][NT][4]))[1][NT][4] {
  return *reinterpret_cast<float(*)[1][NT][4]>(&acc[1]);
}

// grid (nc, groups, B): every gradient of chunk blockIdx.x for the heads
// of group blockIdx.y; dB and dC summed over the group into pdb, pdc
// (B, groups, L, N), da's share of each head into pda
template <int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
chunk_grad_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ c, const float* __restrict__ dy,
                  const float* __restrict__ ws_state,
                  const float* __restrict__ ws_cb,
                  const float* __restrict__ g, float* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ pdb,
                  float* __restrict__ pdc, float* __restrict__ pda, int H,
                  int L, int group, long long sxb, long long sxh,
                  long long sxl, long long syb, long long syh, long long syl,
                  long long sdb, long long sdh, long long sdl, bool xvec,
                  bool yvec, bool bcvec) {
  using S = GradSmem<P, N>;
  constexpr int NS = S::NS, SL = S::SL;
  extern __shared__ __align__(16) float smem[];
  float* sX = smem + S::X;
  float* sDY = smem + S::DY;
  float* sMdt = smem + S::MDT;
  float* sDCB = smem + S::DCB;
  float* sT = smem + S::T;
  const float* sB = smem + S::SB;
  const float* sC = smem + S::SC;
  float* sH = smem + S::HS;
  float* sG = smem + S::GS;
  const int chunk = blockIdx.x, nc = gridDim.x, grp = blockIdx.y;
  const int bi = blockIdx.z, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int h0 = grp * group, heads = min(group, H - h0);
  const int l0 = chunk * Q, rows = min(Q, L - l0);
  const bool has_h = chunk > 0, has_g = chunk < nc - 1;

  // B and C of (b, chunk), shared by the group's heads
  load_tile<Q, N, S::LDB>(smem + S::SB, b + ((size_t)bi * L + l0) * N, N,
                          rows, bcvec);
  load_tile<Q, N, S::LDC>(smem + S::SC, c + ((size_t)bi * L + l0) * N, N,
                          rows, bcvec);
  cp_async_commit();
  if (warp < heads) {  // warp k: head h0 + k's cs and dt
    const int h = h0 + warp;
    const LaneCumsum r =
        chunk_cumsum(dt + bi * sdb + h * sdh + l0 * sdl, sdl, a[h], rows);
    const int j = warp * Q + 2 * lane;
    smem[S::CS + j] = r.cs0;
    smem[S::CS + j + 1] = r.cs1;
    smem[S::DT + j] = r.dt0;
    smem[S::DT + j + 1] = r.dt1;
  }

  // Q x NS outputs (dC, dB and the products they sum): WN warps along the
  // columns, WM along the rows; WM = 2: row tiles (0, 3) or (1, 2) a warp,
  // so that both row warps do the same share of a triangle
  constexpr int WN = NS / 8 < 4 ? NS / 8 : 4, WM = WARPS / WN;
  constexpr int MT = 4 / WM, NTS = NS / 8 / WN;
  const int wm = warp / WN, wn = warp % WN;
  const int ta = wm, tb = 3 - wm;  // MT == 1: tile ta alone
  const int ns0 = wn * NTS * 8;
  auto tile_row = [&](int i) { return 16 * (i == 0 ? ta : tb) + gq; };
  // Q x P outputs (dx): 2 x 4 warps, row tiles paired the same way
  constexpr int NTX = P / 32;
  const int xa = warp / 4, xb = 3 - xa, px0 = (warp % 4) * (P / 4);
  auto x_row = [&](int i) { return 16 * (i == 0 ? xa : xb) + gq; };

  float acc_dc[SL][MT][NTS][4], acc_db[SL][MT][NTS][4];
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    zero(acc_dc[s]);
    zero(acc_db[s]);
  }
  const float* cbp = ws_cb + (size_t)(bi * nc + chunk) * Q * Q;
  const size_t pn = (size_t)P * N;

  for (int k = 0; k < heads; ++k) {
    const int h = h0 + k;
    load_tile<Q, P, S::LDX>(sX, x + bi * sxb + h * sxh + l0 * sxl, sxl,
                            rows, xvec);
    load_tile<Q, P, S::LDY>(sDY, dy + bi * syb + h * syh + l0 * syl, syl,
                            rows, yvec);
    cp_async_commit();
    // the state before the chunk and the gradient of the state after it
    const size_t slot = ((size_t)bi * H + h) * (nc - 1) + chunk;
    const float* hk = has_h ? ws_state + (slot - 1) * pn : nullptr;
    const float* gk = has_g ? g + slot * pn : nullptr;
    auto load_slice = [&](int s) {  // h and G, columns s NS .. s NS + NS
      if (has_h) load_tile<P, NS, S::LDH>(sH, hk + s * NS, N, P, true);
      if (has_g) load_tile<P, NS, S::LDG>(sG, gk + s * NS, N, P, true);
      cp_async_commit();
    };
    load_slice(0);
    cp_async_wait<1>();  // x, dy (and B, C)
    __syncthreads();     // (and every head's cs, dt)
    const float* cs = smem + S::CS + k * Q;
    const float* dts = smem + S::DT + k * Q;
    const float last = cs[Q - 1];
    float* e = smem + S::E;
    float* w = smem + S::W;
    float* wo = smem + S::WO;
    if (tid < Q) {  // exponents <= 0
      const float o = expf(last - cs[tid]);
      e[tid] = expf(cs[tid]);
      wo[tid] = o;
      w[tid] = o * dts[tid];
    }

    // (A) D = dy x^T on and below the diagonal: warps of 32 rows x 16
    // columns, those wholly above it idle; then M o dt_j, dCB and T =
    // M o D o dt_j into shared memory, zero above the diagonal, and the
    // column sums of M o D
    {
      const int m0 = (warp / 4) * 32, n0 = (warp % 4) * 16;
      const bool above = m0 + 31 < n0;
      float acc[2][2][4];
      zero(acc);
      if (!above)
        mma_3xtf32(
            acc, 0, P,
            [&](int i, int k0, float* v) {
              frag_rows(sDY, S::LDY, m0 + 16 * i + gq, k0, tq, v);
            },
            [&](int j, int k0, float* v) {
              frag_nk(sX, S::LDX, n0 + 8 * j + gq, k0, tq, v);
            });
      float colsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + 16 * i + gq + 8 * half;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = n0 + 8 * j + 2 * tq;
            float2 cbv = make_float2(0.f, 0.f);
            if (col <= row)
              cbv = *reinterpret_cast<const float2*>(cbp + row * Q + col);
            float mdt[2], dcb[2], tt[2];
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              mdt[cc] = dcb[cc] = tt[cc] = 0.f;
              if (col + cc <= row) {
                const float l = expf(cs[row] - cs[col + cc]);
                const float dj = dts[col + cc];
                const float m = (cc == 0 ? cbv.x : cbv.y) * l;
                const float d = acc[i][j][2 * half + cc];
                const float md = m * d;
                mdt[cc] = m * dj;
                dcb[cc] = d * l * dj;
                tt[cc] = md * dj;
                colsum[j][cc] += md;
              }
            }
            *reinterpret_cast<float2*>(sMdt + row * S::LDM + col) =
                make_float2(mdt[0], mdt[1]);
            *reinterpret_cast<float2*>(sDCB + row * S::LDD + col) =
                make_float2(dcb[0], dcb[1]);
            sT[row * S::LDT + col] = tt[0];
            sT[row * S::LDT + col + 1] = tt[1];
          }
        }
      // over the warp's 32 rows (lanes of one tq), then the two row warps
      float* red = smem + S::RU;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          float v = colsum[j][cc];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gq == 0) red[(warp / 4) * Q + n0 + 8 * j + 2 * tq + cc] = v;
        }
    }
    __syncthreads();
    if (tid < Q) smem[S::MDS + tid] = smem[S::RU + tid] + smem[S::RU + Q + tid];
    {  // each row of T: its sum over j' < j, in place; 4 threads a row
      const int i = tid / 4, q = tid % 4;
      float* tr = sT + i * S::LDT + 16 * q;
      float v[16];
      float run = 0.f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) v[jj] = tr[jj];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const float t = v[jj];
        v[jj] = run;
        run += t;
      }
      float incl = run;
      float up = __shfl_up_sync(0xffffffffu, incl, 1, 4);
      if (q >= 1) incl += up;
      up = __shfl_up_sync(0xffffffffu, incl, 2, 4);
      if (q >= 2) incl += up;
      float off = __shfl_up_sync(0xffffffffu, incl, 1, 4);
      if (q == 0) off = 0.f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) tr[jj] = v[jj] + off;
    }

    // dx = (M o dt_j)^T dy + (w o B) G^T, kept in registers over the slices;
    // (M o dt_j)^T dy: row tile r of dx sums k = i from 16 r on
    float accx[2][NTX][4];
    zero(accx);
    __syncthreads();  // the row sums of T and M o dt_j are in place
    {  // the sum of T over the rectangle i >= m > j; 4 threads a column m
      const int m = tid / 4, q = tid % 4;
      float s = 0.f;
      for (int i = m + q; i < Q; i += 4) s += sT[i * S::LDT + m];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0) smem[S::SEG + m] = s;
    }
    {
      auto fa = [&](int i, int k0, float* v) {
        frag_cols(sMdt, S::LDM, x_row(i), k0, tq, v);
      };
      auto fb = [&](int j, int k0, float* v) {
        frag_kn(sDY, S::LDY, px0 + 8 * j + gq, k0, tq, v);
      };
      mma_3xtf32(
          *reinterpret_cast<float(*)[1][NTX][4]>(&accx[0]), 16 * xa,
          16 * xb, fa, fb);
      mma_3xtf32(accx, 16 * xb, Q, fa, fb);
    }

    float rpart[MT][2] = {}, upart[MT][2] = {}, gh = 0.f;
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      const int c0 = s * NS;  // this slice's first column of N
      // dC += dCB B (k = j <= i), dB += dCB^T C (k = i >= j): B and C are
      // staged whole, so these run while the slice's h and G arrive
      {
        auto fa = [&](int i, int k0, float* v) {
          frag_rows(sDCB, S::LDD, tile_row(i), k0, tq, v);
        };
        auto fb = [&](int j, int k0, float* v) {
          frag_kn(sB, S::LDB, c0 + ns0 + 8 * j + gq, k0, tq, v);
        };
        if constexpr (MT == 2) {
          mma_3xtf32(acc_dc[s], 0, 16 * ta + 16, fa, fb);
          mma_3xtf32(second(acc_dc[s]), 16 * ta + 16, 16 * tb + 16,
                     [&](int, int k0, float* v) { fa(1, k0, v); }, fb);
        } else {
          mma_3xtf32(acc_dc[s], 0, 16 * ta + 16, fa, fb);
        }
      }
      {
        auto fa = [&](int i, int k0, float* v) {
          frag_cols(sDCB, S::LDD, tile_row(i), k0, tq, v);
        };
        auto fb = [&](int j, int k0, float* v) {
          frag_kn(sC, S::LDC, c0 + ns0 + 8 * j + gq, k0, tq, v);
        };
        if constexpr (MT == 2) {
          mma_3xtf32(*reinterpret_cast<float(*)[1][NTS][4]>(&acc_db[s][0]),
                     16 * ta, 16 * tb, fa, fb);
          mma_3xtf32(acc_db[s], 16 * tb, Q, fa, fb);
        } else {
          mma_3xtf32(acc_db[s], 16 * ta, Q, fa, fb);
        }
      }
      cp_async_wait<0>();  // this slice's h and G
      __syncthreads();
      if (has_g) {  // dx += (w o B) G^T over the slice's columns
        mma_3xtf32(
            accx, 0, NS,
            [&](int i, int k0, float* v) {
              const int r = x_row(i);
              const float* r0 = sB + r * S::LDB + c0 + k0 + tq;
              const float w0 = w[r], w8 = w[r + 8];
              v[0] = r0[0] * w0;
              v[1] = r0[8 * S::LDB] * w8;
              v[2] = r0[4] * w0;
              v[3] = r0[8 * S::LDB + 4] * w8;
            },
            [&](int j, int k0, float* v) {
              frag_nk(sG, S::LDG, px0 + 8 * j + gq, k0, tq, v);
            });
      }
      float tmp[MT][NTS][4];
      if (has_h) {  // dy h: r_i += C_i . (dy h)_i, dC += e o (dy h)
        zero(tmp);
        mma_3xtf32(
            tmp, 0, P,
            [&](int i, int k0, float* v) {
              frag_rows(sDY, S::LDY, tile_row(i), k0, tq, v);
            },
            [&](int j, int k0, float* v) {
              frag_kn(sH, S::LDH, ns0 + 8 * j + gq, k0, tq, v);
            });
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = tile_row(i) + 8 * half;
            const float er = e[row];
#pragma unroll
            for (int j = 0; j < NTS; ++j)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                const float v = tmp[i][j][2 * half + cc];
                const int col = c0 + ns0 + 8 * j + 2 * tq + cc;
                rpart[i][half] = fmaf(sC[row * S::LDC + col], v,
                                      rpart[i][half]);
                acc_dc[s][i][j][2 * half + cc] =
                    fmaf(er, v, acc_dc[s][i][j][2 * half + cc]);
              }
          }
      }
      if (has_g) {  // x G: u_j += B_j . (x G)_j, dB += w o (x G)
        zero(tmp);
        mma_3xtf32(
            tmp, 0, P,
            [&](int i, int k0, float* v) {
              frag_rows(sX, S::LDX, tile_row(i), k0, tq, v);
            },
            [&](int j, int k0, float* v) {
              frag_kn(sG, S::LDG, ns0 + 8 * j + gq, k0, tq, v);
            });
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = tile_row(i) + 8 * half;
            const float wr = w[row];
#pragma unroll
            for (int j = 0; j < NTS; ++j)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                const float v = tmp[i][j][2 * half + cc];
                const int col = c0 + ns0 + 8 * j + 2 * tq + cc;
                upart[i][half] = fmaf(sB[row * S::LDB + col], v,
                                      upart[i][half]);
                acc_db[s][i][j][2 * half + cc] =
                    fmaf(wr, v, acc_db[s][i][j][2 * half + cc]);
              }
          }
        if (has_h)  // this thread's share of <G, h>
          for (int idx = tid; idx < P * NS; idx += THREADS) {
            const int p = idx / NS, n = idx % NS;
            gh = fmaf(sG[p * S::LDG + n], sH[p * S::LDH + n], gh);
          }
      }
      __syncthreads();  // the slice's h and G are read
      if (s + 1 < SL) load_slice(s + 1);
    }

    // dx, contiguous (B,H,L,P)
    const size_t prow = ((size_t)bi * H + h) * L + l0;  // row l0 of (b, h)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = x_row(i) + 8 * half;
        if (row >= rows) continue;
#pragma unroll
        for (int j = 0; j < NTX; ++j)
          store2(dx + (prow + row) * P + px0 + 8 * j + 2 * tq,
                 accx[i][j][2 * half], accx[i][j][2 * half + 1]);
      }
    // u and r: over the lanes of a row, then the column warps in order
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float u = upart[i][half], r = rpart[i][half];
        u += __shfl_xor_sync(0xffffffffu, u, 1);
        u += __shfl_xor_sync(0xffffffffu, u, 2);
        r += __shfl_xor_sync(0xffffffffu, r, 1);
        r += __shfl_xor_sync(0xffffffffu, r, 2);
        if (tq == 0) {
          const int row = tile_row(i) + 8 * half;
          smem[S::RU + wn * Q + row] = u;
          smem[S::RR + wn * Q + row] = r;
        }
      }
    float* red = smem + S::GH;
    red[tid] = gh;
    __syncthreads();
    if (tid < Q) {
      float u = 0.f, r = 0.f;
#pragma unroll
      for (int q = 0; q < WN; ++q) {
        u += smem[S::RU + q * Q + tid];
        r += smem[S::RR + q * Q + tid];
      }
      smem[S::U + tid] = u;
      smem[S::R + tid] = r;
    }
    for (int s = THREADS / 2; s > 0; s >>= 1) {  // <G, h>, a fixed tree
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    if (tid == 0) {  // d(dt a), ddt and da's share
      const float* u = smem + S::U;
      const float* r = smem + S::R;
      float* wu = smem + S::WU;
      float run = 0.f;
      for (int m = 0; m < Q; ++m) {  // sum of w u over k < m
        wu[m] = run;
        run = fmaf(w[m], u[m], run);
      }
      const float carry = expf(last) * red[0];
      const float ah = a[h];
      float er = 0.f, da = 0.f;
      for (int m = Q - 1; m >= 0; --m) {
        er = fmaf(e[m], r[m], er);  // sum of e r over k >= m
        const float dda = smem[S::SEG + m] + er + wu[m] + carry;
        da = fmaf(dts[m], dda, da);
        if (m < rows)
          ddt[prow + m] = smem[S::MDS + m] + wo[m] * u[m] + ah * dda;
      }
      pda[((size_t)bi * H + h) * nc + chunk] = da;
    }
    __syncthreads();  // x, dy and this head's rows are read
  }

  // the group's dC and dB, (B, groups, L, N)
  const size_t grow = ((size_t)bi * gridDim.y + grp) * L + l0;
#pragma unroll
  for (int s = 0; s < SL; ++s)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = tile_row(i) + 8 * half;
        if (row >= rows) continue;
#pragma unroll
        for (int j = 0; j < NTS; ++j) {
          const int col = s * NS + ns0 + 8 * j + 2 * tq;
          store2(pdc + (grow + row) * N + col, acc_dc[s][i][j][2 * half],
                 acc_dc[s][i][j][2 * half + 1]);
          store2(pdb + (grow + row) * N + col, acc_db[s][i][j][2 * half],
                 acc_db[s][i][j][2 * half + 1]);
        }
      }
}

// ---- (iv) the sums over groups and chunks ----------------------------------

// Threads over (b, l, n): db, dc = the groups' partials summed in order
// 0 .. groups-1; the last block: da[h] = sum over (b, chunk) in order.
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ pdb, const float* __restrict__ pdc,
              const float* __restrict__ pda, float* __restrict__ db,
              float* __restrict__ dc, float* __restrict__ da, int B, int H,
              int L, int N, int nc, int groups) {
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
  for (int q = 0; q < groups; ++q) {
    const long long at = (bi * groups + q) * ln + rest;
    sb += pdb[at];
    sc += pdc[at];
  }
  db[e] = sb;
  dc[e] = sc;
}

// ---- host ------------------------------------------------------------------

struct Args {
  const float *x, *dt, *a, *b, *c, *dy, *ws_state, *ws_cb, *ws_decay;
  float *g, *pdb, *pdc, *pda, *dx, *ddt, *da, *db, *dc;
  int B, H, L, P, N;
  long long sxb, sxh, sxl, syb, syh, syl, sdb, sdh, sdl;
};

template <int N, int PT>
int launch_dstate(const Args& r, bool yvec, bool cvec, cudaStream_t st) {
  const int nc = (r.L + Q - 1) / Q, slices = r.P / PT;
  const long long tiles = (long long)r.B * slices * r.H * (nc > 1 ? nc - 1 : 1);
  const int group = group_for(tiles, DSTATE_BLOCKS * (long long)sm_count());
  auto k = dstate_kernel<N, PT>;
  constexpr size_t bytes = DstateSmem<N, PT>::BYTES;
  const cudaError_t err = allow_smem(k, bytes);
  if (err != cudaSuccess) return (int)err << 4;
  k<<<dim3(nc > 1 ? nc - 1 : 1, (r.H + group - 1) / group * slices, r.B),
      THREADS, bytes, st>>>(r.dy, r.dt, r.a, r.c, r.g, r.H, r.L, r.P, group,
                            r.syb, r.syh, r.syl, r.sdb, r.sdh, r.sdl, yvec,
                            cvec);
  return done(1);
}

// chunk_grad's groups of heads: the blocks fill the SMs about once
int grad_group(int B, int H, int L) {
  const int nc = (L + Q - 1) / Q;
  return group_for((long long)B * nc * H, sm_count());
}

template <int P, int N>
int launch_grad(const Args& r, bool xvec, bool yvec, bool bcvec,
                cudaStream_t st) {
  auto k = chunk_grad_kernel<P, N>;
  constexpr size_t bytes = GradSmem<P, N>::BYTES;
  const cudaError_t err = allow_smem(k, bytes);
  if (err != cudaSuccess) return ((int)err << 4) | 2;
  const int nc = (r.L + Q - 1) / Q, group = grad_group(r.B, r.H, r.L);
  k<<<dim3(nc, (r.H + group - 1) / group, r.B), THREADS, bytes, st>>>(
      r.x, r.dt, r.a, r.b, r.c, r.dy, r.ws_state, r.ws_cb, r.g, r.dx, r.ddt,
      r.pdb, r.pdc, r.pda, r.H, r.L, group, r.sxb, r.sxh, r.sxl, r.syb,
      r.syh, r.syl, r.sdb, r.sdh, r.sdl, xvec, yvec, bcvec);
  return done(3);
}

template <int P>
int dispatch_grad(const Args& r, bool xvec, bool yvec, bool bcvec,
                  cudaStream_t st) {
  switch (r.N) {
    case 16: return launch_grad<P, 16>(r, xvec, yvec, bcvec, st);
    case 32: return launch_grad<P, 32>(r, xvec, yvec, bcvec, st);
    case 64: return launch_grad<P, 64>(r, xvec, yvec, bcvec, st);
    default: return launch_grad<P, 128>(r, xvec, yvec, bcvec, st);
  }
}

template <int PT>
int dispatch_dstate(const Args& r, bool yvec, bool cvec, cudaStream_t st) {
  switch (r.N) {
    case 16: return launch_dstate<16, PT>(r, yvec, cvec, st);
    case 32: return launch_dstate<32, PT>(r, yvec, cvec, st);
    case 64: return launch_dstate<64, PT>(r, yvec, cvec, st);
    default: return launch_dstate<128, PT>(r, yvec, cvec, st);
  }
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
  Args r;
  r.x = static_cast<const float*>(x);
  r.dt = static_cast<const float*>(dt);
  r.a = static_cast<const float*>(a);
  r.b = static_cast<const float*>(b);
  r.c = static_cast<const float*>(c);
  r.dy = static_cast<const float*>(dy);
  r.ws_state = static_cast<const float*>(fwd_workspace);
  r.ws_cb = r.ws_state + fw.state;
  r.ws_decay = r.ws_cb + fw.cb;
  r.g = static_cast<float*>(work);
  r.pdb = r.g + w.g;
  r.pdc = r.pdb + w.pdb;
  r.pda = r.pdc + w.pdc;
  r.dx = static_cast<float*>(dx);
  r.ddt = static_cast<float*>(ddt);
  r.da = static_cast<float*>(da);
  r.db = static_cast<float*>(db);
  r.dc = static_cast<float*>(dc);
  r.B = B, r.H = H, r.L = L, r.P = P, r.N = N;
  r.sxb = sxb, r.sxh = sxh, r.sxl = sxl;
  r.syb = syb, r.syh = syh, r.syl = syl;
  r.sdb = sdb, r.sdh = sdh, r.sdl = sdl;
  const int nc = (L + Q - 1) / Q;
  const bool xvec = aligned(x, 16) && sxb % 4 == 0 && sxh % 4 == 0 &&
                    sxl % 4 == 0;
  const bool yvec = aligned(dy, 16) && syb % 4 == 0 && syh % 4 == 0 &&
                    syl % 4 == 0;
  const bool bcvec = aligned(b, 16) && aligned(c, 16);

  // (i)
  int rc = P == 32 ? dispatch_dstate<32>(r, yvec, bcvec, st)
                   : dispatch_dstate<64>(r, yvec, bcvec, st);
  if (rc != 1) return rc;

  // (ii)
  const long long pn = (long long)P * N;
  const long long items = (long long)B * H * pn;
  carry_kernel<<<(unsigned)((items + THREADS - 1) / THREADS), THREADS, 0,
                 st>>>(r.g, r.ws_decay, items, nc, pn);
  rc = done(2);
  if (rc != 2) return rc;

  // (iii)
  rc = P == 32 ? dispatch_grad<32>(r, xvec, yvec, bcvec, st)
       : P == 64 ? dispatch_grad<64>(r, xvec, yvec, bcvec, st)
                 : dispatch_grad<128>(r, xvec, yvec, bcvec, st);
  if (rc != 3) return rc;

  // (iv)
  const int groups = (H + grad_group(B, H, L) - 1) / grad_group(B, H, L);
  const long long cells = (long long)B * L * N;
  reduce_kernel<<<(unsigned)((cells + THREADS - 1) / THREADS) + 1, THREADS, 0,
                  st>>>(r.pdb, r.pdc, r.pda, r.db, r.dc, r.da, B, H, L, N, nc,
                        groups);
  return done(4);
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
