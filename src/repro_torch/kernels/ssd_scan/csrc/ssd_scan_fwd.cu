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
// and writes y once: 27.4 MB, 8.2 us at 3.35 TB/s.  Its least operations
// are the recurrence's, 2(N + P + 2PN) a row: 1.6 GFLOP, 24 us at the f32
// rate of the CUDA cores (67 TFLOP/s).  The chunked dual form at this
// kernel's Q = 64 does 2(QP + 2PN) a row and head plus 2QN a row for
// C B^T, which is shared by the heads: 2.0 GFLOP, in 3xTF32 6.1 G
// tensor-core operations, 12 us at the dense TF32 rate (495 TFLOP/s).
//
// What the design does about it:
//  * Three launches split the scan so that chunks run in parallel:
//    (i)   chunk_state: per (b, chunk, group of heads, slice of P) each
//          head's own state S_c = (x_c o w)^T B_c, w = exp(cs_Q - cs) dt,
//          and its decay exp(cs_Q); per (b, chunk) C B^T, once for all
//          heads (extra blocks of the same grid);
//    (ii)  state_pass: h_c = h_{c-1} exp(cs_Q) + S_c over the chunks, one
//          thread per 4 values of (P, N), in place;
//    (iii) chunk_out: per (b, chunk, group of heads, slice of P)
//          y = G x + exp(cs) o (C h_{c-1}^T), G = (C B^T) o L o dt.
//    The states and C B^T go through an f32 workspace the caller
//    allocates: B H (L/Q - 1) P N + B (L/Q) Q^2 + B H (L/Q) floats, 23 MB
//    at the path shape, within the 50 MB L2 (Q = 64 keeps the dual form's
//    Q^2 terms a quarter of Q = 128's).
//  * A block takes a group of heads of one (b, chunk), sized so that each
//    stage fills the SMs about once: what all heads share (B in (i); C in
//    (iii)) is staged once, tiles arrive by cp.async, and two blocks share
//    an SM, one's loads overlapping the other's products.
//  * Every product runs on the tensor cores with mma.sync m16n8k8 in
//    3xTF32: each f32 operand v is split as hi = v rounded to TF32 (two
//    integer operations) and lo = v - hi (read by the tensor cores to 19
//    bits), and a b ~ hi lo + lo hi + hi hi in the f32 accumulator.  One
//    TF32 product keeps ~3 digits and misses the 3e-5 tolerance (~5e-4 in
//    the CPU emulation, tests/test_torch_ssm.py); the split form is as
//    accurate as f32 products (1.7e-6 against 1.7e-6 there).
//    (The split, the fragments, a warp's tile of positions and the tile
//    staging are in ssd_scan.cuh, shared with the backward.)
//  * Operands stay in shared memory in f32, in rows padded so that a
//    warp's fragment loads hit 32 different banks; each warp owns a tile
//    of 16 x 8 mma positions and splits each fragment once for all the
//    positions that share it, issuing the three products term by term so
//    that independent mmas stand between dependent ones.  chunk_out forms
//    each head's G once (the exponentials), skips the k-steps of G x
//    wholly above the diagonal, pairs row tiles (0, 3) and (1, 2) so that
//    every warp does the same share of that triangle, and skips C h^T for
//    chunk 0 (h = 0).
//  * What holds it (measured on the card): the products, issue-bound at
//    ~20 clocks an mma per SM sub-partition with operands split in
//    registers every step (tools/tf32_mma_bench.py: 6.7 on fixed
//    registers, 23 with the splits), and the carry, which moves the
//    states through L2 twice.  wgmma in TF32 with A split in registers
//    and B split once into swizzled shared memory was slower, with a wait
//    after each k-step and with all steps issued together (the compiler
//    then serialises the warpgroup around register-fed wgmmas).
//
// Translation from the TPU kernel.  The TPU ran grid (B, H, L/Q) with the
// chunk dimension sequential and h in VMEM scratch.  Blocks on Hopper run
// in no order and nothing carries between them, so the carry is its own
// launch between the two parallel stages, and the per-chunk states it
// reads and writes live in device memory (L2) instead of VMEM; the TPU's
// C B^T per (b, h, chunk) is computed once per (b, chunk).
//
// Traps handled here:
//  * exp(cs_i - cs_j) is formed only for j <= i.  a reaches -16 in the model
//    and cs falls to -1e3 over a chunk, so above the diagonal the exponent is
//    +1e3, exp overflows to inf, and inf * 0 is NaN.  L is never factored as
//    exp(cs_i) * exp(-cs_j) for the same reason.  exp(cs), exp(cs_Q - cs)
//    and exp(cs_Q) are <= 1 and may underflow to 0 harmlessly.
//  * The function does not depend on the chunk length, so the kernel uses
//    its own (64) whatever the caller's chunk; the wrapper keeps the chunk
//    contract of the JAX package (L a multiple of min(chunk, L)).
//  * A ragged last chunk (L not a multiple of 64) is padded in shared memory
//    with x = b = c = dt = 0: padded rows add no decay and no state, and are
//    not stored.  The last chunk's state is never needed, so stage (i)
//    skips it.
//  * x and dt are read through strides (the model passes permuted views of
//    its (B,L,H,P) and (B,L,H) tensors, no copy); x has unit stride along P.
#include "ssd_scan.cuh"

namespace {

// ---- (i) chunk states and C B^T --------------------------------------------

// Shared memory (floats).  A state block: B [Q][N + 8] (rows 8 banks apart:
// a fragment reads 4 rows x 8 columns), the x slice [Q][PT + 8], w =
// exp(cs_Q - cs) dt of each head [8][Q]; a C B^T block: C and B [Q][N + 4]
// (4 banks apart: 8 rows x 4 columns).
template <int N, int PT>
struct StateSmem {
  static constexpr int LDX = PT + 8, LDB = N + 8, LDC = N + 4;
  static constexpr int B = 0, X = B + Q * LDB, W = X + Q * LDX;
  static constexpr int STATE_END = W + MAX_GROUP * Q;
  static constexpr int C2 = 0, B2 = C2 + Q * LDC, CB_END = B2 + Q * LDC;
  static constexpr size_t BYTES =
      sizeof(float) * (STATE_END > CB_END ? STATE_END : CB_END);
};

constexpr int STATE_BLOCKS = 2;  // blocks of stage (i) an SM

// grid (L/Q chunks, groups * P/PT + 1, B).  blockIdx.y == groups * P/PT
// computes the chunk's C B^T; the others PT columns of the states of a
// group of heads, B staged once for the group.  Two blocks share an SM,
// one's loads overlapping the other's products (loading the next head's
// x during this head's product measured the same on the card).
template <typename T, int N, int PT>
__global__ void __launch_bounds__(THREADS, STATE_BLOCKS)
chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const T* __restrict__ b,
                   const T* __restrict__ c, float* __restrict__ ws_state,
                   float* __restrict__ ws_cb, float* __restrict__ ws_decay,
                   int H, int L, int P, int group, long long sxb,
                   long long sxh, long long sxl, long long sdb,
                   long long sdh, long long sdl, bool xvec, bool bcvec) {
  using S = StateSmem<N, PT>;
  extern __shared__ __align__(16) float smem[];
  const int chunk = blockIdx.x, nc = gridDim.x, bi = blockIdx.z;
  const int slices = P / PT, groups = (H + group - 1) / group;
  const int l0 = chunk * Q, rows = min(Q, L - l0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const T* bb = b + ((size_t)bi * L + l0) * N;

  if ((int)blockIdx.y == groups * slices) {  // C B^T of (b, chunk)
    float* sC = smem + S::C2;
    float* sB = smem + S::B2;
    load_tile<Q, N, S::LDC>(sC, c + ((size_t)bi * L + l0) * N, N, rows,
                            bcvec);
    load_tile<Q, N, S::LDC>(sB, bb, N, rows, bcvec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    using WG = WarpGrid<Q, Q>;
    const int wm = warp / WG::WN, wn = warp % WG::WN;
    const int m0 = wm * WG::MT * 16, n0 = wn * WG::NT * 8;
    float acc[WG::MT][WG::NT][4];
    zero(acc);
    mma_3xtf32(
        acc, 0, N,
        [&](int i, int k0, float* v) {  // A[i][k] = C[i][k]
          const float* r0 = sC + (m0 + 16 * i + g) * S::LDC + k0 + t;
          v[0] = r0[0];
          v[1] = r0[8 * S::LDC];
          v[2] = r0[4];
          v[3] = r0[8 * S::LDC + 4];
        },
        [&](int j, int k0, float* v) {  // B[k][j] = B[j][k]
          const float* r0 = sB + (n0 + 8 * j + g) * S::LDC + k0 + t;
          v[0] = r0[0];
          v[1] = r0[4];
        });
    float* out = ws_cb + (size_t)(bi * nc + chunk) * Q * Q;
#pragma unroll
    for (int i = 0; i < WG::MT; ++i)
#pragma unroll
      for (int j = 0; j < WG::NT; ++j) {
        const int row = m0 + 16 * i + g, col = n0 + 8 * j + 2 * t;
        store2(out + row * Q + col, acc[i][j][0], acc[i][j][1]);
        store2(out + (row + 8) * Q + col, acc[i][j][2], acc[i][j][3]);
      }
    return;
  }

  if (chunk == nc - 1) return;  // the last chunk's state is never read
  const int h0 = (blockIdx.y / slices) * group;
  const int p0 = (blockIdx.y % slices) * PT;
  const int heads = min(group, H - h0);
  float* sB = smem + S::B;
  float* sW = smem + S::W;
  const T* xb = x + bi * sxb + l0 * sxl + p0;
  load_tile<Q, N, S::LDB>(sB, bb, N, rows, bcvec);
  load_tile<Q, PT, S::LDX>(smem + S::X, xb + h0 * sxh, sxl, rows, xvec);
  cp_async_commit();
  if (warp < heads) {  // warp k: head h0 + k's w and decay
    const int h = h0 + warp;
    const LaneCumsum r =
        chunk_cumsum(dt + bi * sdb + h * sdh + l0 * sdl, sdl, a[h], rows);
    float* w = sW + warp * Q;  // exponents <= 0
    w[2 * lane] = expf(r.last - r.cs0) * r.dt0;
    w[2 * lane + 1] = expf(r.last - r.cs1) * r.dt1;
    if (lane == 0 && p0 == 0)
      ws_decay[((size_t)bi * H + h) * nc + chunk] = expf(r.last);
  }

  // S (PT x N) = (x o w)^T B: A[p][j] = x[j][p] w[j], B[j][n]
  using WG = WarpGrid<PT, N>;
  const int wm = warp / WG::WN, wn = warp % WG::WN;
  const int m0 = wm * WG::MT * 16, n0 = wn * WG::NT * 8;
  for (int k = 0; k < heads; ++k) {
    if (k > 0)  // this head's x (head 0's came with B)
      load_tile<Q, PT, S::LDX>(smem + S::X, xb + (h0 + k) * sxh, sxl, rows,
                               xvec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float* sX = smem + S::X;
    const float* w = sW + k * Q;
    if (wm < WG::WM) {  // idle warps of small shapes
      float acc[WG::MT][WG::NT][4];
      zero(acc);
      mma_3xtf32<WG::MT, WG::NT, true>(
          acc, 0, Q,
          [&](int i, int k0, float* v) {
            const float* r0 = sX + (k0 + t) * S::LDX + m0 + 16 * i + g;
            const float w0 = w[k0 + t], w1 = w[k0 + t + 4];
            v[0] = r0[0] * w0;
            v[1] = r0[8] * w0;
            v[2] = r0[4 * S::LDX] * w1;
            v[3] = r0[4 * S::LDX + 8] * w1;
          },
          [&](int j, int k0, float* v) {
            const float* r0 = sB + (k0 + t) * S::LDB + n0 + 8 * j + g;
            v[0] = r0[0];
            v[1] = r0[4 * S::LDB];
          });
      float* out = ws_state +
                   (((size_t)bi * H + h0 + k) * (nc - 1) + chunk) *
                       (size_t)P * N +
                   (size_t)p0 * N;
#pragma unroll
      for (int i = 0; i < WG::MT; ++i)
#pragma unroll
        for (int j = 0; j < WG::NT; ++j) {
          const int row = m0 + 16 * i + g, col = n0 + 8 * j + 2 * t;
          store2(out + row * N + col, acc[i][j][0], acc[i][j][1]);
          store2(out + (row + 8) * N + col, acc[i][j][2], acc[i][j][3]);
        }
    }
    __syncthreads();  // every warp is done with this x slice
  }
}

// ---- (ii) the carry --------------------------------------------------------

// One thread per 4 values of a head's (P, N) state: h_c = h_{c-1} d_c + S_c
// for chunks 0 .. nc - 2, written over S_c (the state after chunk c, which
// chunk c + 1 reads).  Loads are issued 8 chunks ahead of the chain.
__global__ void __launch_bounds__(THREADS)
state_pass_kernel(float* __restrict__ ws_state,
                  const float* __restrict__ ws_decay, long long items,
                  int nc, int pn4_shift) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= items) return;
  const long long bh = e >> pn4_shift;
  const long long pn4 = 1LL << pn4_shift;
  float4* s = reinterpret_cast<float4*>(ws_state) +
              bh * (nc - 1) * pn4 + (e & (pn4 - 1));
  const float* d = ws_decay + bh * nc;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc - 1; c0 += 8) {
    float4 v[8];
    float dc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + u < nc - 1) {
        v[u] = s[(c0 + u) * pn4];
        dc[u] = d[c0 + u];
      }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + u < nc - 1) {
        h.x = fmaf(h.x, dc[u], v[u].x);
        h.y = fmaf(h.y, dc[u], v[u].y);
        h.z = fmaf(h.z, dc[u], v[u].z);
        h.w = fmaf(h.w, dc[u], v[u].w);
        s[(c0 + u) * pn4] = h;
      }
  }
}

// ---- (iii) the chunks' outputs ---------------------------------------------

// Shared memory (floats): C [Q][N + 4] (shared by the group's heads) and
// G [Q][Q + 4] (A operands, 8 rows x 4 columns a fragment), x slice
// [Q][PT + 8] (B operand, 4 rows x 8 columns) and state slice h [PT][N + 4]
// (B = h^T, 8 rows x 4 columns); cs, dt and exp(cs) of each head [8][Q].
// 109 KB at N 128, so two blocks share an SM and one's loads overlap the
// other's products (on the card this beat one block an SM that loads the
// next head's tiles during this head's products).
constexpr int OUT_BLOCKS = 2;  // blocks of stage (iii) an SM

template <int N, int PT>
struct OutSmem {
  static constexpr int LDC = N + 4, LDG = Q + 4, LDX = PT + 8, LDH = N + 4;
  static constexpr int C = 0, G = C + Q * LDC, X = G + Q * LDG;
  static constexpr int H = X + Q * LDX, CS = H + PT * LDH;
  static constexpr int DT = CS + MAX_GROUP * Q, E = DT + MAX_GROUP * Q;
  static constexpr int END = E + MAX_GROUP * Q;
  static constexpr size_t BYTES = sizeof(float) * END;
};

// grid (L/Q chunks, groups * P/PT, B): PT columns of y for a group of
// heads of one (b, chunk).  Each head's G is formed once into shared
// memory from C B^T, read from L2 (16 KB a head).
template <typename T, int N, int PT>
__global__ void __launch_bounds__(THREADS, OUT_BLOCKS)
chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ c,
                 const float* __restrict__ ws_state,
                 const float* __restrict__ ws_cb, T* __restrict__ y, int H,
                 int L, int P, int group, long long sxb, long long sxh,
                 long long sxl, long long sdb, long long sdh, long long sdl,
                 bool xvec, bool cvec) {
  using S = OutSmem<N, PT>;
  extern __shared__ __align__(16) float smem[];
  const float* sC = smem + S::C;
  float* sG = smem + S::G;
  const int chunk = blockIdx.x, nc = gridDim.x, bi = blockIdx.z;
  const int slices = P / PT;
  const int h0 = (blockIdx.y / slices) * group;
  const int p0 = (blockIdx.y % slices) * PT;
  const int heads = min(group, H - h0);
  const int l0 = chunk * Q, rows = min(Q, L - l0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const T* xb = x + bi * sxb + l0 * sxl + p0;
  // the state after the previous chunk, rows p0 .. p0 + PT of each head
  const float* hb =
      chunk > 0 ? ws_state + (((size_t)bi * H) * (nc - 1) + chunk - 1) *
                                 (size_t)P * N + (size_t)p0 * N
                : nullptr;
  const size_t h_stride = (size_t)(nc - 1) * P * N;  // from head to head

  constexpr int CB_ITERS = Q * Q / 4 / THREADS;
  static_assert(CB_ITERS * 4 * THREADS == Q * Q, "C B^T tile");
  const float4* cb = reinterpret_cast<const float4*>(
      ws_cb + (size_t)(bi * nc + chunk) * Q * Q);
  load_tile<Q, N, S::LDC>(smem + S::C, c + ((size_t)bi * L + l0) * N, N,
                          rows, cvec);
  load_tile<Q, PT, S::LDX>(smem + S::X, xb + h0 * sxh, sxl, rows, xvec);
  if (chunk > 0)
    load_tile<PT, N, S::LDH>(smem + S::H, hb + h0 * h_stride, N, PT, true);
  cp_async_commit();
  if (warp < heads) {  // warp k: head h0 + k's cs, dt and exp(cs)
    const int h = h0 + warp;
    const LaneCumsum r =
        chunk_cumsum(dt + bi * sdb + h * sdh + l0 * sdl, sdl, a[h], rows);
    const int j = warp * Q + 2 * lane;
    smem[S::CS + j] = r.cs0;
    smem[S::CS + j + 1] = r.cs1;
    smem[S::DT + j] = r.dt0;
    smem[S::DT + j + 1] = r.dt1;
    smem[S::E + j] = expf(r.cs0);  // <= 1
    smem[S::E + j + 1] = expf(r.cs1);
  }
  __syncthreads();  // every head's cs

  // y (Q x PT): warps 2 along the rows, 4 along the columns.  Row group 0
  // takes row tiles 0 and 3 of 16 rows, group 1 tiles 1 and 2, so that
  // both groups do the same share of G x's triangle.
  constexpr int NT = PT / 32;
  const int rg = warp / 4, n0 = (warp % 4) * (PT / 4);
  const int ta = rg == 0 ? 0 : 1, tb = 3 - ta;
  const int ra = 16 * ta + g, rb = 16 * tb + g;  // rows ra, ra + 8, rb, rb + 8
  for (int k = 0; k < heads; ++k) {
    const float* cs = smem + S::CS + k * Q;
    const float* dts = smem + S::DT + k * Q;
    if (k > 0) {  // this head's tiles (head 0's came with C)
      load_tile<Q, PT, S::LDX>(smem + S::X, xb + (h0 + k) * sxh, sxl, rows,
                               xvec);
      if (chunk > 0)
        load_tile<PT, N, S::LDH>(smem + S::H, hb + (h0 + k) * h_stride, N,
                                 PT, true);
    }
    cp_async_commit();
    // G[i][j] = CB[i][j] exp(cs_i - cs_j) dt_j on and below the diagonal
    float4 cbv[CB_ITERS];
#pragma unroll
    for (int it = 0; it < CB_ITERS; ++it)
      cbv[it] = cb[threadIdx.x + it * THREADS];
#pragma unroll
    for (int it = 0; it < CB_ITERS; ++it) {
      const int e = 4 * (threadIdx.x + it * THREADS);
      const int i = e / Q, j = e % Q;
      const float ci = cs[i];
      const float v[4] = {cbv[it].x, cbv[it].y, cbv[it].z, cbv[it].w};
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        o[u] = j + u <= i ? v[u] * expf(ci - cs[j + u]) * dts[j + u] : 0.f;
      *reinterpret_cast<float4*>(sG + i * S::LDG + j) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
    cp_async_wait<0>();
    __syncthreads();
    const float* sX = smem + S::X;
    const float* sH = smem + S::H;
    float accd[2][NT][4], acco[2][NT][4];
    zero(accd);
    zero(acco);
    // A fragments of row tile ta (i = 0) or tb (i = 1) from a [Q][ld] tile
    auto frag_a = [&](const float* m, int ld, int i, int k0, float* v) {
      const float* r0 = m + (i == 0 ? ra : rb) * ld + k0 + t;
      v[0] = r0[0];
      v[1] = r0[8 * ld];
      v[2] = r0[4];
      v[3] = r0[8 * ld + 4];
    };
    auto frag_x = [&](int j, int k0, float* v) {
      const float* r0 = sX + (k0 + t) * S::LDX + n0 + 8 * j + g;
      v[0] = r0[0];
      v[1] = r0[4 * S::LDX];
    };
    // G x: both tiles up to tile ta's diagonal block, then tile tb alone
    // up to its own; k-steps past a tile's last row lie above the diagonal
    mma_3xtf32(
        accd, 0, 16 * ta + 16,
        [&](int i, int k0, float* v) { frag_a(sG, S::LDG, i, k0, v); },
        frag_x);
    mma_3xtf32(
        *reinterpret_cast<float(*)[1][NT][4]>(&accd[1]), 16 * ta + 16,
        16 * tb + 16,
        [&](int, int k0, float* v) { frag_a(sG, S::LDG, 1, k0, v); },
        frag_x);
    if (chunk > 0)  // C h^T
      mma_3xtf32(
          acco, 0, N,
          [&](int i, int k0, float* v) { frag_a(sC, S::LDC, i, k0, v); },
          [&](int j, int k0, float* v) {  // B[k][p] = h[p][k]
            const float* r0 = sH + (n0 + 8 * j + g) * S::LDH + k0 + t;
            v[0] = r0[0];
            v[1] = r0[4];
          });

    T* yb = y + (((size_t)bi * H + h0 + k) * L + l0) * (size_t)P + p0;
    const float* ek = smem + S::E + k * Q;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = (i == 0 ? ra : rb) + 8 * half;
        if (row >= rows) continue;
        const float e = ek[row];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          store2(yb + (size_t)row * P + n0 + 8 * j + 2 * t,
                 accd[i][j][2 * half] + e * acco[i][j][2 * half],
                 accd[i][j][2 * half + 1] + e * acco[i][j][2 * half + 1]);
      }
    __syncthreads();  // every warp is done with this head's tiles and G
  }
}

// ---- host ------------------------------------------------------------------

template <typename T, int N, int PT>
int launch(const T* x, const float* dt, const float* a, const T* b,
           const T* c, T* y, float* ws, int B, int H, int L, int P,
           long long sxb, long long sxh, long long sxl, long long sdb,
           long long sdh, long long sdl, cudaStream_t st) {
  const Workspace w(B, H, L, P, N);
  float* ws_state = ws;
  float* ws_cb = ws + w.state;
  float* ws_decay = ws_cb + w.cb;
  const int nc = (L + Q - 1) / Q, slices = P / PT;
  const bool xvec = aligned(x, 4 * sizeof(T)) && sxb % 4 == 0 &&
                    sxh % 4 == 0 && sxl % 4 == 0;
  const bool bcvec = aligned(b, 4 * sizeof(T)) && aligned(c, 4 * sizeof(T));
  const long long sms = sm_count();

  // (i): about two blocks an SM (shared memory and registers hold two)
  const long long tiles = (long long)B * slices * H;
  const int g1 =
      group_for(tiles * (nc > 1 ? nc - 1 : 1), STATE_BLOCKS * sms);
  auto k1 = chunk_state_kernel<T, N, PT>;
  constexpr size_t smem1 = StateSmem<N, PT>::BYTES;
  cudaError_t err = allow_smem(k1, smem1);
  if (err != cudaSuccess) return (int)err << 4;
  k1<<<dim3(nc, (H + g1 - 1) / g1 * slices + 1, B), THREADS, smem1, st>>>(
      x, dt, a, b, c, ws_state, ws_cb, ws_decay, H, L, P, g1, sxb, sxh, sxl,
      sdb, sdh, sdl, xvec, bcvec);
  int rc = done(1);
  if (rc != 1) return rc;

  // (ii)
  const long long items = (long long)B * H * P * N / 4;
  int shift = 0;
  while ((1LL << shift) < (long long)P * N / 4) ++shift;
  state_pass_kernel<<<(unsigned)((items + THREADS - 1) / THREADS), THREADS, 0,
                      st>>>(ws_state, ws_decay, items, nc, shift);
  rc = done(2);
  if (rc != 2) return rc;

  // (iii): about as many blocks as the SMs hold at once
  const int g3 = group_for(tiles * nc, OUT_BLOCKS * sms);
  auto k3 = chunk_out_kernel<T, N, PT>;
  constexpr size_t smem3 = OutSmem<N, PT>::BYTES;
  err = allow_smem(k3, smem3);
  if (err != cudaSuccess) return ((int)err << 4) | 2;
  k3<<<dim3(nc, (H + g3 - 1) / g3 * slices, B), THREADS, smem3, st>>>(
      x, dt, a, c, ws_state, ws_cb, y, H, L, P, g3, sxb, sxh, sxl, sdb, sdh,
      sdl, xvec, bcvec);
  return done(3);
}

template <typename T, int N>
int dispatch_p(const void* x, const float* dt, const float* a, const void* b,
               const void* c, void* y, float* ws, int B, int H, int L, int P,
               long long sxb, long long sxh, long long sxl, long long sdb,
               long long sdh, long long sdl, cudaStream_t st) {
  auto* xx = static_cast<const T*>(x);
  auto* bb = static_cast<const T*>(b);
  auto* cc = static_cast<const T*>(c);
  auto* yy = static_cast<T*>(y);
  if (P == 32)
    return launch<T, N, 32>(xx, dt, a, bb, cc, yy, ws, B, H, L, P, sxb, sxh,
                            sxl, sdb, sdh, sdl, st);
  return launch<T, N, 64>(xx, dt, a, bb, cc, yy, ws, B, H, L, P, sxb, sxh,
                          sxl, sdb, sdh, sdl, st);
}

template <typename T>
int dispatch_n(const void* x, const float* dt, const float* a, const void* b,
               const void* c, void* y, float* ws, int B, int H, int L, int P,
               int N, long long sxb, long long sxh, long long sxl,
               long long sdb, long long sdh, long long sdl, cudaStream_t s) {
  switch (N) {
    case 16: return dispatch_p<T, 16>(x, dt, a, b, c, y, ws, B, H, L, P, sxb, sxh, sxl, sdb, sdh, sdl, s);
    case 32: return dispatch_p<T, 32>(x, dt, a, b, c, y, ws, B, H, L, P, sxb, sxh, sxl, sdb, sdh, sdl, s);
    case 64: return dispatch_p<T, 64>(x, dt, a, b, c, y, ws, B, H, L, P, sxb, sxh, sxl, sdb, sdh, sdl, s);
    case 128: return dispatch_p<T, 128>(x, dt, a, b, c, y, ws, B, H, L, P, sxb, sxh, sxl, sdb, sdh, sdl, s);
    default: return (int)cudaErrorInvalidValue << 4;
  }
}

}  // namespace

// f32 values of workspace ssd_scan_fwd needs: the chunk states (all but the
// last chunk's), C B^T per batch row and chunk, each chunk's decay
extern "C" long long ssd_scan_workspace(int B, int H, int L, int P, int N) {
  const Workspace w(B, H, L, P, N);
  return w.state + w.cb + w.decay;
}

// dtype (of x, b, c, y): 0 = f32, 1 = bf16.  Strides in elements.  Three
// launches on ``stream``, no synchronisation.  Returns the number of
// kernels launched in the low four bits and, above them, the cudaError_t of
// a refused launch or cudaErrorInvalidValue for shapes it does not take (0
// on success: 3).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, void* y,
                            void* workspace, int B, int H, int L, int P,
                            int N, long long sxb, long long sxh,
                            long long sxl, long long sdb, long long sdh,
                            long long sdl, int dtype, void* stream) {
  if (B < 1 || H < 1 || L < 1 || (P != 32 && P != 64 && P != 128) ||
      B > 65535 || H * (P / 32) >= 65535)
    return (int)cudaErrorInvalidValue << 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0)
    return dispatch_n<float>(x, dtf, af, b, c, y, ws, B, H, L, P, N, sxb, sxh, sxl, sdb, sdh, sdl, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(x, dtf, af, b, c, y, ws, B, H, L, P, N, sxb, sxh, sxl, sdb, sdh, sdl, s);
  return (int)cudaErrorInvalidValue << 4;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
