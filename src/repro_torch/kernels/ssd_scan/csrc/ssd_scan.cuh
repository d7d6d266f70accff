// What the SSD scan's forward (ssd_scan_fwd.cu) and backward
// (ssd_scan_bwd.cu) kernels share: the chunk of Q rows, the block size, the
// warp's cumsum of dt a over a chunk, and the layout of the forward's f32
// workspace, which the backward reads.
#pragma once

#include <cuda_runtime.h>

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

}  // namespace
