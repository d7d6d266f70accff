// Variants of K3 (sparsify, one threshold, f32, n % 4 == 0) for a timing
// sweep against the port's kernel (tools/sparsify_bench.py): how many
// 16-byte items a thread loads before its first store, a grid of one
// block per span against one wave that loops, and the streaming cache
// hints (__ldcs / __stcs, evict first).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float keep(float v, float t) {
  return fabsf(v) >= t ? v : 0.f;
}

template <bool HINT>
__device__ __forceinline__ float4 load(const float4* p) {
  return HINT ? __ldcs(p) : *p;
}

template <bool HINT>
__device__ __forceinline__ void store(float4* p, float4 v) {
  if (HINT) __stcs(p, v); else *p = v;
}

// items [g0 + u * THREADS] for u < U, loads before stores
template <int U, bool HINT>
__device__ __forceinline__ void span(const float4* x, float4* out,
                                     long long g0, long long items, float t) {
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (g0 + u * THREADS < items) v[u] = load<HINT>(x + g0 + u * THREADS);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (g0 + u * THREADS < items)
      store<HINT>(out + g0 + u * THREADS,
                  make_float4(keep(v[u].x, t), keep(v[u].y, t),
                              keep(v[u].z, t), keep(v[u].w, t)));
}

template <int U, bool HINT>
__global__ void __launch_bounds__(THREADS)
spans(const float4* x, float4* out, long long items, float t) {
  span<U, HINT>(x, out, (long long)blockIdx.x * THREADS * U + threadIdx.x,
                items, t);
}

template <int U, bool HINT>
__global__ void __launch_bounds__(THREADS)
wave(const float4* x, float4* out, long long items, float t) {
  const long long step = (long long)gridDim.x * THREADS * U;
  for (long long g0 = (long long)blockIdx.x * THREADS * U + threadIdx.x;
       g0 < items; g0 += step)
    span<U, HINT>(x, out, g0, items, t);
}

template <int U, bool HINT>
void launch_spans(const float4* x, float4* o, long long n, float t) {
  const long long per = (long long)THREADS * U;
  spans<U, HINT><<<(unsigned)((n + per - 1) / per), THREADS>>>(x, o, n, t);
}

template <int U, bool HINT>
void launch_wave(const float4* x, float4* o, long long n, float t, int sms) {
  const long long per = (long long)THREADS * U, wave_blocks = 8LL * sms;
  const long long blocks = (n + per - 1) / per;
  wave<U, HINT><<<(unsigned)(blocks < wave_blocks ? blocks : wave_blocks),
                  THREADS>>>(x, o, n, t);
}

}  // namespace

// variant: 0-2 spans of 1, 2, 4 items; 3 spans of 1 with hints; 4 one
// wave of 4 items; 5 one wave of 4 items with hints.  `items` counts
// 4-value items.  Returns cudaGetLastError().
extern "C" int sparsify_variant(int variant, const void* x, void* out,
                                long long items, float t, int sms) {
  auto* xx = static_cast<const float4*>(x);
  auto* o = static_cast<float4*>(out);
  switch (variant) {
    case 0: launch_spans<1, false>(xx, o, items, t); break;
    case 1: launch_spans<2, false>(xx, o, items, t); break;
    case 2: launch_spans<4, false>(xx, o, items, t); break;
    case 3: launch_spans<1, true>(xx, o, items, t); break;
    case 4: launch_wave<4, false>(xx, o, items, t, sms); break;
    case 5: launch_wave<4, true>(xx, o, items, t, sms); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
