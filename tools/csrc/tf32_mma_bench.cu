// Throughput of mma.sync m16n8k8 TF32 on one card, alone and with the
// operand splits of 3xTF32 between the products (tools/tf32_mma_bench.py).
// Each warp keeps 8 independent accumulators and, per iteration, issues 8
// mmas; the split modes first split 12 values (one k-step's worth of a
// 1 x 4 warp tile: 4 of A, 8 of B) and feed one of them into A, as a
// kernel's fresh fragments would:
//   0: mmas on fixed registers;
//   1: split hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi);
//   2: split hi = (bits(v) + 0x1000) & ~0x1fff, lo = v - hi (the SSD
//      scan kernel's).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MODE>
__global__ void __launch_bounds__(256) bench(float* out, int iters, float seed) {
  float acc[8][4] = {};
  uint32_t a[4], b[8][2];
  for (int r = 0; r < 4; ++r) a[r] = __float_as_uint(seed + r + threadIdx.x);
  for (int j = 0; j < 8; ++j) {
    b[j][0] = __float_as_uint(seed * j);
    b[j][1] = __float_as_uint(seed + j);
  }
  const float v = seed + threadIdx.x;
  uint32_t sink = 0;
  for (int it = 0; it < iters; ++it) {
    if (MODE > 0) {
#pragma unroll
      for (int r = 0; r < 12; ++r) {
        const float x = v + r * 0.37f + it;
        uint32_t hi, lo;
        if (MODE == 1) {
          asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
          asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
        } else {
          hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
          lo = __float_as_uint(x - __uint_as_float(hi));
        }
        sink ^= hi + lo;
      }
      a[it & 3] ^= sink & 1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(acc[j], a, b[j]);
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int r = 0; r < 4; ++r) s += acc[j][r];
  out[blockIdx.x * 256 + threadIdx.x] = s + (float)sink;
}

}  // namespace

// blocks of 256 threads; returns cudaGetLastError() of the launch
extern "C" int tf32_mma_bench(int mode, float* out, int blocks, int iters) {
  if (mode == 0) bench<0><<<blocks, 256>>>(out, iters, 1.f);
  if (mode == 1) bench<1><<<blocks, 256>>>(out, iters, 1.f);
  if (mode == 2) bench<2><<<blocks, 256>>>(out, iters, 1.f);
  return (int)cudaGetLastError();
}
