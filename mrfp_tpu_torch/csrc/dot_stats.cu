// A 1x1 convolution that also emits the per-channel BatchNorm sums of its
// output: for each sample n of an NCHW-contiguous x (N, Cin, HW) and a weight
// w (Cout, Cin),
//
//   y[n] = w @ x[n]                                  (Cout, HW), x's dtype
//   s1[c] = sum over n, p of y[n, c, p]              fp32
//   s2[c] = sum over n, p of y[n, c, p]^2            fp32
//
// Replaces the TPU kernel mrfp_tpu/ops/pallas_dot_stats.py::dot_with_stats
// (_kernel). The TPU kernel walks row tiles of the flattened (N*H*W, Cin) map
// in order on one core and carries the sums from one grid step to the next in
// VMEM scratch. Here blocks run in parallel and in no order, so each block
// writes the sums of its own tile to a partial row, and a second kernel adds
// the partial rows in a fixed order (common.cuh): two runs agree bit for bit,
// where fp32 atomics would not. As on the TPU, the sums are of the STORED
// value: y is rounded to its dtype first, and the rounded value and its
// square are summed, so BatchNorm sees exactly what the next layer sees.
// The sums are taken in fp64 (the square of an fp32 value is exact there)
// and rounded once to fp32, so they hardly depend on the order of the
// terms: the plain version, which sums the same stored values in fp64 in
// torch's order, gives the same fp32 sums wherever the two y agree (in fp32
// they agree bit for bit with cuBLAS's unless cuBLAS splits K). fp32 sums in
// two orders differ in their last bits, and an fp32 step on random weights
// amplifies a change of that size to percents of the early gradients
// (ROADMAP C3). The epilogue's fp64 adds are a few hundred a thread against
// the main loop's Cin * 64 FMAs.
//
// The GEMM reads NCHW directly, with no transposes: per sample it is
// (Cout x Cin) @ (Cin x HW), and HW is the contiguous axis of both x and y.
// A block computes a 64-channel x 128-pixel tile of one sample; per step of 16
// input channels it stages the w tile (k-major) and the x tile in shared
// memory as fp32, and each of its 128 threads accumulates an 8 x 8 patch in
// fp32 registers with FMAs on the CUDA cores. A thread's patch is two 4-row
// by two 4-column quarters 32 rows / 64 columns apart, so its float4 reads
// of shared memory do not conflict. Ragged edges (any Cout, Cin, HW) are
// zero-filled on load and masked on store.
//
// What bounds it on Hopper: operations. The 36 bottleneck 1x1s of a batch-8
// 768x768 step do 0.60 TFLOP and move 3.5 GB; in bf16 the tensor cores could
// do the work in 0.6 ms and the bytes take 1.06 ms, but this kernel runs on
// the CUDA cores (67 TFLOP/s fp32 peak), so it is far from either bound.
// That keeps fp32 exact (no TF32) and one code path for both dtypes; a
// tensor-core (wgmma) main loop for bf16 is the kernel's first perf PR.

#include "common.cuh"

namespace {

constexpr int kBM = 64;       // output channels per block
constexpr int kBN = 128;      // pixels per block
constexpr int kBK = 16;       // input channels per step
constexpr int kThreads = 128; // 8 channel groups x 16 pixel groups, 8 x 8 each
constexpr int kPadA = 4;      // keeps the transposed w-tile stores off one bank

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_stats_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                 double* __restrict__ part1, double* __restrict__ part2, int cin, int cout,
                 int hw) {
  __shared__ __align__(16) float as[kBK][kBM + kPadA];
  __shared__ __align__(16) float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // pixel group: columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid >> 4;  // channel group: rows ty*4 .. +3 and 32 + ty*4 .. +3
  const int n = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kBN;
  const T* xn = x + (int64_t)n * cin * hw;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += kBK) {
    // w tile (kBM x kBK): consecutive threads read consecutive input channels
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int m = idx / kBK, k = idx % kBK;
      const int gm = m0 + m, gk = k0 + k;
      as[k][m] = (gm < cout && gk < cin) ? to_f32(w[(int64_t)gm * cin + gk]) : 0.f;
    }
    // x tile (kBK x kBN): consecutive threads read consecutive pixels
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int k = idx / kBN, j = idx % kBN;
      const int gk = k0 + k, gj = j0 + j;
      bs[k][j] = (gk < cin && gj < hw) ? to_f32(xn[(int64_t)gk * hw + gj]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][32 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: round, store, and sum the stored values per channel
  T* yn = y + (int64_t)n * cout * hw;
  const int64_t prow = (int64_t)n * gridDim.x + blockIdx.x;  // this tile's partial row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + (i - 4));
    double s1 = 0.0, s2 = 0.0;
    if (m < cout) {
      T* row = yn + (int64_t)m * hw;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
        if (c < hw) {
          const T v = from_f32<T>(acc[i][j]);
          row[c] = v;
          const double f = to_f32(v);
          s1 += f;
          s2 += f * f;
        }
      }
    }
    // the 16 pixel groups of this channel are the 16 lanes of one half warp:
    // a butterfly over them adds in a fixed order
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (tx == 0 && m < cout) {
      part1[prow * cout + m] = s1;
      part2[prow * cout + m] = s2;
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, double* part1, double* part2, int n, int cin,
            int cout, int hw, cudaStream_t s) {
  const dim3 grid((hw + kBN - 1) / kBN, (cout + kBM - 1) / kBM, n);
  dot_stats_kernel<T><<<grid, kThreads, 0, s>>>((const T*)x, (const T*)w, (T*)y, part1, part2,
                                                cin, cout, hw);
}

}  // namespace

// The number of partial rows the caller allocates: (2, parts, cout) fp64.
extern "C" int mrfp_dot_with_stats_parts(int n, int hw) {
  return n * ((hw + kBN - 1) / kBN);
}

// x (n, cin, hw), w (cout, cin), y (n, cout, hw): contiguous, all of `dtype`
// (0 = float32, 1 = bfloat16); part: (2, parts, cout) fp64 scratch; s1, s2:
// (cout,) fp32. Returns cudaGetLastError() after the launches.
extern "C" int mrfp_dot_with_stats(const void* x, const void* w, void* y, void* part, int parts,
                                   void* s1, void* s2, int n, int cin, int cout, int hw,
                                   int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cout <= 0) return (int)cudaSuccess;
  if (n <= 0 || hw <= 0) {
    cudaMemsetAsync(s1, 0, sizeof(float) * cout, s);
    cudaMemsetAsync(s2, 0, sizeof(float) * cout, s);
    return (int)cudaGetLastError();
  }
  const int tiles_y = (cout + kBM - 1) / kBM;
  if (parts != mrfp_dot_with_stats_parts(n, hw) || n > 65535 || tiles_y > 65535)
    return (int)cudaErrorInvalidValue;
  double* part1 = (double*)part;
  double* part2 = part1 + (int64_t)parts * cout;
  if (dtype == 0) {
    launch<float>(x, w, y, part1, part2, n, cin, cout, hw, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, y, part1, part2, n, cin, cout, hw, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_reduce_partials(part1, part2, parts, cout, (float*)s1, (float*)s2, s);
  return (int)cudaGetLastError();
}
