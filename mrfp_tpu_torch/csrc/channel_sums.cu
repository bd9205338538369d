// Per-channel fp32 sum and sum of squares of an NCHW-contiguous map:
//
//   s1[c] = sum over n, p of x[n, c, p]      s2[c] = sum over n, p of x[n, c, p]^2
//
// the train-mode BatchNorm moments' inputs. Replaces the TPU kernel
// mrfp_tpu/ops/pallas_stats.py::_channel_sums_pallas (_sums_kernel), which
// folds channel-minor (M, C) rows into an (8, width) VMEM block carried
// across its sequential grid. In NCHW a channel's values are N contiguous
// runs of HW, so here block (c, s) sums the s-th of S equal slices of
// channel c's N*HW values: its threads stride over each run (coalesced
// loads), sum in fp32, and add their sums in a fixed tree order; the S
// partial sums of each channel are then added in a fixed order by the
// second pass in common.cuh. No atomics, so two runs agree bit for bit.
//
// What bounds it on Hopper: bytes read (each element once, 8 FLOP per 2 or 4
// bytes). The wrapper picks S so that the C*S blocks fill the card several
// times over; wider loads are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
channel_sums_kernel(const T* __restrict__ x, float* __restrict__ part1,
                    float* __restrict__ part2, int channels, int64_t hw, int64_t per_split,
                    int64_t total) {
  __shared__ float sh1[kThreads];
  __shared__ float sh2[kThreads];
  const int c = blockIdx.x;
  const int s = blockIdx.y;
  const int64_t t0 = (int64_t)s * per_split;
  const int64_t t1 = t0 + per_split < total ? t0 + per_split : total;
  float a = 0.f, b = 0.f;
  // the slice [t0, t1) of channel c's values, sample by sample
  for (int64_t n = t0 / hw; n * hw < t1; ++n) {
    const int64_t lo = t0 > n * hw ? t0 - n * hw : 0;
    const int64_t hi = t1 - n * hw < hw ? t1 - n * hw : hw;
    const T* row = x + (n * channels + c) * hw;
    for (int64_t j = lo + threadIdx.x; j < hi; j += kThreads) {
      const float v = to_f32(row[j]);
      a += v;
      b = fmaf(v, v, b);
    }
  }
  sh1[threadIdx.x] = a;
  sh2[threadIdx.x] = b;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      sh1[threadIdx.x] += sh1[threadIdx.x + off];
      sh2[threadIdx.x] += sh2[threadIdx.x + off];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    part1[(int64_t)s * channels + c] = sh1[0];
    part2[(int64_t)s * channels + c] = sh2[0];
  }
}

}  // namespace

// x (n, channels, hw) of `dtype` (0 = float32, 1 = bfloat16), contiguous;
// part: (2, splits, channels) fp32 scratch; s1, s2: (channels,) fp32.
// Returns cudaGetLastError() after the launches.
extern "C" int mrfp_channel_sums(const void* x, void* part, int splits, void* s1, void* s2,
                                 int64_t n, int channels, int64_t hw, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (channels <= 0) return (int)cudaSuccess;
  const int64_t total = n * hw;
  if (total == 0) {
    cudaMemsetAsync(s1, 0, sizeof(float) * channels, s);
    cudaMemsetAsync(s2, 0, sizeof(float) * channels, s);
    return (int)cudaGetLastError();
  }
  if (splits <= 0 || splits > 65535) return (int)cudaErrorInvalidValue;
  const int64_t per_split = (total + splits - 1) / splits;
  float* part1 = (float*)part;
  float* part2 = part1 + (int64_t)splits * channels;
  const dim3 grid(channels, splits);
  if (dtype == 0) {
    channel_sums_kernel<float><<<grid, kThreads, 0, s>>>((const float*)x, part1, part2,
                                                         channels, hw, per_split, total);
  } else if (dtype == 1) {
    channel_sums_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, part1, part2, channels, hw, per_split, total);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_reduce_partials(part1, part2, splits, channels, (float*)s1, (float*)s2, s);
  return (int)cudaGetLastError();
}
