// Helpers shared by the kernels: fp32 <-> storage-type conversion, the SM
// count and grid sizing for grid-stride launches. Everything is in an
// anonymous namespace, so each translation unit keeps its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch's cast
}

// The word one access moves: VEC values of T, 16 bytes on a vector route,
// or a single T on a scalar route. A thread reads its values out of the word
// (and builds the word it stores) through a T pointer.
template <typename T, int VEC>
struct Words {
  static_assert(sizeof(T) * VEC == 16, "a vector access moves 16 bytes");
  using type = uint4;
};
template <typename T>
struct Words<T, 1> {
  using type = T;
};

// Word i (0-3) of a 16-byte vector; with a constant i, a register.
__device__ __forceinline__ unsigned word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// The current device's SM count, read once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// Blocks for a grid-stride loop over `items` work items, `per_block` of them
// per block: no more than it takes to give every SM `per_sm` blocks.
inline int grid_for(int64_t items, int64_t per_block, int per_sm) {
  const int64_t want = (items + per_block - 1) / per_block;
  const int64_t cap = (int64_t)sm_count() * per_sm;
  return (int)(want < cap ? want : cap);
}

// Second pass of a two-pass column sum: out1[c] = sum over p of
// part1[p * cols + c], the same for part2, for p = 0 .. parts - 1, summed in
// Acc (float or double) and rounded once to Out (float, or double to keep
// the sums for a later reduction across processes). Each of 8 thread rows sums
// every 8th partial in order, then one thread adds the 8 row sums in order: a
// fixed order, so two runs agree bit for bit (no atomics). Consecutive
// threads take consecutive columns, so the loads coalesce.
constexpr int kReduceCols = 32;
constexpr int kReduceRows = 8;

template <typename Acc, typename Out>
__global__ void reduce_partials_kernel(const Acc* __restrict__ part1,
                                       const Acc* __restrict__ part2, int parts, int cols,
                                       Out* __restrict__ out1, Out* __restrict__ out2) {
  __shared__ Acc sh1[kReduceRows][kReduceCols + 1];
  __shared__ Acc sh2[kReduceRows][kReduceCols + 1];
  const int c = blockIdx.x * kReduceCols + threadIdx.x;
  Acc a = 0, b = 0;
  if (c < cols) {
    for (int p = threadIdx.y; p < parts; p += kReduceRows) {
      a += part1[(int64_t)p * cols + c];
      b += part2[(int64_t)p * cols + c];
    }
  }
  sh1[threadIdx.y][threadIdx.x] = a;
  sh2[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    Acc s1 = 0, s2 = 0;
    for (int r = 0; r < kReduceRows; ++r) {
      s1 += sh1[r][threadIdx.x];
      s2 += sh2[r][threadIdx.x];
    }
    out1[c] = (Out)s1;
    out2[c] = (Out)s2;
  }
}

template <typename Acc, typename Out = float>
void launch_reduce_partials(const Acc* part1, const Acc* part2, int parts, int cols,
                            Out* out1, Out* out2, cudaStream_t s) {
  const dim3 block(kReduceCols, kReduceRows);
  reduce_partials_kernel<Acc, Out><<<(cols + kReduceCols - 1) / kReduceCols, block, 0, s>>>(
      part1, part2, parts, cols, out1, out2);
}

}  // namespace
