// The NP+ apply: out[n, c, p] = x[n, c, p] * alpha[n, c] + shift[n, c] on an
// NCHW-contiguous map, with fp32 per-(sample, channel) coefficients; the
// product and the sum are each rounded in fp32 (no FMA contraction, as the
// plain PyTorch version's two ops round), and the result once to x's dtype.
//
// Replaces the TPU kernel mrfp_tpu/ops/pallas_np_plus.py::np_plus_apply_pallas
// (_apply_kernel), which tiles (1, 32, W, C) NHWC blocks with the (1,1,1,C)
// coefficient rows resident in VMEM. In NCHW one (sample, channel) plane
// shares one pair of coefficients, so grid row y takes a plane, loads its
// pair once, and its threads take one element each along the plane.
//
// What bounds it on Hopper: bytes (one read and one write per element).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void np_plus_apply_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                                     const float* __restrict__ shift, T* __restrict__ out,
                                     int64_t planes, int64_t hw) {
  for (int64_t p = blockIdx.y; p < planes; p += gridDim.y) {
    const float a = __ldg(alpha + p);
    const float b = __ldg(shift + p);
    const T* src = x + p * hw;
    T* dst = out + p * hw;
    for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < hw;
         j += (int64_t)gridDim.x * kThreads)
      dst[j] = from_f32<T>(__fadd_rn(__fmul_rn(to_f32(src[j]), a), b));
  }
}

}  // namespace

// x, out (planes, hw) of `dtype` (0 = float32, 1 = bfloat16); alpha, shift
// (planes,) fp32. Returns cudaGetLastError() after the launch.
extern "C" int mrfp_np_plus_apply(const void* x, const void* alpha, const void* shift,
                                  void* out, int64_t planes, int64_t hw, int dtype,
                                  void* stream) {
  if (planes == 0 || hw == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t bx = (hw + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(bx < 1024 ? bx : 1024), (unsigned)(planes < 65535 ? planes : 65535));
  if (dtype == 0) {
    np_plus_apply_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)alpha, (const float*)shift, (float*)out, planes, hw);
  } else if (dtype == 1) {
    np_plus_apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)alpha, (const float*)shift,
        (__nv_bfloat16*)out, planes, hw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
