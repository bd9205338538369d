// The NP+ apply: out[n, c, p] = x[n, c, p] * alpha[n, c] + shift[n, c] on an
// NCHW-contiguous map, with fp32 per-(sample, channel) coefficients; the
// product and the sum are each rounded in fp32 (no FMA contraction, as the
// plain PyTorch version's two ops round), and the result once to x's dtype.
//
// Replaces the TPU kernel mrfp_tpu/ops/pallas_np_plus.py::np_plus_apply_pallas
// (_apply_kernel), which tiles (1, 32, W, C) NHWC blocks with the (1,1,1,C)
// coefficient rows resident in VMEM. In NCHW one (sample, channel) plane
// shares one pair of coefficients, so grid row y takes a plane and loads its
// pair once, and grid column x a chunk of that plane.
//
// What bounds it on Hopper: bytes (one read and one write per element). A
// thread moves 16 bytes an access (8 bf16 or 4 fp32) and keeps kUnroll such
// vectors in flight; neighbouring threads take neighbouring vectors, so a
// warp reads and writes 512 contiguous bytes an access. The per-plane offset
// is the only 64-bit product; indices inside a plane are 32-bit. Where the
// plane length is not a multiple of the vector or a pointer is not 16-byte
// aligned, the host picks the scalar route (VEC = 1) of the same kernel.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kPerBlock = kThreads * kUnroll;  // accesses a block makes

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
np_plus_apply_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                     const float* __restrict__ shift, T* __restrict__ out, int planes, int hw) {
  using Word = typename Words<T, VEC>::type;
  const int nvec = hw / VEC;
  const int first = blockIdx.x * kPerBlock + threadIdx.x;
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const float a = __ldg(alpha + p);
    const float b = __ldg(shift + p);
    const Word* src = reinterpret_cast<const Word*>(x + (int64_t)p * hw);
    Word* dst = reinterpret_cast<Word*>(out + (int64_t)p * hw);
    Word buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = first + u * kThreads;
      if (i < nvec) buf[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = first + u * kThreads;
      if (i < nvec) {
        const T* in = reinterpret_cast<const T*>(&buf[u]);
        Word r;
        T* res = reinterpret_cast<T*>(&r);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          res[k] = from_f32<T>(__fadd_rn(__fmul_rn(to_f32(in[k]), a), b));
        dst[i] = r;
      }
    }
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* alpha, const void* shift, void* out, int planes, int hw,
            cudaStream_t s) {
  const int nvec = hw / VEC;
  const dim3 grid((unsigned)((nvec + kPerBlock - 1) / kPerBlock),
                  (unsigned)(planes < 65535 ? planes : 65535));
  np_plus_apply_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      (const T*)x, (const float*)alpha, (const float*)shift, (T*)out, planes, hw);
}

}  // namespace

// x, out (planes, hw) of `dtype` (0 = float32, 1 = bfloat16); alpha, shift
// (planes,) fp32. `vec` is the values an access moves: 16 / itemsize (the
// vector route: hw a multiple of it, x and out 16-byte aligned) or 1 (the
// scalar route). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int mrfp_np_plus_apply(const void* x, const void* alpha, const void* shift,
                                  void* out, int64_t planes, int64_t hw, int vec, int dtype,
                                  void* stream) {
  if (planes == 0 || hw == 0) return (int)cudaSuccess;
  if (planes > INT32_MAX || hw > INT32_MAX - kPerBlock || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int full = dtype == 0 ? 4 : 8;
  if (vec != 1 && (vec != full || hw % vec != 0 || ((uintptr_t)x | (uintptr_t)out) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (vec == 1) launch<float, 1>(x, alpha, shift, out, (int)planes, (int)hw, s);
    else launch<float, 4>(x, alpha, shift, out, (int)planes, (int)hw, s);
  } else {
    if (vec == 1) launch<__nv_bfloat16, 1>(x, alpha, shift, out, (int)planes, (int)hw, s);
    else launch<__nv_bfloat16, 8>(x, alpha, shift, out, (int)planes, (int)hw, s);
  }
  return (int)cudaGetLastError();
}
