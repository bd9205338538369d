// Bilinear align_corners=True resize of an NCHW-contiguous map, forward only.
//
// Replaces the TPU kernel mrfp_tpu/ops/pallas_resize.py::resize_bilinear_fused
// (the two-tap instance of _taps_mix): one output element is
//
//   out = (1-fy) * ((1-fx) * x[i0y, i0x] + fx * x[i0y, i1x])
//       +    fy  * ((1-fx) * x[i1y, i0x] + fx * x[i1y, i1x])
//
// in fp32, W-mix first and then the H taps (the TPU kernel's order), rounded
// once to the output dtype. The per-axis tap tables (i0, i1, frac) come from
// the host, computed with the repo's float64 rule and cached on the device.
//
// What bounds it on Hopper: bytes written. Every resize on the eval path is
// an upsample (1x1 -> 64x128, 64x128 -> 256x512, 256x512 -> 1024x2048), so
// each output element costs one store but the four reads it makes hit the
// same few input rows as its neighbours': distinct input bytes are at most a
// quarter of the output bytes, and the neighbouring reads come from L1/L2.
// The design follows: one thread per output element, consecutive threads on
// consecutive output columns so the stores coalesce, a grid-stride loop with
// int64 offsets (the logit upsample writes 40M elements), and no shared
// memory. Vector stores, TMA and a channels_last variant are later work.

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

template <typename T>
__global__ void resize_bilinear_kernel(const T* __restrict__ x, T* __restrict__ out,
                                       const int* __restrict__ iy0, const int* __restrict__ iy1,
                                       const float* __restrict__ fy,
                                       const int* __restrict__ ix0, const int* __restrict__ ix1,
                                       const float* __restrict__ fx,
                                       int64_t nc, int h, int w, int oh, int ow) {
  const int64_t total = nc * oh * ow;
  const int64_t in_plane = (int64_t)h * w;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int ox = (int)(idx % ow);
    const int64_t rest = idx / ow;
    const int oy = (int)(rest % oh);
    const int64_t plane = rest / oh;
    const T* src = x + plane * in_plane;
    const int64_t r0 = (int64_t)__ldg(iy0 + oy) * w;
    const int64_t r1 = (int64_t)__ldg(iy1 + oy) * w;
    const int c0 = __ldg(ix0 + ox);
    const int c1 = __ldg(ix1 + ox);
    const float wx = __ldg(fx + ox);
    const float wy = __ldg(fy + oy);
    const float top = (1.f - wx) * to_f32(src[r0 + c0]) + wx * to_f32(src[r0 + c1]);
    const float bot = (1.f - wx) * to_f32(src[r1 + c0]) + wx * to_f32(src[r1 + c1]);
    out[idx] = from_f32<T>((1.f - wy) * top + wy * bot);
  }
}

int grid_for(int64_t total, int threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int64_t want = (total + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * 8;  // 8 blocks of 256 fill an SM's 2048 threads
  return (int)(want < cap ? want : cap);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int mrfp_resize_bilinear(const void* x, void* out, const void* iy0, const void* iy1,
                                    const void* fy, const void* ix0, const void* ix1,
                                    const void* fx, int64_t nc, int h, int w, int oh, int ow,
                                    int dtype, void* stream) {
  const int64_t total = nc * oh * ow;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int blocks = grid_for(total, threads);
  cudaStream_t s = (cudaStream_t)stream;
  const int* y0 = (const int*)iy0;
  const int* y1 = (const int*)iy1;
  const int* x0 = (const int*)ix0;
  const int* x1 = (const int*)ix1;
  const float* wy = (const float*)fy;
  const float* wx = (const float*)fx;
  if (dtype == 0) {
    resize_bilinear_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)x, (float*)out, y0, y1, wy, x0, x1, wx, nc, h, w, oh, ow);
  } else if (dtype == 1) {
    resize_bilinear_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, y0, y1, wy, x0, x1, wx, nc, h, w, oh, ow);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
