// Row mix of an NCHW-contiguous map along one spatial axis: out = P @ x along
// H (dim 2) or W (dim 3), for a general (out, in) fp32 matrix P:
//
//   dim 2   out[p, o, w] = sum over i of P[o, i] * x[p, i, w]
//   dim 3   out[p, h, o] = sum over i of P[o, i] * x[p, h, i]
//
// summed in fp32 and rounded once to x's dtype.
//
// Replaces the TPU kernel mrfp_tpu/ops/pallas_resize.py::row_mix_pallas
// (_mix_h_kernel, _mix_w_kernel), which take_rows calls with a one-hot P for
// its forward and with P transposed for its VJP. On the TPU the mix is one
// MXU matmul per tile, and a one-hot row costs as much as a dense one. Here
// a first small kernel compacts each row of P into the list of its non-zero
// weights and their columns, in column order (one warp per row, a ballot per
// 32 columns); the mix then gives each output element one thread, which sums
// weight * x over its row's list. A one-hot P costs one read per output
// instead of `in`, and with at most two non-zeros per row (the transposed
// one-hot of an upsample by < 2) the sum does not depend on order, so the
// result equals the dense product bit for bit. Skipping a zero weight
// differs from the dense product only where x holds an inf or a NaN.
//
// What bounds it on Hopper: bytes. For take_rows each output element is one
// read and one write. dim 2 gives each block one output row, so all its
// threads share one list, walk consecutive columns, and their loads and
// stores coalesce; dim 3 gives each block one input row, which its threads
// gather from.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void compact_rows_kernel(const float* __restrict__ p, int rows, int cols,
                                    int* __restrict__ idx, float* __restrict__ wt,
                                    int* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp leaves together
  const float* pr = p + (int64_t)r * cols;
  int* ir = idx + (int64_t)r * cols;
  float* wr = wt + (int64_t)r * cols;
  int base = 0;
  for (int c0 = 0; c0 < cols; c0 += 32) {
    const int c = c0 + lane;
    const float v = c < cols ? pr[c] : 0.f;
    const bool keep = v != 0.f;  // true for NaN: it propagates as in the product
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int pos = base + __popc(mask & ((1u << lane) - 1u));
      ir[pos] = c;
      wr[pos] = v;
    }
    base += __popc(mask);
  }
  if (lane == 0) cnt[r] = base;
}

template <typename T>
__global__ void mix_h_kernel(const T* __restrict__ x, T* __restrict__ out,
                             const int* __restrict__ idx, const float* __restrict__ wt,
                             const int* __restrict__ cnt, int64_t rows, int in, int on, int w) {
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int64_t plane = r / on;
    const int o = (int)(r - plane * on);
    const int nnz = __ldg(cnt + o);
    const int* ir = idx + (int64_t)o * in;
    const float* wr = wt + (int64_t)o * in;
    const T* src = x + plane * in * (int64_t)w;
    T* dst = out + r * (int64_t)w;
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
      float acc = 0.f;
      for (int t = 0; t < nnz; ++t)
        acc = fmaf(__ldg(wr + t), to_f32(src[(int64_t)__ldg(ir + t) * w + c]), acc);
      dst[c] = from_f32<T>(acc);
    }
  }
}

template <typename T>
__global__ void mix_w_kernel(const T* __restrict__ x, T* __restrict__ out,
                             const int* __restrict__ idx, const float* __restrict__ wt,
                             const int* __restrict__ cnt, int64_t rows, int in, int on) {
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* src = x + r * (int64_t)in;
    T* dst = out + r * (int64_t)on;
    for (int o = threadIdx.x; o < on; o += blockDim.x) {
      const int nnz = __ldg(cnt + o);
      const int* ir = idx + (int64_t)o * in;
      const float* wr = wt + (int64_t)o * in;
      float acc = 0.f;
      for (int t = 0; t < nnz; ++t) acc = fmaf(__ldg(wr + t), to_f32(src[__ldg(ir + t)]), acc);
      dst[o] = from_f32<T>(acc);
    }
  }
}

template <typename T>
void launch_mix(const void* x, void* out, const int* idx, const float* wt, const int* cnt,
                int64_t planes, int h, int w, int on, int dim, cudaStream_t s) {
  if (dim == 2) {
    const int64_t rows = planes * on;
    mix_h_kernel<T><<<grid_for(rows, 1, 64), kThreads, 0, s>>>(
        (const T*)x, (T*)out, idx, wt, cnt, rows, h, on, w);
  } else {
    const int64_t rows = planes * h;
    mix_w_kernel<T><<<grid_for(rows, 1, 64), kThreads, 0, s>>>(
        (const T*)x, (T*)out, idx, wt, cnt, rows, w, on);
  }
}

}  // namespace

// x (planes, h, w) of `dtype` (0 = float32, 1 = bfloat16); p (on, in) fp32
// with in = h for dim 2 and w for dim 3; out (planes, on, w) or
// (planes, h, on); scratch idx (on, in) int32, wt (on, in) fp32, cnt (on,)
// int32. Returns cudaGetLastError() after the launches.
extern "C" int mrfp_row_mix(const void* x, const void* p, void* out, void* idx, void* wt,
                            void* cnt, int64_t planes, int h, int w, int on, int dim, int dtype,
                            void* stream) {
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (on == 0 || planes == 0 || (dim == 2 ? w : h) == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int in = dim == 2 ? h : w;
  compact_rows_kernel<<<(on + 3) / 4, 128, 0, s>>>((const float*)p, on, in, (int*)idx,
                                                   (float*)wt, (int*)cnt);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) {
    launch_mix<float>(x, out, (const int*)idx, (const float*)wt, (const int*)cnt, planes, h, w,
                      on, dim, s);
  } else {
    launch_mix<__nv_bfloat16>(x, out, (const int*)idx, (const float*)wt, (const int*)cnt,
                              planes, h, w, on, dim, s);
  }
  return (int)cudaGetLastError();
}
