// C x C int32 confusion matrix (rows = label, cols = pred), accumulated into
// a caller-held histogram.
//
// Replaces the TPU kernel mrfp_tpu/ops/pallas_hist.py::confusion_matrix_pallas,
// which builds one-hot matrices and sums onehot(label)^T @ onehot(pred) on
// the MXU. A pixel counts only when both its label and its pred lie in
// [0, C): the Pallas kernel zeroes invalid labels' one-hot rows and its
// padded lanes drop out-of-range preds. Here each value is compared in its
// own width, so an int64 pred that int32 would wrap into [0, C) is dropped.
//
// What bounds it on Hopper: the bytes read per pixel (9 on the eval path:
// an int64 argmax and a uint8 label, read as they are, with no cast pass)
// and, behind them, the atomic traffic on C*C bins (361 for Cityscapes).
// One-hot matmuls would spend C times more work than the count needs, so
// the design counts directly. Each thread takes runs of 16 consecutive
// pixels, loaded as 16-byte vectors (16 uint8 labels in one load, 16 int64
// preds in eight) where both pointers are 16-byte aligned, value by value
// otherwise. On a real label map neighbouring pixels almost always share one
// (label, pred) pair, so counts are aggregated before they reach memory: a
// thread counts a run of equal bins in a register, adding only where the bin
// changes, and its last run goes through the warp, whose lanes holding the
// same bin combine (__match_any_sync, then __reduce_add_sync over those
// lanes) into one shared-memory atomic. A run of one class thus costs one
// atomic for the warp's 512 pixels, not 512. Each block keeps a private
// histogram in shared memory (1.4 KB at C = 19, 64 KB at the C = 128 limit);
// two blocks an SM walk the pixels in a grid-stride loop, then each flushes
// its non-zero bins with one global atomic each. (A (blocks, C*C) scratch
// summed in block order by a second pass was measured too: on an H100 its
// second launch costs more than the atomics it saves; PERF.md.) Integer
// counts make the result exact and independent of order.

#include "common.cuh"

namespace {

constexpr int kHistThreads = 512;
constexpr int kRun = 16;  // consecutive pixels a thread takes per step

// Value j of 16 values of V held in sizeof(V) 16-byte words.
template <typename V>
__device__ __forceinline__ V value_at(const uint4* raw, int j);
template <>
__device__ __forceinline__ unsigned char value_at<unsigned char>(const uint4* raw, int j) {
  return (unsigned char)(word_of(raw[j >> 4], (j >> 2) & 3) >> (8 * (j & 3)));
}
template <>
__device__ __forceinline__ int value_at<int>(const uint4* raw, int j) {
  return (int)word_of(raw[j >> 2], j & 3);
}
template <>
__device__ __forceinline__ long long value_at<long long>(const uint4* raw, int j) {
  const uint4& q = raw[j >> 1];
  const unsigned long long lo = word_of(q, (j & 1) * 2), hi = word_of(q, (j & 1) * 2 + 1);
  return (long long)((hi << 32) | lo);
}

// Whether v lies in [0, c), compared in v's own width.
__device__ __forceinline__ bool in_classes(unsigned char v, int c) { return v < c; }
__device__ __forceinline__ bool in_classes(int v, int c) { return v >= 0 && v < c; }
__device__ __forceinline__ bool in_classes(long long v, int c) { return v >= 0 && v < c; }

// The kRun values of v at [first, first + kRun), 16-byte loads on the vector
// route (the caller guarantees the whole run lies before n there).
template <typename V, bool VEC>
__device__ __forceinline__ void load_run(const V* __restrict__ v, int64_t first, int len,
                                         V (&out)[kRun]) {
  if (VEC && len == kRun) {
    uint4 raw[sizeof(V)];
    const uint4* src = reinterpret_cast<const uint4*>(v + first);
#pragma unroll
    for (int q = 0; q < (int)sizeof(V); ++q) raw[q] = __ldg(src + q);
#pragma unroll
    for (int j = 0; j < kRun; ++j) out[j] = value_at<V>(raw, j);
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) out[j] = j < len ? __ldg(v + first + j) : V(0);
  }
}

template <typename P, typename L, bool VEC>
__global__ void __launch_bounds__(kHistThreads)
confusion_matrix_kernel(const P* __restrict__ pred, const L* __restrict__ label, int64_t n,
                        int num_classes, int* __restrict__ hist) {
  extern __shared__ int bins[];
  const int nbins = num_classes * num_classes;
  for (int b = threadIdx.x; b < nbins; b += kHistThreads) bins[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t runs = (n + kRun - 1) / kRun;
  const int64_t stride = (int64_t)gridDim.x * kHistThreads;
  // r0, the warp's first run, keeps the loop uniform across the warp
  for (int64_t r0 = (int64_t)blockIdx.x * kHistThreads + (threadIdx.x & ~31); r0 < runs;
       r0 += stride) {
    const int64_t r = r0 + lane;
    int cur = -1;  // the bin of the thread's current run (-1: dropped pixels)
    unsigned cnt = 0;
    if (r < runs) {
      const int64_t first = r * kRun;
      const int len = (int)min((int64_t)kRun, n - first);
      P p[kRun];
      L l[kRun];
      load_run<P, VEC>(pred, first, len, p);
      load_run<L, VEC>(label, first, len, l);
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int b = j < len && in_classes(l[j], num_classes) && in_classes(p[j], num_classes)
                          ? (int)l[j] * num_classes + (int)p[j]
                          : -1;
        if (b != cur) {
          if (cur >= 0) atomicAdd(&bins[cur], (int)cnt);
          cur = b;
          cnt = 0;
        }
        ++cnt;
      }
    }
    // the last runs of the warp's lanes: one atomic per distinct bin
    const unsigned peers = __match_any_sync(0xffffffffu, cur);
    const unsigned total = __reduce_add_sync(peers, cnt);
    if (cur >= 0 && lane == __ffs(peers) - 1) atomicAdd(&bins[cur], (int)total);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += kHistThreads) {
    const int v = bins[b];
    if (v != 0) atomicAdd(&hist[b], v);
  }
}

template <typename P, typename L, bool VEC>
int launch(const void* pred, const void* label, int64_t n, int num_classes, int* hist,
           cudaStream_t s) {
  auto kernel = confusion_matrix_kernel<P, L, VEC>;
  const size_t smem = (size_t)num_classes * num_classes * sizeof(int);
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const int blocks = grid_for((n + kRun - 1) / kRun, kHistThreads, 2);
  kernel<<<blocks, kHistThreads, smem, s>>>((const P*)pred, (const L*)label, n, num_classes,
                                            hist);
  return (int)cudaGetLastError();
}

template <typename P, typename L>
int launch_vec(const void* pred, const void* label, int64_t n, int num_classes, int vec,
               int* hist, cudaStream_t s) {
  return vec ? launch<P, L, true>(pred, label, n, num_classes, hist, s)
             : launch<P, L, false>(pred, label, n, num_classes, hist, s);
}

template <typename P>
int launch_label(const void* pred, const void* label, int label_dtype, int64_t n,
                 int num_classes, int vec, int* hist, cudaStream_t s) {
  switch (label_dtype) {
    case 0: return launch_vec<P, unsigned char>(pred, label, n, num_classes, vec, hist, s);
    case 1: return launch_vec<P, int>(pred, label, n, num_classes, vec, hist, s);
    case 2: return launch_vec<P, long long>(pred, label, n, num_classes, vec, hist, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// pred_dtype: 0 = int32, 1 = int64; label_dtype: 0 = uint8, 1 = int32, 2 =
// int64; vec: 1 for 16-byte loads (both pointers 16-byte aligned). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int mrfp_confusion_matrix(const void* pred, const void* label, int64_t n,
                                     int num_classes, int pred_dtype, int label_dtype, int vec,
                                     void* hist, void* stream) {
  if (num_classes < 1 || num_classes > 128) return (int)cudaErrorInvalidValue;
  if (vec && ((reinterpret_cast<uintptr_t>(pred) & 15) || (reinterpret_cast<uintptr_t>(label) & 15)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pred_dtype) {
    case 0:
      return launch_label<int>(pred, label, label_dtype, n, num_classes, vec, (int*)hist, s);
    case 1:
      return launch_label<long long>(pred, label, label_dtype, n, num_classes, vec,
                                     (int*)hist, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
