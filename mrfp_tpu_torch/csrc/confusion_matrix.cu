// C x C int32 confusion matrix (rows = label, cols = pred), accumulated into
// a caller-held histogram.
//
// Replaces the TPU kernel mrfp_tpu/ops/pallas_hist.py::confusion_matrix_pallas,
// which builds one-hot matrices and sums onehot(label)^T @ onehot(pred) on
// the MXU. A pixel counts only when both its label and its pred lie in
// [0, C): the Pallas kernel zeroes invalid labels' one-hot rows and its
// padded lanes drop out-of-range preds.
//
// What bounds it on Hopper: the 8 bytes read per pixel and, behind them, the
// atomic traffic on C*C bins (361 for Cityscapes). One-hot matmuls would
// spend C times more work than the count needs, so the design counts
// directly: each block keeps a private histogram in shared memory (1.4 KB at
// C = 19, 64 KB at the C = 128 limit), walks pixels with a grid-stride loop
// adding with shared-memory atomics, then flushes its non-zero bins to the
// global histogram with one global atomic each. Integer atomics make the
// result exact and independent of order.

#include "common.cuh"

namespace {

__global__ void confusion_matrix_kernel(const int* __restrict__ pred,
                                        const int* __restrict__ label, int64_t n,
                                        int num_classes, int* __restrict__ hist) {
  extern __shared__ int bins[];
  const int nbins = num_classes * num_classes;
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const unsigned l = (unsigned)__ldg(label + i);
    const unsigned p = (unsigned)__ldg(pred + i);
    if (l < (unsigned)num_classes && p < (unsigned)num_classes) {
      atomicAdd(&bins[l * num_classes + p], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    const int v = bins[b];
    if (v != 0) atomicAdd(&hist[b], v);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (or the attribute call's error).
extern "C" int mrfp_confusion_matrix(const void* pred, const void* label, int64_t n,
                                     int num_classes, void* hist, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)num_classes * num_classes * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(confusion_matrix_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  const int blocks = grid_for(n, threads, 4);  // each block flushes C*C bins once
  confusion_matrix_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)pred, (const int*)label, n, num_classes, (int*)hist);
  return (int)cudaGetLastError();
}
