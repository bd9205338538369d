// Nearest resize of an NCHW-contiguous map, forward and backward.
//
// Replaces the TPU kernel mrfp_tpu/ops/pallas_resize.py::resize_nearest_fused
// and its custom VJP _rn_bwd. The TPU kernel mixes each (W, C) row with a
// one-hot matrix on the MXU and picks the H source through scalar-prefetched
// index maps; its backward multiplies by the transposed one-hot matrix over
// a weighted inverse of the H table. On Hopper a one-hot product would spend
// W times the work the copy needs, so both directions index directly:
//
//   forward   out[p, oy, ox] = x[p, iy[oy], ix[ox]]
//   backward  gx[p, h, w]    = sum over oy in [ly[h], hy[h]), ox in [lx[w], hx[w])
//                              of g[p, oy, ox]
//
// The host builds the tables in float64 with torch's rules and caches them
// on the device. Both tables are monotone, so the outputs one input feeds
// form the contiguous range [lo, hi): the backward gathers each input
// element's sum from that range, in fp32, rounding once.
// No thread writes another's element, so there are no atomics and the result
// does not depend on scheduling (the TPU kernel is deterministic too). An
// empty range (a downsample drops rows) gives 0.
//
// What bounds it on Hopper: bytes moved, but only if every access moves 16
// bytes: a thread-per-element copy is bound by its 2-byte accesses, not by
// the bytes. The forward gives a block a band of whole output rows of one
// plane, so its output is one contiguous flat run. iy is monotone, so the
// band reads one contiguous run of input rows, [iy[first], iy[last]]; the
// block stages that run into shared memory with 16-byte loads (about one
// output row in six repeats the previous one at the OC branch's upsampling
// scales, and is read from shared memory again, not from device memory),
// and the ix table once. Consecutive threads then gather consecutive
// outputs from shared memory into a second buffer (no bank conflicts: a
// thread that built a whole 16-byte vector would read the ix table at a
// stride of 8 words, an 8-way conflict), which keeps the output's device
// address modulo 16; the band's run leaves in aligned 16-byte stores across
// row boundaries, its ragged head and tail element by element, so the odd
// widths 231, 277 and 321 store in vectors too. The host plans
// the band and the shared memory (ops/cuda_resize.py::nearest_fwd_plan;
// the launch checks them against fwd_layout). A shape whose ix table and
// one staged input row do not fit the budget (a 30,000-wide output) takes
// the direct kernel: one block per output row, a thread per element.
//
// The backward reads each cotangent element once (ranges are at most 2 long
// at the OC branch's scales) and writes each input element once, so 2-byte
// scalar accesses, not arithmetic, bound a thread-per-element design. This
// one moves both sides in 16-byte vectors. A block takes R consecutive rows
// of the flattened (planes x h) input. The output rows that feed them are
// one contiguous run of g: input row i of plane p reads rows
// p*oh + [ly[i], hy[i]), and since hy[i] == ly[i+1] and hy[h-1] == oh the
// runs of consecutive rows tile g, across plane boundaries too. So the block
// stages that run, at most R * max_run rows of g (max_run: the longest
// range of the H table), into shared memory with 16-byte loads; its threads
// compute consecutive input elements from shared memory (consecutive
// threads, consecutive elements: no bank conflicts) into a second buffer,
// which leaves in 16-byte stores. Neither side need start 16-byte aligned
// (widths 231, 277, 321 are odd): each buffer keeps its device address
// modulo 16, so the interior moves in vectors, and the ragged head and tail
// of the block's run go element by element. The sums keep the plain
// version's order: each row's sum first, then the rows, in fp32, rounded
// once. Every range of the OC branch's scales has at most two terms, so the
// staged kernel unrolls its sums to predicated code (instructions, not
// bytes, bounded loops with data-dependent trip counts). R comes from the
// wrapper (ops/cuda_resize.py): about 4096 input elements a block, within a
// shared-memory budget. A shape with a longer range, or whose single row
// does not fit, takes the direct kernel: one thread per input element,
// reading g from device memory, with loops of any length. Plane and element
// offsets are int64: the enc4 stage of the OC branch at batch 8, 768x768
// reads 302M elements.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// The direct forward: one block per output row, one thread per element.
template <typename T>
__global__ void resize_nearest_kernel(const T* __restrict__ x, T* __restrict__ out,
                                      const int* __restrict__ iy, const int* __restrict__ ix,
                                      int64_t rows, int h, int w, int oh, int ow) {
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int64_t plane = r / oh;
    const int oy = (int)(r - plane * oh);
    const T* src = x + (plane * h + __ldg(iy + oy)) * (int64_t)w;
    T* dst = out + r * (int64_t)ow;
    for (int ox = threadIdx.x; ox < ow; ox += blockDim.x) dst[ox] = src[__ldg(ix + ox)];
  }
}

constexpr int kFwdThreads = 256;

// Byte offsets of the staged forward's buffers in its dynamic shared memory
// (16-byte aligned where a vector touches them): the ix table (ow ints) at
// 0, the band's row offsets into the stage (band ints) at `row`, the staged
// run of input rows at `in`, the band's outputs at `out`, `end` the bytes a
// band of `band` rows staging `run` input elements needs. Each element
// buffer has room for one vector more than it holds, so that it keeps its
// device address modulo 16. The wrapper sizes the launch
// (ops/cuda_resize.py::nearest_fwd_smem_bytes, `end` at run = stage_rows *
// w); the launch checks it against this.
struct FwdLayout {
  int64_t row, in, out, end;
};

template <typename T>
__host__ __device__ inline FwdLayout fwd_layout(int ow, int band, int64_t run) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int64_t row = 4LL * ow;
  const int64_t in = (row + 4LL * band + 15) & ~15LL;
  const int64_t out = (in + (run + kVec - 1) * (int64_t)sizeof(T) + 15) & ~15LL;
  return {row, in, out, out + ((int64_t)band * ow + kVec - 1) * (int64_t)sizeof(T)};
}

// The staged forward: a block per band of `band` output rows of a plane.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
resize_nearest_staged_kernel(const T* __restrict__ x, T* __restrict__ out,
                             const int* __restrict__ iy, const int* __restrict__ ix,
                             int64_t blocks, int band, int stage_rows, int h, int w, int oh,
                             int ow) {
  constexpr int kVec = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout lay = fwd_layout<T>(ow, band, (int64_t)stage_rows * w);
  int* s_ix = reinterpret_cast<int*>(smem);
  int* s_row = reinterpret_cast<int*>(smem + lay.row);  // per band row: its first in s_in
  T* s_in = reinterpret_cast<T*>(smem + lay.in);
  T* s_out = reinterpret_cast<T*>(smem + lay.out);
  for (int i = threadIdx.x; i < ow; i += kFwdThreads) s_ix[i] = __ldg(ix + i);
  const int bands = (oh + band - 1) / band;
  for (int64_t blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const int64_t plane = blk / bands;
    const int oy0 = (int)(blk - plane * bands) * band;
    const int nrows = min(band, oh - oy0);
    const int in0 = __ldg(iy + oy0);
    const int rows = __ldg(iy + oy0 + nrows - 1) - in0 + 1;
    if (rows > stage_rows) __trap();  // the plan sizes the stage for every band

    // s_in[j + shift] = src[j]: s_in keeps src's address modulo 16
    const T* src = x + (plane * h + in0) * (int64_t)w;
    const int span = rows * w;
    const int shift = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
    for (int i = threadIdx.x; i < nrows; i += kFwdThreads)
      s_row[i] = shift + (__ldg(iy + oy0 + i) - in0) * w;
    const int nvec = (shift + span + kVec - 1) / kVec;
    for (int v = threadIdx.x; v < nvec; v += kFwdThreads) {
      const int j0 = v * kVec - shift;
      if (j0 >= 0 && j0 + kVec <= span) {
        *reinterpret_cast<uint4*>(s_in + v * kVec) =
            __ldg(reinterpret_cast<const uint4*>(src + j0));
      } else {
        for (int j = max(j0, 0); j < min(j0 + kVec, span); ++j) s_in[j + shift] = src[j];
      }
    }
    __syncthreads();

    // the band's outputs, one flat run of m values: consecutive threads take
    // consecutive outputs (distinct banks of s_ix, s_out), into s_out, which
    // keeps dst's address modulo 16
    T* dst = out + (plane * oh + oy0) * (int64_t)ow;
    const int m = nrows * ow;
    const int dshift = (int)((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(T));
    const int step_rows = kFwdThreads / ow, step_cols = kFwdThreads - step_rows * ow;
    int i = threadIdx.x / ow, c = threadIdx.x - i * ow;
    for (int e = threadIdx.x; e < m; e += kFwdThreads) {
      s_out[e + dshift] = s_in[s_row[i] + s_ix[c]];
      i += step_rows;
      c += step_cols;
      if (c >= ow) {
        c -= ow;
        ++i;
      }
    }
    __syncthreads();

    // the run leaves in aligned 16-byte stores, its ragged ends value by value
    const int nout = (dshift + m + kVec - 1) / kVec;
    for (int v = threadIdx.x; v < nout; v += kFwdThreads) {
      const int e0 = v * kVec - dshift;
      if (e0 >= 0 && e0 + kVec <= m) {
        __stcs(reinterpret_cast<uint4*>(dst + e0),
               *reinterpret_cast<const uint4*>(s_out + v * kVec));
      } else {
        for (int e = max(e0, 0); e < min(e0 + kVec, m); ++e) dst[e] = s_out[e + dshift];
      }
    }
    __syncthreads();  // the next band of this block restages
  }
}

// The direct backward: one thread per input element, g read from device
// memory. Shapes with a range longer than two, or a staged run too large.
template <typename T>
__global__ void resize_nearest_bwd_kernel(const T* __restrict__ g, T* __restrict__ gx,
                                          const int* __restrict__ ly, const int* __restrict__ hy,
                                          const int* __restrict__ lx, const int* __restrict__ hx,
                                          int64_t rows, int h, int w, int oh, int ow) {
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int64_t plane = r / h;
    const int y = (int)(r - plane * h);
    const int y0 = __ldg(ly + y), y1 = __ldg(hy + y);
    const T* src = g + plane * (int64_t)oh * ow;
    T* dst = gx + r * (int64_t)w;
    for (int xi = threadIdx.x; xi < w; xi += blockDim.x) {
      const int x0 = __ldg(lx + xi), x1 = __ldg(hx + xi);
      float acc = 0.f;
      for (int oy = y0; oy < y1; ++oy) {
        // the row's sum first, then the rows: the plain version's order
        const T* row = src + (int64_t)oy * ow;
        float rs = 0.f;
        for (int ox = x0; ox < x1; ++ox) rs += to_f32(row[ox]);
        acc += rs;
      }
      dst[xi] = from_f32<T>(acc);
    }
  }
}

constexpr int kBwdThreads = 256;

// Byte offsets of the staged backward's buffers in its dynamic shared memory
// (16-byte aligned): the column table (w int2) and the row table (R int2) at
// 0, the block's R*w input elements at `out`, the staged run of g at `g`,
// `end` the bytes a run of `run` elements needs. Each element buffer has
// room for one vector more than it holds, so that it keeps its device
// address modulo 16 (the shifts below). The wrapper sizes R and the launch's
// bytes (ops/cuda_resize.py::nearest_bwd_smem_bytes, an upper bound of
// `end` at run = R * max_run * ow); the launch checks them against this.
struct BwdLayout {
  int64_t out, g, end;
};

template <typename T>
__host__ __device__ inline BwdLayout bwd_layout(int w, int rows, int64_t run) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int64_t out = (8LL * (w + rows) + 15) & ~15LL;
  const int64_t g = out + (((int64_t)rows * w + 2 * kVec - 1) / kVec) * 16;
  return {out, g, g + (run + kVec - 1) * (int64_t)sizeof(T)};
}

// The staged backward: every range of both tables at most two long (the OC
// branch's scales), so each sum unrolls to predicated code.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
resize_nearest_bwd_staged_kernel(const T* __restrict__ g, T* __restrict__ gx,
                                 const int* __restrict__ ly, const int* __restrict__ hy,
                                 const int* __restrict__ lx, const int* __restrict__ hx,
                                 int64_t rows, int rows_per_block, int h, int w, int oh,
                                 int ow) {
  constexpr int kVec = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout lay = bwd_layout<T>(w, rows_per_block, 0);
  int2* s_col = reinterpret_cast<int2*>(smem);  // per column: lx, hx - lx
  int2* s_row = s_col + w;  // per block row: its first g element in s_g, its g rows
  T* s_out = reinterpret_cast<T*>(smem + lay.out);
  T* s_g = reinterpret_cast<T*>(smem + lay.g);

  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int nrows = (int)min((int64_t)rows_per_block, rows - r0);
  // the block's run of g rows: [G0, G1) of the flattened (planes x oh) rows
  const int64_t p0 = r0 / h, pl = (r0 + nrows - 1) / h;
  const int h0 = (int)(r0 - p0 * h), hl = (int)(r0 + nrows - 1 - pl * h);
  const int64_t g0 = p0 * oh + __ldg(ly + h0);
  const int span = (int)((pl * oh + __ldg(hy + hl) - g0) * ow);
  const T* src = g + g0 * ow;
  // s_g[j + shift] = src[j]: s_g keeps src's address modulo 16
  const int shift = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));

  for (int i = threadIdx.x; i < w; i += kBwdThreads) {
    const int x0 = __ldg(lx + i);
    s_col[i] = make_int2(x0, __ldg(hx + i) - x0);
  }
  for (int i = threadIdx.x; i < nrows; i += kBwdThreads) {
    const int64_t r = r0 + i, p = r / h;
    const int y = (int)(r - p * h), y0 = __ldg(ly + y);
    s_row[i] = make_int2((int)((p * oh + y0 - g0) * ow) + shift, __ldg(hy + y) - y0);
  }
  const int nvec = (shift + span + kVec - 1) / kVec;
  for (int v = threadIdx.x; v < nvec; v += kBwdThreads) {
    const int j0 = v * kVec - shift;
    if (j0 >= 0 && j0 + kVec <= span) {
      *reinterpret_cast<uint4*>(s_g + v * kVec) = __ldg(reinterpret_cast<const uint4*>(src + j0));
    } else {
      for (int j = max(j0, 0); j < min(j0 + kVec, span); ++j) s_g[j + shift] = src[j];
    }
  }
  __syncthreads();

  // consecutive threads take consecutive input elements, so their reads of
  // the tables and of s_g fall in distinct banks; s_out keeps dst's address
  // modulo 16, so the block's run leaves in 16-byte stores
  T* dst = gx + r0 * w;
  const int m = nrows * w;
  const int dshift = (int)((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(T));
  const int step_rows = kBwdThreads / w, step_cols = kBwdThreads - step_rows * w;
  int i = threadIdx.x / w, c = threadIdx.x - i * w;
  for (int e = threadIdx.x; e < m; e += kBwdThreads) {
    // col = (first g column, count), row = (first g element in s_g, count)
    const int2 col = s_col[c], row = s_row[i];
    const T* p = s_g + row.x + col.x;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k < row.y) {
        float rs = 0.f;  // the row's sum first, then the rows: the plain version's order
        if (col.y > 0) rs += to_f32(p[k * ow]);
        if (col.y > 1) rs += to_f32(p[k * ow + 1]);
        acc += rs;
      }
    }
    s_out[e + dshift] = from_f32<T>(acc);
    i += step_rows;
    c += step_cols;
    if (c >= w) {
      c -= w;
      ++i;
    }
  }
  __syncthreads();
  const int nout = (dshift + m + kVec - 1) / kVec;
  for (int v = threadIdx.x; v < nout; v += kBwdThreads) {
    const int e0 = v * kVec - dshift;
    if (e0 >= 0 && e0 + kVec <= m) {
      *reinterpret_cast<uint4*>(dst + e0) = *reinterpret_cast<const uint4*>(s_out + v * kVec);
    } else {
      for (int e = max(e0, 0); e < min(e0 + kVec, m); ++e) dst[e] = s_out[e + dshift];
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, void* out, const int* iy, const int* ix, int64_t nc,
                       int h, int w, int oh, int ow, int band, int stage_rows, int64_t smem,
                       cudaStream_t s) {
  if (band <= 0) {  // the direct kernel
    const int64_t rows = nc * oh;
    resize_nearest_kernel<T><<<grid_for(rows, 1, 64), kThreads, 0, s>>>(
        (const T*)x, (T*)out, iy, ix, rows, h, w, oh, ow);
    return cudaSuccess;
  }
  // the staged kernel takes a plan whose stage holds its rows, in the bytes
  // it is given, within the 48 KB a launch takes without opting in
  if (stage_rows < 1 || smem < fwd_layout<T>(ow, band, (int64_t)stage_rows * w).end ||
      smem > 48 * 1024)
    return cudaErrorInvalidValue;
  const int64_t blocks = nc * ((oh + band - 1) / band);
  const int64_t grid = blocks < INT32_MAX ? blocks : INT32_MAX;
  resize_nearest_staged_kernel<T><<<(unsigned)grid, kFwdThreads, (size_t)smem, s>>>(
      (const T*)x, (T*)out, iy, ix, blocks, band, stage_rows, h, w, oh, ow);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_bwd(const void* g, void* gx, const int* ly, const int* hy, const int* lx,
                       const int* hx, int64_t rows, int h, int w, int oh, int ow,
                       int rows_per_block, int max_run_y, int max_run_x, int64_t smem,
                       cudaStream_t s) {
  if (rows_per_block <= 0) {  // the direct kernel
    resize_nearest_bwd_kernel<T><<<grid_for(rows, 1, 64), kThreads, 0, s>>>(
        (const T*)g, (T*)gx, ly, hy, lx, hx, rows, h, w, oh, ow);
    return cudaSuccess;
  }
  // the staged kernel sums at most two terms per axis, in the bytes it is given
  if (max_run_y > 2 || max_run_x > 2 ||
      smem < bwd_layout<T>(w, rows_per_block, (int64_t)rows_per_block * max_run_y * ow).end)
    return cudaErrorInvalidValue;
  static int64_t allowed = 48 * 1024;  // dynamic shared memory the kernel may take
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        resize_nearest_bwd_staged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  resize_nearest_bwd_staged_kernel<T><<<(unsigned)blocks, kBwdThreads, (size_t)smem, s>>>(
      (const T*)g, (T*)gx, ly, hy, lx, hx, rows, rows_per_block, h, w, oh, ow);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a plan the kernel does not take.
//
// band: output rows a block of the staged forward takes (0: the direct
// kernel); stage_rows: input rows its stage holds; smem: its dynamic shared
// memory in bytes (ops/cuda_resize.py::nearest_fwd_plan).
extern "C" int mrfp_resize_nearest(const void* x, void* out, const void* iy, const void* ix,
                                   int64_t nc, int h, int w, int oh, int ow, int band,
                                   int stage_rows, int64_t smem, int dtype, void* stream) {
  if (nc * oh == 0 || ow == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0) {
    err = launch_fwd<float>(x, out, (const int*)iy, (const int*)ix, nc, h, w, oh, ow, band,
                            stage_rows, smem, s);
  } else if (dtype == 1) {
    err = launch_fwd<__nv_bfloat16>(x, out, (const int*)iy, (const int*)ix, nc, h, w, oh, ow,
                                    band, stage_rows, smem, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// rows_per_block: input rows a block of the staged kernel takes (0: the
// direct kernel); max_run_y, max_run_x: the longest [lo, hi) range of the H
// and W tables (the staged kernel takes at most 2); smem: the staged
// kernel's dynamic shared memory in bytes.
extern "C" int mrfp_resize_nearest_bwd(const void* g, void* gx, const void* ly, const void* hy,
                                       const void* lx, const void* hx, int64_t nc, int h,
                                       int w, int oh, int ow, int rows_per_block, int max_run_y,
                                       int max_run_x, int64_t smem, int dtype, void* stream) {
  const int64_t rows = nc * h;
  if (rows == 0 || w == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int* y0 = (const int*)ly;
  const int* y1 = (const int*)hy;
  const int* x0 = (const int*)lx;
  const int* x1 = (const int*)hx;
  cudaError_t err;
  if (dtype == 0) {
    err = launch_bwd<float>(g, gx, y0, y1, x0, x1, rows, h, w, oh, ow, rows_per_block,
                            max_run_y, max_run_x, smem, s);
  } else if (dtype == 1) {
    err = launch_bwd<__nv_bfloat16>(g, gx, y0, y1, x0, x1, rows, h, w, oh, ow, rows_per_block,
                                    max_run_y, max_run_x, smem, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
