// Bilinear align_corners=True resize of an NCHW-contiguous map, forward and
// backward.
//
// Replaces the TPU kernel mrfp_tpu/ops/pallas_resize.py::resize_bilinear_fused
// (the two-tap instance of _taps_mix) and its custom VJP _rb_bwd. One output
// element of the forward is
//
//   out = (1-fy) * ((1-fx) * x[i0y, i0x] + fx * x[i0y, i1x])
//       +    fy  * ((1-fx) * x[i1y, i0x] + fx * x[i1y, i1x])
//
// in fp32, W-mix first and then the H taps (the TPU kernel's order), rounded
// once to the output dtype. The backward is its transpose:
//
//   gx[p, h, w] = sum over taps ty, oy in R_ty(h), taps tx, ox in R_tx(w)
//                 of wy(ty, oy) * wx(tx, ox) * g[p, oy, ox]
//
// where R_t(i) = [lo_t[i], hi_t[i]) is the range of outputs whose tap t reads
// input i: both tap tables are monotone, so the host turns each into these
// ranges once and caches them on the device. The TPU's backward multiplies
// the cotangent by the transposed dense W matrix and a weighted inverse of
// the H taps; here each input element gathers its own sum, in fp32, rounded
// once. No thread writes another's element, so there are no atomics and the
// result does not depend on scheduling.
//
// What bounds it on Hopper. Forward: bytes written. Every resize of the
// model is an upsample (ASPP broadcast 1x1 -> H/16, decoder H/16 -> H/4,
// logits H/4 or H/2 -> H), so each output element costs one store and the
// reads are a fraction of it. One block takes a band of output rows of one
// plane (and a tile of its columns, where a row is too wide for shared
// memory): the plane, the band and the tile come from blockIdx, once per
// block. It copies the input segments the band reads into shared memory as
// 16-byte granules (independent loads: one round trip to memory), W-mixes
// each staged row once, in fp32, then writes each output row as the H lerp
// of its two W-mixed rows, consecutive threads on consecutive 16-byte
// stores (8 bf16 or 4 fp32). The host plans the band height, the staged
// rows and columns and the shared memory (cuda_resize.bilinear_fwd_plan),
// and picks the scalar route (one value a store) for widths that are not a
// whole number of vectors or an unaligned output. Each product and sum is
// rounded in fp32 as the plain version's tensor ops round them (no FMA
// contraction, 1 - frac rounded), so the two agree bit for bit. On an H100
// the bf16 train resizes run at about 60% of the bytes' bound: per output,
// the instructions of the two mixes and the barriers between the phases of
// a band, not the bytes, hold it there (PERF.md).
//
// Backward: bytes read. An upsample's cotangent is the large tensor, and
// each input element sums a (2r x 2r) patch of it for an upsample by r.
// Read straight from device memory by one thread an element, the
// overlapping patches ran at a fraction of the bytes' rate. So a block
// takes a band of input rows of one plane (and a tile of its columns where
// a row is too wide) and mixes the H taps first: each (input row,
// cotangent granule) sums its H taps with 16-byte loads from device memory
// (8 bf16 or 4 fp32 values; where ow is not a whole number of granules, one
// value a load), into an fp32 stage in shared memory; then each input
// element sums its W taps from the stage. H first, because the H taps take
// whole rows, which load as vectors, and because the irregular W taps then
// run over the H-mixed rows (h of them) instead of the cotangent's (oh). A
// first design that mixed W first, over the cotangent rows staged in shared
// memory (the order of the direct kernel), spent most of its time in that
// W-mix and took more than twice this design's time over the five bf16
// train resizes on an H100 (PERF.md). Each sum is in fp32, tap 0 before
// tap 1 on each axis, rounded once; the plain version adds in another
// order, so the two agree within a bound, not bit for bit. The host plans
// the band, the tile and the stage (cuda_resize.bilinear_bwd_plan); the C
// entry refuses a plan that does not fit its layout.
//
// An input axis of size 1 (the ASPP image-pool broadcast, 1x1) reads every
// output: there each output's first tap has weight 1 and its second weight
// 0, so an input element is the plain sum of its cotangent plane. That is
// a reduction: a warp per plane, 16-byte loads, a fixed-order tree of warp
// shuffles (no atomics: the result does not depend on scheduling). The
// second taps' zero terms are not added, which differs from the plain
// version only where the cotangent holds an inf or a NaN.
//
// A shape whose band of one input row by one input column does not fit the
// budget (an upsample by thousands, as a 4-wide input to 30,000 columns)
// takes the direct kernel: one block per input row, threads on its columns,
// each summing its patch from device memory.

#include "common.cuh"

namespace {

constexpr int kBandThreads = 256;
constexpr int kBandSmemCap = 48 * 1024;  // no opt-in needed; four blocks an SM

// The banded forward's launch, planned on the host: output rows a band
// takes and input rows the stage holds; output columns a tile takes, the
// input columns it reads at most and the 16-byte granules a staged raw row
// keeps; the bands a plane and the tiles a row are cut into.
struct BandPlan {
  int band;
  int stage_rows;
  int cols;
  int in_cols;
  int raw_pitch;
  int bands;
  int tiles;
};

__device__ __forceinline__ void unpack(const float4& f, float* v) {
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// Where staged column c lies in its fp32 row of `cols` values. At VEC = 8
// a row keeps the first four values of every group of 8 in its first half
// and the last four in its second, so a thread's two 16-byte loads are
// each 16 bytes from its neighbour's and a quarter warp's touch 8 distinct
// bank groups (in plain order they lie 32 bytes apart: a 2-way conflict).
template <int VEC>
__device__ __forceinline__ int staged_pos(int c, int cols) {
  if constexpr (VEC == 8) {
    return (c & 4) ? cols / 2 + ((c >> 3) << 2) + (c & 3) : ((c >> 3) << 2) + (c & 3);
  } else {
    return c;
  }
}

// the VEC staged values of output columns g * VEC .. g * VEC + VEC - 1
template <int VEC>
__device__ __forceinline__ void load_staged(const float* row, int g, int cols, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = row[g];
  } else {
    const float4* q = reinterpret_cast<const float4*>(row);
    unpack(q[g], v);
    if constexpr (VEC == 8) unpack(q[cols / 8 + g], v + 4);
  }
}

// VEC fp32 values rounded into one output word: bf16 pairs converted by one
// instruction each (both round to nearest even, as one at a time would)
template <typename T, int VEC, typename Word>
__device__ __forceinline__ void pack(const float (&v)[VEC], Word& word) {
  if constexpr (sizeof(T) == 2 && VEC > 1) {
    __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&word);
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) pairs[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  } else {
    T* res = reinterpret_cast<T*>(&word);
#pragma unroll
    for (int k = 0; k < VEC; ++k) res[k] = from_f32<T>(v[k]);
  }
}

// one output word, a streaming store on a vector route (the output is read
// by the next layer, not by this kernel)
template <int VEC, typename Word>
__device__ __forceinline__ void store_word(Word* row, int g, const Word& word) {
  if constexpr (VEC == 1) {
    row[g] = word;
  } else {
    __stcs(reinterpret_cast<float4*>(row) + g, *reinterpret_cast<const float4*>(&word));
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kBandThreads)
resize_bilinear_band_kernel(const T* __restrict__ x, T* __restrict__ out,
                            const int* __restrict__ iy0, const int* __restrict__ iy1,
                            const float* __restrict__ fy, const int* __restrict__ ix0,
                            const int* __restrict__ ix1, const float* __restrict__ fx,
                            int64_t blocks, int h, int w, int oh, int ow, BandPlan plan) {
  using Word = typename Words<T, VEC>::type;
  constexpr int kPerGranule = 16 / sizeof(T);
  // stage_rows raw input rows of raw_pitch granules, then stage_rows W-mixed
  // fp32 rows of plan.cols values
  extern __shared__ uint4 smem_granules[];
  uint4* raw = smem_granules;
  float* stage = reinterpret_cast<float*>(raw + plan.stage_rows * plan.raw_pitch);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int64_t blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const int tile = (int)(blk % plan.tiles);
    const int64_t rest = blk / plan.tiles;
    const int oy0 = (int)(rest % plan.bands) * plan.band;
    const int64_t plane = rest / plan.bands;
    const int oy1 = min(oy0 + plan.band, oh);
    const int ox0 = tile * plan.cols;
    const int cols = min(plan.cols, ow - ox0);
    const int base = __ldg(iy0 + oy0);
    const int rows = __ldg(iy1 + oy1 - 1) - base + 1;
    const int seg0 = __ldg(ix0 + ox0);
    const int seg_len = __ldg(ix1 + ox0 + cols - 1) - seg0 + 1;
    // the plan sizes the stage for every band and tile
    if (rows > plan.stage_rows || seg_len > plan.in_cols) __trap();

    // copy the input segment each staged row reads, [seg0, seg0 + seg_len),
    // as the 16-byte granules that hold it: every load independent, so one
    // round trip to memory. A granule that holds a byte of the segment lies
    // in the same page as that byte.
    const T* seg = x + (plane * h + base) * (int64_t)w + seg0;
    for (int t = tid; t < rows * plan.raw_pitch; t += nthreads) {
      const int r = t / plan.raw_pitch;
      const int q = t - r * plan.raw_pitch;
      const uintptr_t start = reinterpret_cast<uintptr_t>(seg + (int64_t)r * w);
      const uintptr_t granule = (start & ~(uintptr_t)15) + 16 * (uintptr_t)q;
      if (granule < start + (uintptr_t)seg_len * sizeof(T))
        raw[t] = __ldg(reinterpret_cast<const uint4*>(granule));
    }
    __syncthreads();

    // W-mix each staged row: xw = x0 * (1 - fx) + x1 * fx, in fp32
    const unsigned lead0 = (unsigned)(reinterpret_cast<uintptr_t>(seg) % 16) / sizeof(T);
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const int j0 = __ldg(ix0 + ox0 + c) - seg0;
      const int j1 = __ldg(ix1 + ox0 + c) - seg0;
      const float w1 = __ldg(fx + ox0 + c);
      const float w0 = __fsub_rn(1.f, w1);
      float* col = stage + staged_pos<VEC>(c, plan.cols);
      for (int r = threadIdx.y; r < rows; r += blockDim.y) {
        // row r's segment starts lead values into its first granule
        const unsigned lead = (lead0 + (unsigned)r * (unsigned)w) % kPerGranule;
        const T* vals = reinterpret_cast<const T*>(raw + r * plan.raw_pitch) + lead;
        col[r * plan.cols] =
            __fadd_rn(__fmul_rn(to_f32(vals[j0]), w0), __fmul_rn(to_f32(vals[j1]), w1));
      }
    }
    __syncthreads();

    // each output row: out = xw[iy0] * (1 - fy) + xw[iy1] * fy, a word a store
    T* dst = out + plane * (int64_t)oh * ow + ox0;
    for (int r = threadIdx.y; r < oy1 - oy0; r += blockDim.y) {
      const int oy = oy0 + r;
      const float w1 = __ldg(fy + oy);
      const float w0 = __fsub_rn(1.f, w1);
      const float* s0 = stage + (__ldg(iy0 + oy) - base) * plan.cols;
      const float* s1 = stage + (__ldg(iy1 + oy) - base) * plan.cols;
      Word* orow = reinterpret_cast<Word*>(dst + (int64_t)oy * ow);
      for (int g = threadIdx.x; g < cols / VEC; g += blockDim.x) {
        float a[VEC], b[VEC];
        load_staged<VEC>(s0, g, plan.cols, a);
        load_staged<VEC>(s1, g, plan.cols, b);
#pragma unroll
        for (int k = 0; k < VEC; ++k) a[k] = __fadd_rn(__fmul_rn(a[k], w0), __fmul_rn(b[k], w1));
        Word word;
        pack<T, VEC>(a, word);
        store_word<VEC>(orow, g, word);
      }
    }
    __syncthreads();  // the next band of this block restages
  }
}

template <typename T, int VEC>
void launch_fwd(const void* x, void* out, const int* iy0, const int* iy1, const float* fy,
                const int* ix0, const int* ix1, const float* fx, int64_t blocks, int h, int w,
                int oh, int ow, const BandPlan& plan, dim3 threads, int smem, cudaStream_t s) {
  const int64_t grid = blocks < INT32_MAX ? blocks : INT32_MAX;
  resize_bilinear_band_kernel<T, VEC><<<(unsigned)grid, threads, smem, s>>>(
      (const T*)x, (T*)out, iy0, iy1, fy, ix0, ix1, fx, blocks, h, w, oh, ow, plan);
}

// The tables of one axis for the backward: the second tap's weight per
// output and each tap's output range per input.
struct AxisRanges {
  const float* frac;
  const int* lo0;
  const int* hi0;
  const int* lo1;
  const int* hi1;
};

// The staged backward's plan, from the host: input rows a band takes,
// input columns a tile takes, the cotangent columns a tile reads at most,
// the fp32 values a row of the H-mixed stage keeps (its pitch), and the
// bands a plane and the tiles a row are cut into.
struct BwdPlan {
  int band;
  int cols;
  int in_cols;
  int t_pitch;
  int bands;
  int tiles;
};

// input rows one thread of the staged backward W-mixes at once
constexpr int kMixRows = 8;

// acc[k] += wt * the k-th of the VEC values in a 16-byte word, in fp32 (the
// word by value: one 16-byte load at the call)
template <typename T, int VEC>
__device__ __forceinline__ void mix_word(float (&acc)[VEC], const uint4 word, float wt) {
  const T* vals = reinterpret_cast<const T*>(&word);
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] += to_f32(vals[k]) * wt;
}

// A band of input rows by a tile of input columns. H first: each (input
// row, VEC cotangent columns) sums its H taps straight from device memory
// into the stage (fp32, t_pitch values a row; with
// kGranule a row's segment starts `lead` values into the stage, as into its
// first granule). Then W: each input element sums its W taps from the
// stage. An input row's taps read about 2r cotangent rows for an upsample
// by r, and its neighbour reads half of them again: from L1, as the block
// holds both.
template <typename T, bool kGranule>
__global__ void __launch_bounds__(kBandThreads)
resize_bilinear_bwd_band_kernel(const T* __restrict__ g, T* __restrict__ gx, AxisRanges ay,
                                AxisRanges ax, int64_t blocks, int h, int w, int oh, int ow,
                                BwdPlan plan) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float4 smem_stage[];
  float* stage = reinterpret_cast<float*>(smem_stage);
  const int tid = threadIdx.x;
  for (int64_t blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const int tile = (int)(blk % plan.tiles);
    const int64_t rest = blk / plan.tiles;
    const int y0 = (int)(rest % plan.bands) * plan.band;
    const int64_t plane = rest / plan.bands;
    const int rows = min(plan.band, h - y0);
    const int x0 = tile * plan.cols;
    const int cols = min(plan.cols, w - x0);
    // the cotangent columns [seg0, seg0 + seg_len) the tile's inputs read:
    // the first input's lowest range start to the last input's highest end
    // (both tables are monotone)
    const int seg0 = min(__ldg(ax.lo0 + x0), __ldg(ax.lo1 + x0));
    const int seg_len =
        max(__ldg(ax.hi0 + x0 + cols - 1), __ldg(ax.hi1 + x0 + cols - 1)) - seg0;
    if (seg_len > plan.in_cols) __trap();
    const T* seg = g + plane * (int64_t)oh * ow + seg0;
    const int lead = kGranule ? (int)((reinterpret_cast<uintptr_t>(seg) & 15) / sizeof(T)) : 0;
    const T* first = seg - lead;
    const int q_count = (lead + seg_len + VEC - 1) / VEC;

    // H: stage[yy][q * VEC + k] = the H taps of input row y0 + yy over
    // value q * VEC + k - lead of the segment: tap 0 weighted 1 - fy, then
    // tap 1 weighted fy, in fp32
    for (int item = tid; item < rows * q_count; item += blockDim.x) {
      const int yy = item / q_count;
      const int q = item - yy * q_count;
      const int y = y0 + yy;
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      if constexpr (kGranule) {
        // every row keeps the segment's alignment: one 16-byte load a row
        const uint4* col = reinterpret_cast<const uint4*>(first) + q;
        const int64_t row_words = ow / VEC;
#pragma unroll 2
        for (int oy = __ldg(ay.lo0 + y), end = __ldg(ay.hi0 + y); oy < end; ++oy)
          mix_word<T, VEC>(acc, col[oy * row_words], 1.f - __ldg(ay.frac + oy));
#pragma unroll 2
        for (int oy = __ldg(ay.lo1 + y), end = __ldg(ay.hi1 + y); oy < end; ++oy)
          mix_word<T, VEC>(acc, col[oy * row_words], __ldg(ay.frac + oy));
      } else {
        // one value a load, none past the segment
        const T* col = first + q * VEC;
        const int left = seg_len - q * VEC;
        for (int oy = __ldg(ay.lo0 + y), end = __ldg(ay.hi0 + y); oy < end; ++oy) {
          const float wt = 1.f - __ldg(ay.frac + oy);
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            if (k < left) acc[k] += to_f32(col[(int64_t)oy * ow + k]) * wt;
        }
        for (int oy = __ldg(ay.lo1 + y), end = __ldg(ay.hi1 + y); oy < end; ++oy) {
          const float wt = __ldg(ay.frac + oy);
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            if (k < left) acc[k] += to_f32(col[(int64_t)oy * ow + k]) * wt;
        }
      }
      float* out = stage + yy * plan.t_pitch + q * VEC;
#pragma unroll
      for (int k = 0; k < VEC; k += 4)
        *reinterpret_cast<float4*>(out + k) = make_float4(acc[k], acc[k + 1], acc[k + 2],
                                                          acc[k + 3]);
    }
    __syncthreads();

    // W: each input element sums its W taps over the staged row: tap 0
    // weighted 1 - fx, then tap 1 weighted fx. A work item is a column and
    // kMixRows rows, so one weight load and one trip through the
    // data-dependent loops serve kMixRows sums; consecutive threads take
    // consecutive columns, so the stores coalesce.
    const float* fx = ax.frac + seg0;
    const int groups = (rows + kMixRows - 1) / kMixRows;
    T* dst = gx + (plane * h + y0) * (int64_t)w + x0;
    for (int item = tid; item < groups * cols; item += blockDim.x) {
      const int rg = item / cols;
      const int c = item - rg * cols;
      const int xi = x0 + c;
      int row[kMixRows];  // where each row's segment starts in the stage
      float rs[kMixRows];
#pragma unroll
      for (int k = 0; k < kMixRows; ++k) {
        // a row past the band repeats the last one; its sum is not stored
        row[k] = lead + min(rg * kMixRows + k, rows - 1) * plan.t_pitch;
        rs[k] = 0.f;
      }
      for (int j = __ldg(ax.lo0 + xi) - seg0, end = __ldg(ax.hi0 + xi) - seg0; j < end; ++j) {
        const float wt = 1.f - __ldg(fx + j);
#pragma unroll
        for (int k = 0; k < kMixRows; ++k) rs[k] += stage[row[k] + j] * wt;
      }
      for (int j = __ldg(ax.lo1 + xi) - seg0, end = __ldg(ax.hi1 + xi) - seg0; j < end; ++j) {
        const float wt = __ldg(fx + j);
#pragma unroll
        for (int k = 0; k < kMixRows; ++k) rs[k] += stage[row[k] + j] * wt;
      }
#pragma unroll
      for (int k = 0; k < kMixRows; ++k)
        if (rg * kMixRows + k < rows)
          dst[(int64_t)(rg * kMixRows + k) * w + c] = from_f32<T>(rs[k]);
    }
    __syncthreads();  // the next band of this block restages
  }
}

constexpr int kSumWarps = 8;

// An input of 1x1: gx[p] = the sum of cotangent plane p (n values), a warp
// a plane. Each lane sums its 16-byte granules in order, then a fixed tree
// of shuffles adds the lanes' sums; the ragged head and tail of a plane
// that does not start on a granule go value by value.
template <typename T>
__global__ void __launch_bounds__(32 * kSumWarps)
resize_bilinear_bwd_plane_sum_kernel(const T* __restrict__ g, T* __restrict__ gx,
                                     int64_t planes, int64_t n) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int lane = threadIdx.x & 31;
  for (int64_t p = (int64_t)blockIdx.x * kSumWarps + threadIdx.x / 32; p < planes;
       p += (int64_t)gridDim.x * kSumWarps) {
    const T* src = g + p * n;
    // granule q holds plane values [q * kVec - lead, q * kVec - lead + kVec)
    const int lead = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
    const uint4* granules = reinterpret_cast<const uint4*>(src - lead);
    const int64_t count = (lead + n + kVec - 1) / kVec;
    float acc = 0.f;
#pragma unroll 4
    for (int64_t q = lane; q < count; q += 32) {
      const int64_t e0 = q * kVec - lead;
      if (e0 >= 0 && e0 + kVec <= n) {
        const uint4 word = __ldg(granules + q);
        const T* vals = reinterpret_cast<const T*>(&word);
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc += to_f32(vals[k]);
      } else {
        for (int64_t e = e0 < 0 ? 0 : e0; e < e0 + kVec && e < n; ++e) acc += to_f32(src[e]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) gx[p] = from_f32<T>(acc);
  }
}

// sum over the W taps of one cotangent row, for input column xi
template <typename T>
__device__ __forceinline__ float row_sum(const T* __restrict__ row, const AxisRanges& ax,
                                         int xi) {
  float rs = 0.f;
  for (int ox = __ldg(ax.lo0 + xi), end = __ldg(ax.hi0 + xi); ox < end; ++ox)
    rs += to_f32(row[ox]) * (1.f - __ldg(ax.frac + ox));
  for (int ox = __ldg(ax.lo1 + xi), end = __ldg(ax.hi1 + xi); ox < end; ++ox)
    rs += to_f32(row[ox]) * __ldg(ax.frac + ox);
  return rs;
}

// The direct backward: one block per input row (plane, y), threads on its
// columns; each input element sums the H taps of its weighted row sums,
// reading the cotangent from device memory
template <typename T>
__global__ void resize_bilinear_bwd_kernel(const T* __restrict__ g, T* __restrict__ gx,
                                           AxisRanges ay, AxisRanges ax, int64_t rows,
                                           int h, int w, int oh, int ow) {
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int64_t plane = r / h;
    const int y = (int)(r - plane * h);
    const T* src = g + plane * (int64_t)oh * ow;
    T* dst = gx + r * (int64_t)w;
    for (int xi = threadIdx.x; xi < w; xi += blockDim.x) {
      float acc = 0.f;
      for (int oy = __ldg(ay.lo0 + y), end = __ldg(ay.hi0 + y); oy < end; ++oy)
        acc += row_sum(src + (int64_t)oy * ow, ax, xi) * (1.f - __ldg(ay.frac + oy));
      for (int oy = __ldg(ay.lo1 + y), end = __ldg(ay.hi1 + y); oy < end; ++oy)
        acc += row_sum(src + (int64_t)oy * ow, ax, xi) * __ldg(ay.frac + oy);
      dst[xi] = from_f32<T>(acc);
    }
  }
}

template <typename T>
void launch_direct_bwd(const void* g, void* gx, const AxisRanges& ay, const AxisRanges& ax,
                       int64_t nc, int h, int w, int oh, int ow, cudaStream_t s) {
  const int64_t rows = nc * h;
  resize_bilinear_bwd_kernel<T><<<grid_for(rows, 1, 64), 128, 0, s>>>(
      (const T*)g, (T*)gx, ay, ax, rows, h, w, oh, ow);
}

template <typename T>
void launch_plane_sum(const void* g, void* gx, int64_t nc, int64_t n, cudaStream_t s) {
  resize_bilinear_bwd_plane_sum_kernel<T><<<grid_for(nc, kSumWarps, 8), 32 * kSumWarps, 0, s>>>(
      (const T*)g, (T*)gx, nc, n);
}

template <typename T, bool kGranule>
void launch_band_bwd(const void* g, void* gx, const AxisRanges& ay, const AxisRanges& ax,
                     int64_t blocks, int h, int w, int oh, int ow, const BwdPlan& plan,
                     int smem, cudaStream_t s) {
  const int64_t grid = blocks < INT32_MAX ? blocks : INT32_MAX;
  resize_bilinear_bwd_band_kernel<T, kGranule><<<(unsigned)grid, kBandThreads, smem, s>>>(
      (const T*)g, (T*)gx, ay, ax, blocks, h, w, oh, ow, plan);
}

}  // namespace

// x (nc, h, w) -> out (nc, oh, ow) of `dtype` (0 = float32, 1 = bfloat16),
// by the tap tables of each axis, on the plan of cuda_resize.bilinear_fwd_plan:
// `vec` values a store (16 / itemsize, or 1), `band` output rows and `cols`
// output columns a block, `stage_rows` staged input rows of at most
// `in_cols` values in `raw_pitch` granules each, `smem` bytes in all,
// threads_x x threads_y threads. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int mrfp_resize_bilinear(const void* x, void* out, const void* iy0, const void* iy1,
                                    const void* fy, const void* ix0, const void* ix1,
                                    const void* fx, int64_t nc, int h, int w, int oh, int ow,
                                    int vec, int band, int stage_rows, int cols, int in_cols,
                                    int raw_pitch, int threads_x, int threads_y, int smem,
                                    int dtype, void* stream) {
  if (nc == 0 || oh == 0 || ow == 0) return (int)cudaSuccess;
  const int item = dtype == 0 ? 4 : 2;
  const bool vector_ok = vec == 16 / item && ow % vec == 0 && cols % vec == 0 &&
                         (uintptr_t)out % 16 == 0;
  if ((dtype != 0 && dtype != 1) || (vec != 1 && !vector_ok) || band < 1 || cols < 1 ||
      stage_rows < 1 || in_cols < 1 || raw_pitch < (in_cols * item + 15) / 16 + 1 ||
      threads_x < 1 || threads_y < 1 || threads_x * threads_y > kBandThreads ||
      smem < (int64_t)stage_rows * (16 * raw_pitch + 4 * cols) || smem > kBandSmemCap)
    return (int)cudaErrorInvalidValue;
  const BandPlan plan{band,    stage_rows, cols, in_cols, raw_pitch, (oh + band - 1) / band,
                      (ow + cols - 1) / cols};
  const int64_t blocks = nc * plan.bands * plan.tiles;
  const dim3 threads(threads_x, threads_y);
  cudaStream_t s = (cudaStream_t)stream;
  const int* y0 = (const int*)iy0;
  const int* y1 = (const int*)iy1;
  const int* x0 = (const int*)ix0;
  const int* x1 = (const int*)ix1;
  const float* wy = (const float*)fy;
  const float* wx = (const float*)fx;
  if (dtype == 0) {
    if (vec == 1)
      launch_fwd<float, 1>(x, out, y0, y1, wy, x0, x1, wx, blocks, h, w, oh, ow, plan, threads,
                           smem, s);
    else
      launch_fwd<float, 4>(x, out, y0, y1, wy, x0, x1, wx, blocks, h, w, oh, ow, plan, threads,
                           smem, s);
  } else {
    if (vec == 1)
      launch_fwd<__nv_bfloat16, 1>(x, out, y0, y1, wy, x0, x1, wx, blocks, h, w, oh, ow, plan,
                                   threads, smem, s);
    else
      launch_fwd<__nv_bfloat16, 8>(x, out, y0, y1, wy, x0, x1, wx, blocks, h, w, oh, ow, plan,
                                   threads, smem, s);
  }
  return (int)cudaGetLastError();
}

// g: the (nc, oh, ow) cotangent; gx: the (nc, h, w) input gradient. For each
// axis: the second tap's weight per output and both taps' output ranges per
// input. route (cuda_resize.bilinear_bwd_plan): 0 the plane sum (h == w ==
// 1); 1 the staged kernel, on the plan `vec` cotangent values a load (16 /
// itemsize where ow is a whole number of them, or 1; a thread takes 16
// bytes' worth either way), `band` input rows and
// `cols` input columns a block, at most `in_cols` cotangent columns a tile,
// `t_pitch` fp32 values a staged row, `smem` bytes; 2 the direct kernel.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a plan the kernel does not take.
extern "C" int mrfp_resize_bilinear_bwd(const void* g, void* gx, const void* fy,
                                        const void* ly0, const void* hy0, const void* ly1,
                                        const void* hy1, const void* fx, const void* lx0,
                                        const void* hx0, const void* lx1, const void* hx1,
                                        int64_t nc, int h, int w, int oh, int ow, int route,
                                        int vec, int band, int cols, int in_cols, int t_pitch,
                                        int smem, int dtype, void* stream) {
  if (nc * h * w == 0) return (int)cudaSuccess;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const AxisRanges ay{(const float*)fy, (const int*)ly0, (const int*)hy0, (const int*)ly1,
                      (const int*)hy1};
  const AxisRanges ax{(const float*)fx, (const int*)lx0, (const int*)hx0, (const int*)lx1,
                      (const int*)hx1};
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 0) {
    if (h != 1 || w != 1) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      launch_plane_sum<float>(g, gx, nc, (int64_t)oh * ow, s);
    else
      launch_plane_sum<__nv_bfloat16>(g, gx, nc, (int64_t)oh * ow, s);
    return (int)cudaGetLastError();
  }
  if (route == 2) {
    if (dtype == 0)
      launch_direct_bwd<float>(g, gx, ay, ax, nc, h, w, oh, ow, s);
    else
      launch_direct_bwd<__nv_bfloat16>(g, gx, ay, ax, nc, h, w, oh, ow, s);
    return (int)cudaGetLastError();
  }
  const int per_word = 16 / (dtype == 0 ? 4 : 2);
  const bool granule_ok = vec == per_word && ow % vec == 0;
  // the stage holds a row of in_cols values from any lead, in whole words
  const int64_t need = ((int64_t)in_cols + 2 * per_word - 1) / per_word * per_word;
  if (route != 1 || (vec != 1 && !granule_ok) || band < 1 || cols < 1 || in_cols < 1 ||
      t_pitch < need || t_pitch % 4 != 0 || smem < 4LL * band * t_pitch || smem > kBandSmemCap)
    return (int)cudaErrorInvalidValue;
  const BwdPlan plan{band, cols, in_cols, t_pitch, (h + band - 1) / band, (w + cols - 1) / cols};
  const int64_t blocks = nc * plan.bands * plan.tiles;
  if (dtype == 0) {
    if (vec == 1)
      launch_band_bwd<float, false>(g, gx, ay, ax, blocks, h, w, oh, ow, plan, smem, s);
    else
      launch_band_bwd<float, true>(g, gx, ay, ax, blocks, h, w, oh, ow, plan, smem, s);
  } else {
    if (vec == 1)
      launch_band_bwd<__nv_bfloat16, false>(g, gx, ay, ax, blocks, h, w, oh, ow, plan, smem, s);
    else
      launch_band_bwd<__nv_bfloat16, true>(g, gx, ay, ax, blocks, h, w, oh, ow, plan, smem, s);
  }
  return (int)cudaGetLastError();
}
