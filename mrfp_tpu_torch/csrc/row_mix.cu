// Row mix of an NCHW-contiguous map along one spatial axis: out = P @ x along
// H (dim 2) or W (dim 3), for a general (out, in) fp32 matrix P:
//
//   dim 2   out[p, o, w] = sum over i of P[o, i] * x[p, i, w]
//   dim 3   out[p, h, o] = sum over i of P[o, i] * x[p, h, i]
//
// summed in fp32 with fmaf, in column order, and rounded once to x's dtype.
//
// Replaces the TPU kernel mrfp_tpu/ops/pallas_resize.py::row_mix_pallas
// (_mix_h_kernel, _mix_w_kernel), which take_rows calls with a one-hot P for
// its forward and with P transposed for its VJP. On the TPU the mix is one
// MXU matmul per tile, and a one-hot row costs as much as a dense one. Here P
// is read as a table of its non-zero weights: for output o, cnt[o] terms,
// each a column and a weight, in column order, stored term-major
// (table[(1 + t) * on + o] the column, table[(1 + terms + t) * on + o] the
// weight's bits, table[o] the count), so that neighbouring outputs read
// neighbouring words. take_rows knows its one-hot P on the host and builds
// the table there once (ops/cuda_row_mix.py::row_table_np, cached beside the
// one-hot matrix); a caller's general P is compacted on the device
// (compact_rows_kernel, a launch of its own, terms = in). A one-hot P costs
// one read per output; its transpose at the OC branch's scales at most two,
// and a sum of two terms does not depend on order, so both equal the dense
// product bit for bit. Skipping a zero weight differs from the dense product
// only where x holds an inf or a NaN (0 * inf is NaN in the product, absent
// here); a NaN weight is kept.
//
// What bounds it on Hopper: bytes, if every access moves 16 bytes, and
// behind them the instructions each output costs. A block stages the table
// in shared memory once (when it fits) and then walks many bands with it (a
// grid-stride loop, as many blocks as the SMs hold):
//
// - dim 2 (H), rows of whole 16-byte vectors from aligned pointers (the
//   vector route): an output row is a weighted sum of whole input rows. A
//   block takes a band of output rows of one plane as one flat run of (row,
//   vector) items, two a thread, loads of both in flight per term, 16-byte
//   loads and stores straight from device memory.
// - dim 3 (W), and dim 2 where rows start mid-vector (widths such as 277 in
//   bf16): the staged route. A band's input is one contiguous run (along W
//   its rows; along H the input rows [lo, hi] its terms read, which the
//   host bounds from the table's columns, ops/cuda_row_mix.py::row_mix_plan,
//   and each warp finds from the table). The block copies the run's 16-byte
//   granules into shared memory with cp.async, the next band's while it
//   computes this one (two stages), so the stage keeps the run's address
//   modulo 16. Along W a thread takes an output column with its terms in
//   registers and walks rows of the band; along H a warp takes an output
//   row with its terms in registers and its lanes walk the columns. The
//   outputs go into a buffer that keeps the band's output address modulo 16
//   and leaves in aligned 16-byte stores across row boundaries, its ragged
//   ends value by value (the pattern of the staged nearest forward,
//   csrc/resize_nearest.cu). The one-hot tables' one or two terms are
//   unrolled; a general P's terms are a loop, one output at a time.
// - Rows whose stage does not fit: along W the direct kernel (a thread per
//   output, from device memory); along H the scalar route (one value an
//   access, 16 bytes' worth a thread, coalesced).
//
// The host plans the route, the band, the stage and the shared memory
// (ops/cuda_row_mix.py::row_mix_plan); the launch checks the plan.

#include <cassert>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHItems = 2;  // vector-route items a thread of the H mix takes per step

__device__ __forceinline__ unsigned& word_ref(uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// Value v of a 16-byte vector of T, as fp32; and the vector built from fp32
// values, each rounded once.
template <typename T>
__device__ __forceinline__ float vector_value(const uint4& q, int v);
template <>
__device__ __forceinline__ float vector_value<float>(const uint4& q, int v) {
  return __uint_as_float(word_of(q, v));
}
template <>
__device__ __forceinline__ float vector_value<__nv_bfloat16>(const uint4& q, int v) {
  const unsigned u = word_of(q, v >> 1);
  return __uint_as_float((v & 1) ? (u & 0xffff0000u) : (u << 16));
}
template <typename T>
__device__ __forceinline__ void set_vector_value(uint4& q, int v, float f);
template <>
__device__ __forceinline__ void set_vector_value<float>(uint4& q, int v, float f) {
  word_ref(q, v) = __float_as_uint(f);
}
template <>
__device__ __forceinline__ void set_vector_value<__nv_bfloat16>(uint4& q, int v, float f) {
  const unsigned b = __bfloat16_as_ushort(__float2bfloat16(f));
  unsigned& w = word_ref(q, v >> 1);
  w = (v & 1) ? ((w & 0xffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
}

// The table a block reads: staged into shared memory (`words` > 0), or left
// in device memory (`words` == 0; neighbouring outputs still read
// neighbouring words).
__device__ __forceinline__ const int* stage_table(const int* __restrict__ table, int words,
                                                  int* s_tab) {
  if (words == 0) return table;
  for (int i = threadIdx.x; i < words; i += blockDim.x) s_tab[i] = __ldg(table + i);
  __syncthreads();
  return s_tab;
}

// One warp per row of P: its non-zeros, in column order, into the table
// (terms = cols), by a ballot per 32 columns.
__global__ void compact_rows_kernel(const float* __restrict__ p, int rows, int cols,
                                    int* __restrict__ table) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp leaves together
  const float* pr = p + (int64_t)r * cols;
  int* col = table + rows;
  int* wt = table + (int64_t)rows * (1 + cols);
  int base = 0;
  for (int c0 = 0; c0 < cols; c0 += 32) {
    const int c = c0 + lane;
    const float v = c < cols ? pr[c] : 0.f;
    const bool keep = v != 0.f;  // true for NaN: it propagates as in the product
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int64_t at = (int64_t)(base + __popc(mask & ((1u << lane) - 1u))) * rows + r;
      col[at] = c;
      wt[at] = __float_as_int(v);
    }
    base += __popc(mask);
  }
  if (lane == 0) table[r] = base;
}

// dim 2. VEC = values a unit holds (16 bytes' worth on the vector route, 1 on
// the scalar route); ITEMS units a thread takes per step, kThreads apart.
template <typename T, int VEC, int ITEMS>
__global__ void __launch_bounds__(kThreads)
mix_h_kernel(const T* __restrict__ x, T* __restrict__ out, const int* __restrict__ table,
             int64_t blocks, int band, int in, int on, int w, int terms, int table_words) {
  using Unit = typename Words<T, VEC>::type;
  extern __shared__ __align__(16) int s_tab[];
  const int* tab = stage_table(table, table_words, s_tab);
  const int* cnt = tab;
  const int* col = tab + on;
  const float* wt = reinterpret_cast<const float*>(tab + (int64_t)on * (1 + terms));
  const int units = w / VEC;
  const int bands = (on + band - 1) / band;
  const int dr = kThreads / units, du = kThreads - dr * units;
  for (int64_t blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const int64_t plane = blk / bands;
    const int o0 = (int)(blk - plane * bands) * band;
    const int m = min(band, on - o0) * units;
    const Unit* src = reinterpret_cast<const Unit*>(x + plane * in * (int64_t)w);
    Unit* dst = reinterpret_cast<Unit*>(out + (plane * on + o0) * (int64_t)w);
    int r = threadIdx.x / units, u = threadIdx.x - r * units;  // of item e
    for (int e0 = threadIdx.x; e0 < m; e0 += kThreads * ITEMS) {
      int o[ITEMS], uk[ITEMS], n[ITEMS];
      float acc[ITEMS][VEC];
      int nmax = 0;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        o[k] = o0 + r;
        uk[k] = u;
        n[k] = e0 + k * kThreads < m ? cnt[o[k]] : 0;
        nmax = max(nmax, n[k]);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[k][v] = 0.f;
        r += dr;
        u += du;
        if (u >= units) {
          u -= units;
          ++r;
        }
      }
      for (int t = 0; t < nmax; ++t) {
        Unit word[ITEMS];
        float wk[ITEMS];
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {  // every load of this term in flight
          if (t < n[k]) {
            const int64_t at = (int64_t)t * on + o[k];
            wk[k] = wt[at];
            word[k] = __ldg(src + (int64_t)col[at] * units + uk[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          if (t < n[k]) {
            if constexpr (VEC == 1) {
              acc[k][0] = fmaf(wk[k], to_f32(word[k]), acc[k][0]);
            } else {
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                acc[k][v] = fmaf(wk[k], vector_value<T>(word[k], v), acc[k][v]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int e = e0 + k * kThreads;
        if (e < m) {
          if constexpr (VEC == 1) {
            dst[e] = from_f32<T>(acc[k][0]);
          } else {
            uint4 q = make_uint4(0, 0, 0, 0);
#pragma unroll
            for (int v = 0; v < VEC; ++v) set_vector_value<T>(q, v, acc[k][v]);
            __stcs(dst + e, q);
          }
        }
      }
    }
  }
}

// Byte offsets of the staged mix's buffers in its dynamic shared memory:
// the staged table (table_words ints) at 0, two stages of the input run
// (stage_elems values each, one band's while the next band's loads are in
// flight) at `in0` and `in1`, the band's outputs (out_elems values) at
// `out`, `end` the bytes in all. A stage has room for the whole 16-byte
// granules that hold stage_elems values from any offset into a granule, so
// that it keeps its run's device address modulo 16; the output buffer has
// room for one vector more than it holds, for the same reason. The wrapper sizes
// the launch the same way (ops/cuda_row_mix.py::row_mix_staged_smem_bytes);
// the launch checks it.
struct StagedLayout {
  int64_t in0, in1, out, end;
};

template <typename T>
__host__ __device__ inline StagedLayout staged_layout(int table_words, int64_t stage_elems,
                                                      int64_t out_elems) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int64_t stage = ((stage_elems + 2 * kVec - 1) / kVec) * 16;  // whole granules
  const int64_t in0 = (4LL * table_words + 15) & ~15LL;
  const int64_t out = in0 + 2 * stage;
  return {in0, in0 + stage, out, out + (out_elems + kVec - 1) * (int64_t)sizeof(T)};
}

constexpr int kStagedItems = 4;  // outputs a thread of the staged mix has in flight

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group
}

// One block step of the staged mix: its input run [src, src + span), its
// output run from dst, its rows, and (dim 2) its first output row and first
// input row.
template <typename T>
struct Band {
  const T* src;
  T* dst;
  int nrows, span, o0, lo;
};

// ALONG_W: `band` consecutive rows of the flattened (planes x h) map, `rows`
// of them, w values each. Otherwise a band of `band` output rows of one
// plane (`in` input rows, `on` output rows, w values each), whose terms read
// input rows [lo, hi]: every warp finds them from the table itself (lanes
// over the band's rows, then a warp reduction), so no barrier is needed.
template <typename T, bool ALONG_W>
__device__ __forceinline__ Band<T> band_at(int64_t blk, const T* x, T* out, const int* cnt,
                                           const int* col, int band, int stage_rows,
                                           int64_t rows, int in, int w, int on) {
  Band<T> b;
  if constexpr (ALONG_W) {
    const int64_t r0 = blk * band;
    b.nrows = (int)min((int64_t)band, rows - r0);
    b.src = x + r0 * w;
    b.dst = out + r0 * on;
    b.span = b.nrows * w;
    b.o0 = b.lo = 0;
  } else {
    const int bands = (on + band - 1) / band;
    const int64_t plane = blk / bands;
    b.o0 = (int)(blk - plane * bands) * band;
    b.nrows = min(band, on - b.o0);
    int l = 0x7fffffff, hi = -1;
    for (int r = threadIdx.x & 31; r < b.nrows; r += 32) {
      const int n = cnt[b.o0 + r];
      if (n > 0) {  // a row's columns are in order: its first and last term
        l = min(l, col[b.o0 + r]);
        hi = max(hi, col[(n - 1) * on + b.o0 + r]);
      }
    }
    l = __reduce_min_sync(0xffffffffu, l);
    hi = __reduce_max_sync(0xffffffffu, hi);
    const int need = hi < 0 ? 0 : hi - l + 1;
    // the plan sizes the stage for every band, and the wrapper checks it on
    // the host (ops/cuda_row_mix.py::_plan_cached); a debug build checks here
    assert(need <= stage_rows);
    b.lo = hi < 0 ? 0 : l;
    b.span = need * w;
    b.src = x + (plane * in + b.lo) * (int64_t)w;
    b.dst = out + (plane * on + b.o0) * (int64_t)w;
  }
  return b;
}

// Start the loads of a band's input run into a stage: the whole 16-byte
// granules that hold it, so the stage keeps the run's address modulo 16. A
// granule's bytes outside the run lie in the same aligned granule of the
// tensor's allocation (the caching allocator's blocks are 512-byte aligned
// and sized) and are never read.
template <typename T>
__device__ __forceinline__ void prefetch(const Band<T>& b, T* stage) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const uintptr_t start = reinterpret_cast<uintptr_t>(b.src);
  const int shift = (int)((start & 15) / sizeof(T));
  const uint4* g = reinterpret_cast<const uint4*>(start & ~(uintptr_t)15);
  const int nvec = b.span > 0 ? (shift + b.span + kVec - 1) / kVec : 0;
  for (int v = threadIdx.x; v < nvec; v += kThreads) cp_async16(stage + v * kVec, g + v);
}

// The staged mix. ALONG_W (dim 3): a block step takes `band` consecutive rows
// of the flattened (planes x h) map, whose input is one contiguous run of
// band * w values. Otherwise (dim 2): a band of `band` output rows of one
// plane, whose terms read input rows [lo, hi] of that plane (found from the
// table; at most stage_rows of them), one contiguous run of (hi - lo + 1) *
// w values. Either way the run is staged as 16-byte granules by cp.async,
// the next band's while this one is computed; the band's outputs (one flat
// run) are computed from shared memory into a buffer that leaves in 16-byte
// stores. TERMS: the table's terms, unrolled into predicated code (1 or 2),
// or 0 for a loop over any count.
template <typename T, bool ALONG_W, int TERMS>
__global__ void __launch_bounds__(kThreads)
mix_staged_kernel(const T* __restrict__ x, T* __restrict__ out, const int* __restrict__ table,
                  int64_t blocks, int band, int stage_rows, int64_t rows, int in, int w, int on,
                  int terms, int table_words) {
  constexpr int kVec = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_out = ALONG_W ? on : w;  // values an output row holds
  const StagedLayout lay = staged_layout<T>(
      table_words, (int64_t)(ALONG_W ? band : stage_rows) * w, (int64_t)band * row_out);
  // the two stages, by index without a local array (which would go to the stack)
  auto stage = [&](int b) { return reinterpret_cast<T*>(smem + (b ? lay.in1 : lay.in0)); };
  T* s_out = reinterpret_cast<T*>(smem + lay.out);
  const int* tab = stage_table(table, table_words, reinterpret_cast<int*>(smem));
  const int* cnt = tab;
  const int* col = tab + on;
  const float* wt = reinterpret_cast<const float*>(tab + (int64_t)on * (1 + terms));
  const int step_rows = kThreads / row_out, step_cols = kThreads - step_rows * row_out;
  Band<T> cur = band_at<T, ALONG_W>(blockIdx.x, x, out, cnt, col, band, stage_rows, rows, in, w,
                                    on);
  if (blockIdx.x < blocks) prefetch(cur, stage(0));
  cp_async_commit();
  int buf = 0;
  for (int64_t blk = blockIdx.x; blk < blocks; blk += gridDim.x, buf ^= 1) {
    // the next band's loads go out before this band is computed
    const int64_t next = blk + gridDim.x;
    Band<T> nb = cur;
    if (next < blocks) {
      nb = band_at<T, ALONG_W>(next, x, out, cnt, col, band, stage_rows, rows, in, w, on);
      prefetch(nb, stage(buf ^ 1));
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    const T* s_in = stage(buf);
    const T* src = cur.src;
    T* dst = cur.dst;
    const int nrows = cur.nrows, o0 = cur.o0, lo = cur.lo;
    const int shift = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
    const int m = nrows * row_out;
    const int dshift = (int)((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(T));
    if constexpr (ALONG_W && TERMS > 0) {
      // A thread takes an output column c with its terms in registers and
      // walks rows g, g + rg, ... of the band: items (c, g), consecutive
      // threads on consecutive columns. rg splits the rows so that the items
      // share out evenly: the least (items a thread) * (3 + rows an item),
      // the 3 for an item's table reads.
      int rg = 1, best = 0x7fffffff;
      for (int r = 1; r <= 8 && r <= nrows; ++r) {
        const int cost = ((on * r + kThreads - 1) / kThreads) * (3 + (nrows + r - 1) / r);
        if (cost < best) {
          best = cost;
          rg = r;
        }
      }
      for (int it = threadIdx.x; it < on * rg; it += kThreads) {
        const int g = it / on, c = it - g * on;
        const int nt = cnt[c];
        int cols[TERMS];
        float wts[TERMS];
#pragma unroll
        for (int t = 0; t < TERMS; ++t) {
          cols[t] = t < nt ? col[t * on + c] : 0;
          wts[t] = t < nt ? wt[t * on + c] : 0.f;
        }
#pragma unroll 2
        for (int i = g; i < nrows; i += rg) {
          const T* row = s_in + shift + i * w;
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < TERMS; ++t)
            if (t < nt) acc = fmaf(wts[t], to_f32(row[cols[t]]), acc);
          s_out[dshift + i * on + c] = from_f32<T>(acc);
        }
      }
    } else if constexpr (!ALONG_W && TERMS > 0) {
      // A warp takes an output row with its terms in registers (the same for
      // every lane) and its lanes walk the row's columns: consecutive lanes
      // on consecutive values of the staged input rows and of s_out.
      const int lane = threadIdx.x & 31;
      for (int i = threadIdx.x >> 5; i < nrows; i += kThreads / 32) {
        const int o = o0 + i;
        const int nt = cnt[o];
        int offs[TERMS];
        float wts[TERMS];
#pragma unroll
        for (int t = 0; t < TERMS; ++t) {
          offs[t] = t < nt ? shift + (col[t * on + o] - lo) * w : 0;
          wts[t] = t < nt ? wt[t * on + o] : 0.f;
        }
        T* orow = s_out + dshift + i * w;
#pragma unroll 2
        for (int c = lane; c < w; c += 32) {
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < TERMS; ++t)
            if (t < nt) acc = fmaf(wts[t], to_f32(s_in[offs[t] + c]), acc);
          orow[c] = from_f32<T>(acc);
        }
      }
    } else {
      // the band's outputs as one flat run of m values, kStagedItems a thread
      // at once: consecutive threads take consecutive outputs, into s_out,
      // which keeps dst's address modulo 16
      int i = threadIdx.x / row_out, c = threadIdx.x - i * row_out;
      for (int e0 = threadIdx.x; e0 < m; e0 += kThreads * kStagedItems) {
        int tk[kStagedItems], base[kStagedItems];
        float acc[kStagedItems];
#pragma unroll
        for (int k = 0; k < kStagedItems; ++k) {
          // the table column of output k, and where its terms' values start
          tk[k] = ALONG_W ? c : o0 + i;
          base[k] = ALONG_W ? shift + i * w : shift + c - lo * w;
          acc[k] = 0.f;
          i += step_rows;
          c += step_cols;
          if (c >= row_out) {
            c -= row_out;
            ++i;
          }
        }
#pragma unroll
        for (int k = 0; k < kStagedItems; ++k) {
          if (e0 + k * kThreads < m) {
            const int nt = cnt[tk[k]];
            if constexpr (TERMS == 0) {
              for (int t = 0; t < nt; ++t) {
                const int at = t * on + tk[k];
                const int v = ALONG_W ? col[at] : col[at] * w;
                acc[k] = fmaf(wt[at], to_f32(s_in[base[k] + v]), acc[k]);
              }
            } else {
#pragma unroll
              for (int t = 0; t < TERMS; ++t) {
                if (t < nt) {
                  const int at = t * on + tk[k];
                  const int v = ALONG_W ? col[at] : col[at] * w;
                  acc[k] = fmaf(wt[at], to_f32(s_in[base[k] + v]), acc[k]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kStagedItems; ++k) {
          const int e = e0 + k * kThreads;
          if (e < m) s_out[e + dshift] = from_f32<T>(acc[k]);
        }
      }
    }
    __syncthreads();

    // the run leaves in aligned 16-byte stores, its ragged ends value by value
    const int nout = (dshift + m + kVec - 1) / kVec;
    for (int v = threadIdx.x; v < nout; v += kThreads) {
      const int e0 = v * kVec - dshift;
      if (e0 >= 0 && e0 + kVec <= m) {
        __stcs(reinterpret_cast<uint4*>(dst + e0),
               *reinterpret_cast<const uint4*>(s_out + v * kVec));
      } else {
        for (int e = max(e0, 0); e < min(e0 + kVec, m); ++e) dst[e] = s_out[e + dshift];
      }
    }
    cur = nb;
    // the next step's barrier keeps s_out until every store has read it, and
    // the stage just read is refilled only after the barrier before the stores
  }
}
// dim 3, direct: rows whose stage does not fit; a thread per output, x and
// the table read from device memory.
template <typename T>
__global__ void mix_w_direct_kernel(const T* __restrict__ x, T* __restrict__ out,
                                    const int* __restrict__ table, int64_t rows, int in, int on,
                                    int terms) {
  const int* col = table + on;
  const float* wt = reinterpret_cast<const float*>(table + (int64_t)on * (1 + terms));
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* src = x + r * in;
    T* dst = out + r * on;
    for (int o = threadIdx.x; o < on; o += kThreads) {
      const int nt = __ldg(table + o);
      float acc = 0.f;
      for (int t = 0; t < nt; ++t) {
        const int64_t at = (int64_t)t * on + o;
        acc = fmaf(__ldg(wt + at), to_f32(src[__ldg(col + at)]), acc);
      }
      dst[o] = from_f32<T>(acc);
    }
  }
}

enum Route { kHVector = 0, kHScalar = 1, kWStaged = 2, kWDirect = 3, kHStaged = 4 };

cudaError_t set_smem(const void* kernel, int64_t smem, int64_t* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *allowed = smem;
  return err;
}

// The staged mix for one TERMS: a grid-stride launch of as many blocks as
// the SMs hold at once with this shared memory.
template <typename T, bool ALONG_W, int TERMS>
cudaError_t launch_staged_terms(const T* x, T* out, const int* table, int64_t blocks, int band,
                                int stage_rows, int64_t rows, int in, int w, int on, int terms,
                                int table_words, int64_t smem, cudaStream_t s) {
  auto kernel = mix_staged_kernel<T, ALONG_W, TERMS>;
  static int64_t allowed = 48 * 1024;
  cudaError_t err = set_smem((const void*)kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  static int64_t resident_smem = -1;
  static int resident = 1;
  if (smem != resident_smem) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, (size_t)smem);
    if (err != cudaSuccess) return err;
    resident = n > 0 ? n : 1;
    resident_smem = smem;
  }
  kernel<<<grid_for(blocks, 1, resident), kThreads, (size_t)smem, s>>>(
      x, out, table, blocks, band, stage_rows, rows, in, w, on, terms, table_words);
  return cudaGetLastError();
}

template <typename T, bool ALONG_W>
cudaError_t launch_staged(const T* x, T* out, const int* table, int64_t blocks, int band,
                          int stage_rows, int64_t rows, int in, int w, int on, int terms,
                          int table_words, int64_t smem, cudaStream_t s) {
  if (terms == 1)
    return launch_staged_terms<T, ALONG_W, 1>(x, out, table, blocks, band, stage_rows, rows, in,
                                              w, on, terms, table_words, smem, s);
  if (terms == 2)
    return launch_staged_terms<T, ALONG_W, 2>(x, out, table, blocks, band, stage_rows, rows, in,
                                              w, on, terms, table_words, smem, s);
  return launch_staged_terms<T, ALONG_W, 0>(x, out, table, blocks, band, stage_rows, rows, in, w,
                                            on, terms, table_words, smem, s);
}

template <typename T>
int launch_mix(const void* xv, void* outv, const int* table, int64_t planes, int h, int w,
               int on, int terms, int route, int band, int stage_rows, int table_words,
               int64_t smem, cudaStream_t s) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const T* x = (const T*)xv;
  T* out = (T*)outv;
  if (table_words < 0 || band < 0 || 4LL * table_words > smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (route == kHVector || route == kHScalar) {
    if (band <= 0) return (int)cudaErrorInvalidValue;
    const int64_t blocks = planes * ((on + band - 1) / band);
    const int grid = grid_for(blocks, 1, 2048 / kThreads);
    if (route == kHVector) {
      // whole 16-byte vectors per row, from 16-byte aligned pointers
      if (w % kVec != 0 || (reinterpret_cast<uintptr_t>(x) & 15) ||
          (reinterpret_cast<uintptr_t>(out) & 15))
        return (int)cudaErrorInvalidValue;
      static int64_t allowed = 48 * 1024;
      err = set_smem((const void*)mix_h_kernel<T, kVec, kHItems>, smem, &allowed);
      if (err != cudaSuccess) return (int)err;
      mix_h_kernel<T, kVec, kHItems><<<grid, kThreads, (size_t)smem, s>>>(
          x, out, table, blocks, band, h, on, w, terms, table_words);
    } else {
      static int64_t allowed = 48 * 1024;
      err = set_smem((const void*)mix_h_kernel<T, 1, kVec>, smem, &allowed);
      if (err != cudaSuccess) return (int)err;
      mix_h_kernel<T, 1, kVec><<<grid, kThreads, (size_t)smem, s>>>(
          x, out, table, blocks, band, h, on, w, terms, table_words);
    }
    return (int)cudaGetLastError();
  }
  if (route == kHStaged) {
    if (band <= 0 || stage_rows <= 0 ||
        staged_layout<T>(table_words, (int64_t)stage_rows * w, (int64_t)band * w).end > smem)
      return (int)cudaErrorInvalidValue;
    const int64_t blocks = planes * ((on + band - 1) / band);
    return (int)launch_staged<T, false>(x, out, table, blocks, band, stage_rows, 0, h, w, on,
                                        terms, table_words, smem, s);
  }
  if (route == kWStaged) {
    if (band <= 0 ||
        staged_layout<T>(table_words, (int64_t)band * w, (int64_t)band * on).end > smem)
      return (int)cudaErrorInvalidValue;
    const int64_t rows = planes * h;
    return (int)launch_staged<T, true>(x, out, table, (rows + band - 1) / band, band, band, rows,
                                       w, w, on, terms, table_words, smem, s);
  }
  if (route == kWDirect) {
    const int64_t rows = planes * h;
    mix_w_direct_kernel<T><<<grid_for(rows, 1, 8), kThreads, 0, s>>>(x, out, table, rows, w, on,
                                                                       terms);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// p (rows, cols) fp32 -> table (1 + 2 * cols, rows) int32, terms = cols.
// Returns cudaGetLastError() after the launch.
extern "C" int mrfp_row_mix_compact(const void* p, void* table, int rows, int cols,
                                    void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  compact_rows_kernel<<<(rows + 3) / 4, 128, 0, (cudaStream_t)stream>>>(
      (const float*)p, rows, cols, (int*)table);
  return (int)cudaGetLastError();
}

// x (planes, h, w) of `dtype` (0 = float32, 1 = bfloat16); table (1 + 2 *
// terms, on) int32 as above, for P of (on, h) (dim 2) or (on, w) (dim 3);
// out (planes, on, w) or (planes, h, on). route: 0 H vector, 1 H scalar, 4 H
// staged (dim 2), 2 W staged, 3 W direct (dim 3); band: output rows (H) or
// rows (W) a block takes per step; stage_rows: input rows the H stage holds;
// table_words: the table's words staged in shared memory (0: read from
// device memory); smem: the launch's dynamic shared memory. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int mrfp_row_mix(const void* x, const void* table, void* out, int64_t planes, int h,
                            int w, int on, int terms, int dim, int route, int band,
                            int stage_rows, int table_words, int64_t smem, int dtype,
                            void* stream) {
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if ((dim == 2) != (route == kHVector || route == kHScalar || route == kHStaged))
    return (int)cudaErrorInvalidValue;
  if (on == 0 || planes == 0 || (dim == 2 ? w : h) == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_mix<float>(x, out, (const int*)table, planes, h, w, on, terms, route, band,
                             stage_rows, table_words, smem, s);
  return launch_mix<__nv_bfloat16>(x, out, (const int*)table, planes, h, w, on, terms, route,
                                   band, stage_rows, table_words, smem, s);
}
