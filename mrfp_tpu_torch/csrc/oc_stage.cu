// One stage of the OC branch after its conv, fused: nearest resize, then
// train-mode BatchNorm with fp32 batch statistics, then ReLU, then the cast
// to the map's dtype; forward and backward. Beside it, the transposition
// that moves a map between NCHW and channels-last at the branch's edges.
//
// Fuses two things of the JAX package: the TPU kernel
// mrfp_tpu/ops/pallas_resize.py::resize_nearest_fused (:235) with its custom
// VJP _rn_bwd (:250), and the XLA-fused _bn_relu of
// mrfp_tpu/perturb/oc_branch.py:121-127 that follows it. On the TPU, XLA
// fuses the BN and ReLU into one pass over the resized map. On Hopper, with
// the resize as its own kernel, the chain took six passes over the
// branch's largest maps (the resize, a cast to fp32, BN's statistics and
// apply, ReLU, a cast back) and kept two fp32 copies of each resized map for
// the backward. What bounds it on Hopper is bytes, so this design moves each
// map the fewest times it can, every map channels-last (NHWC):
//
// Statistics from the pre-resize map. A nearest resize repeats source
// pixel (i, j) cy(i) * cx(j) times, the lengths of the [lo, hi) ranges of
// its tables (0 for rows and columns a downsample skips). So the mean and
// the biased variance over the resized map are exactly the count-weighted
// moments of the conv output y. The statistics kernel reads y once: each
// thread takes runs of pixels of a row, takes a run's weighted mean and M2
// in two passes over its registers, and folds the run into its own
// (weight, mean, M2) by Chan's rule; the block's threads are folded the
// same way, in a fixed order, into one partial per block; a second small
// kernel folds the partials per channel, again in a fixed order, and writes
// the mean, M2, 1/sqrt(M2/n + eps) and n. All of it is fp64, rounded once
// to fp32 at the end: the statistics are the exact moments correctly
// rounded (but for a value within fp64's error of a rounding boundary), so
// they do not depend on the order of the sums, and the plain version, which
// takes them in fp64 in another order, gets the same fp32 numbers. A
// train step downstream of train-mode BatchNorm moves by percents when a
// channel's statistics move by an fp32 ulp; this is what lets the kernels
// be held to their plain versions at a step's tight bounds. Across
// processes each rank's fp64 mean and M2, and its backward sums, are
// combined in fp64 before they round, so the ranks get one process's
// numbers. No E[x^2] - E[x]^2 is taken, and nothing is atomic, so two runs
// agree bit for bit.
//
// Apply while gathering. The apply kernel reads y through the H and W
// source tables and writes relu((y - mean) * (invstd * w) + b), rounded
// once to the map's dtype, each operation rounded on its own as the plain
// version's tensor operations are (no FMA). A source pixel's channels are contiguous, so
// neighbouring threads take neighbouring 16-byte packs of one pixel; a
// pixel that repeats comes from L1 or L2.
//
// Backward. With g = dy * [bn_out > 0] and x_hat = (y - mean) * invstd, the
// mask and x_hat of an output are those of its source pixel, so over the
// resized map sum(g) = sum over sources of G and sum(g x_hat) = sum of
// G x_hat, where G is the source's sum of dy over its replica ranges (fp32,
// the row's sum first, then the rows: the plain nearest backward's order),
// masked by its own BN output. Both passes walk the source pixels and form
// G with the same code. Pass 1 reads dy and y and sums G and G x_hat per
// channel in fp64 (each product exact), per block, the partials then added
// in a fixed order and rounded once to fp32, as the statistics are. Pass 2
// reads them again and writes
//   dy_src = s * (G - c * sum(g) / M - c * x_hat * sum(g x_hat) / M)
// (s = w * invstd, c the replica count, M the resized map's count per
// channel): the nearest backward of BN's backward, in the plain version's
// order of operations, rounded once to the map's dtype. The mask
// is recomputed from the saved y with the forward's own arithmetic, so
// nothing but y (in its dtype) and the per-channel statistics is saved for
// the backward.
//
// Layout. The branch's maps stay channels-last between its convs; two of
// its edges are NCHW: the stem features it reads and the maps it adds onto
// NCHW maps (dec4's output, enc4's decoder injection). A stage kernel that
// wrote NCHW directly stored each channel's 16 bytes to another plane, and
// ran at a fifth of the card's rate; so the edges go through a tiled
// transposition instead: a block stages a 64 x 64 tile of one image in
// shared memory (fp32, a padded row, so neither side's accesses conflict
// more than two ways) and both sides move 16 bytes an access. It casts on the way (the fp32
// stem features to the bf16 map the conv takes, and back for their
// gradient) and adds a channels-last map on the way out (a cotangent that
// arrives in both layouts is summed once, in fp32, rounded once).
//
// Names: the profiler finds a resize's time by the kernel names
// resize_(bilinear|nearest). The apply kernel and pass 2 move the bytes of
// the resize they contain (its output written and its input read, forward;
// its output's cotangent read and its input's written, backward), so they
// carry resize_nearest in their names; a stage whose resize is the identity
// runs the same code under oc_stage_* names, as do the statistics kernel,
// pass 1 and the transposition.
//
// Layout of the work: item = (row of the map a kernel walks, run of pixels
// along it, pack of channels), the pack fastest. A pack is 16 bytes of
// channels (8 bf16 or 4 fp32; single values where the channels or
// the pointers do not allow it): each access moves 16 bytes, and a warp's
// 512. A run is 2 pixels of 16-byte packs (8 of single values), 32 bytes a
// thread. A block has a whole number of packs' threads,
// so a thread keeps its channels, and its per-channel constants in
// registers, for all its items; it steps through rows and runs by
// additions (a `Walk`), with no division in the loop. Offsets are int64:
// enc4's map at batch 16, 768x768 holds 604M values.

#include "common.cuh"

namespace {

// Pixels a run takes for a pack of P channels: 2 of 16-byte packs (32
// bytes a thread), 8 of single values
template <int P>
__host__ __device__ constexpr int run_of() {
  return P > 1 ? 2 : 8;
}

__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}

// P values of T at p (P * sizeof(T) bytes, aligned to that), as fp32: one
// 16-byte access for 8 bf16 or 4 fp32, else one value
template <typename T, int P>
__device__ __forceinline__ void load_pack(const T* __restrict__ p, float* v) {
  if constexpr (P == 8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned u = word_of(q, i);
      v[2 * i] = __uint_as_float(u << 16);
      v[2 * i + 1] = __uint_as_float(u & 0xffff0000u);
    }
  } else if constexpr (P == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = to_f32(__ldg(p));
  }
}

template <typename T, int P>
__device__ __forceinline__ void store_pack(T* __restrict__ p, const float* v) {
  if constexpr (P == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                              bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  } else if constexpr (P == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = from_f32<T>(v[0]);
  }
}

// Chan's rule: (w, m, q) <- (w, m, q) combined with (wb, mb, qb), where q is
// the sum of squared deviations from the mean m over weight w
__device__ __forceinline__ void chan(double& w, double& m, double& q, double wb, double mb,
                                     double qb) {
  if (wb <= 0.0) return;
  const double t = w + wb;
  const double f = wb / t;
  const double d = mb - m;
  m += d * f;
  q += qb + d * d * w * f;
  w = t;
}

// A position (image, row in the image, run) in a walk over rows of `runs`
// runs, images of `h` rows, advanced by a fixed step of slots with carries
// instead of divisions
struct Walk {
  int img, row, run;
  int step_rows, step_runs, runs, h;

  __device__ __forceinline__ Walk(int slot, int step, int runs_, int h_) : runs(runs_), h(h_) {
    const int r = slot / runs_;
    run = slot - r * runs_;
    img = r / h_;
    row = r - img * h_;
    step_rows = step / runs_;
    step_runs = step - step_rows * runs_;
  }

  __device__ __forceinline__ void next() {
    run += step_runs;
    row += step_rows;
    if (run >= runs) {
      run -= runs;
      ++row;
    }
    while (row >= h) {
      row -= h;
      ++img;
    }
  }
};

// The per-channel constants of a thread's pack: the mean, invstd, the
// scale a = invstd * w and the shift b (the forward's and both backward
// passes' z = (y - mean) * a + b are the same arithmetic)
template <int P>
struct Affine {
  float mean[P], invstd[P], a[P], b[P];

  // z = (y - mean) * a + b, each operation rounded on its own (no FMA), as
  // the plain version's tensor operations round them
  __device__ __forceinline__ float z(float y, int q) const {
    return __fadd_rn(__fmul_rn(__fsub_rn(y, mean[q]), a[q]), b[q]);
  }
};

template <int P>
__device__ __forceinline__ Affine<P> affine(const float* __restrict__ stats,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b, int c, int c0) {
  Affine<P> f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    f.mean[k] = stats[c0 + k];
    f.invstd[k] = stats[2 * c + c0 + k];
    f.a[k] = f.invstd[k] * w[c0 + k];
    f.b[k] = b[c0 + k];
  }
  return f;
}

// ---- statistics ------------------------------------------------------------

// Block b folds the slots (row, run) [b*per, (b+1)*per) of y (n*h rows of w
// pixels, NHWC) into (W, mean, M2) per channel: part_w[b], part_mean[b][c],
// part_m2[b][c]. Weights: (hy - ly)[i] * (hx - lx)[j]. Dynamic shared
// memory: blockDim * (1 + 2P) floats.
template <typename T, int P>
__global__ void oc_stage_stats_kernel(const T* __restrict__ y, const int* __restrict__ ly,
                                      const int* __restrict__ hy, const int* __restrict__ lx,
                                      const int* __restrict__ hx, double* __restrict__ part_w,
                                      double* __restrict__ part_mean,
                                      double* __restrict__ part_m2, int n, int h, int w, int c) {
  extern __shared__ double sh[];
  constexpr int kRun = run_of<P>();
  const int packs = c / P;
  const int k = blockDim.x / packs;
  const int pk = threadIdx.x % packs, sl = threadIdx.x / packs;
  const int c0 = pk * P;
  const int runs = (w + kRun - 1) / kRun;
  const int slots = n * h * runs;
  const int per = (slots + gridDim.x - 1) / gridDim.x;
  const int s0 = blockIdx.x * per;
  const int s1 = min(s0 + per, slots);
  double W = 0.0, mean[P], m2[P];
#pragma unroll
  for (int q = 0; q < P; ++q) mean[q] = m2[q] = 0.0;
  Walk at(s0 + sl, k, runs, h);
  for (int s = s0 + sl; s < s1; s += k, at.next()) {
    const float cy = (float)(__ldg(hy + at.row) - __ldg(ly + at.row));
    if (cy == 0.f) continue;  // a row the downsample skips
    const int j0 = at.run * kRun;
    const int cnt = min(kRun, w - j0);
    const T* src = y + (((int64_t)at.img * h + at.row) * w + j0) * c + c0;
    float v[kRun][P], cw[kRun], w8 = 0.f;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      cw[j] = 0.f;
#pragma unroll
      for (int q = 0; q < P; ++q) v[j][q] = 0.f;
      if (j < cnt) {
        cw[j] = cy * (float)(__ldg(hx + j0 + j) - __ldg(lx + j0 + j));
        load_pack<T, P>(src + (int64_t)j * c, v[j]);
      }
      w8 += cw[j];
    }
    if (w8 == 0.f) continue;
    // the run's weighted mean and M2 in two passes over its registers,
    // then folded in by Chan's rule, all in fp64
    const double t = W + w8, f = w8 / t, r8 = 1.0 / w8;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      double sum = 0.0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) sum = fma((double)cw[j], (double)v[j][q], sum);
      const double m8 = sum * r8;
      double q8 = 0.0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const double d = (double)v[j][q] - m8;
        q8 = fma(cw[j] * d, d, q8);
      }
      const double d = m8 - mean[q];
      mean[q] += d * f;
      m2[q] += q8 + d * d * W * f;
    }
    W = t;
  }
  // the block's threads of each pack, folded in order of their slot offset
  double* s_w = sh;
  double* s_mean = sh + blockDim.x;
  double* s_m2 = s_mean + blockDim.x * P;
  s_w[threadIdx.x] = W;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    s_mean[threadIdx.x * P + q] = mean[q];
    s_m2[threadIdx.x * P + q] = m2[q];
  }
  __syncthreads();
  if (sl == 0) {
    for (int r = 1; r < k; ++r) {
      const int t = r * packs + pk;
      const double wb = s_w[t];
      if (wb <= 0.0) continue;
      const double tw = W + wb, fb = wb / tw;  // Chan's rule, the weight shared by the pack
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const double d = s_mean[t * P + q] - mean[q];
        mean[q] += d * fb;
        m2[q] += s_m2[t * P + q] + d * d * W * fb;
      }
      W = tw;
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      part_mean[(int64_t)blockIdx.x * c + c0 + q] = mean[q];
      part_m2[(int64_t)blockIdx.x * c + c0 + q] = m2[q];
    }
    if (pk == 0) part_w[blockIdx.x] = W;
  }
}

constexpr int kFoldCols = 32;
constexpr int kFoldRows = 32;

// The partials of every block folded per channel by Chan's rule: each of 32
// thread rows folds every 32nd partial in order, then one thread folds the
// 32 rows in order. stats (4, c): mean, M2, 1 / sqrt(M2 / count + eps), count,
// each computed in fp64 and rounded once to fp32; local (2, c): the mean and
// M2 in fp64, which processes combine before they round.
__global__ void oc_stage_moments_kernel(const double* __restrict__ part_w,
                                        const double* __restrict__ part_mean,
                                        const double* __restrict__ part_m2, int parts, int c,
                                        double count, double eps, float* __restrict__ stats,
                                        double* __restrict__ local) {
  __shared__ double s_w[kFoldRows][kFoldCols + 1];
  __shared__ double s_m[kFoldRows][kFoldCols + 1];
  __shared__ double s_q[kFoldRows][kFoldCols + 1];
  const int col = blockIdx.x * kFoldCols + threadIdx.x;
  double w = 0.0, m = 0.0, q = 0.0;
  if (col < c) {
    for (int p = threadIdx.y; p < parts; p += kFoldRows)
      chan(w, m, q, part_w[p], part_mean[(int64_t)p * c + col], part_m2[(int64_t)p * c + col]);
  }
  s_w[threadIdx.y][threadIdx.x] = w;
  s_m[threadIdx.y][threadIdx.x] = m;
  s_q[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && col < c) {
    for (int r = 1; r < kFoldRows; ++r)
      chan(w, m, q, s_w[r][threadIdx.x], s_m[r][threadIdx.x], s_q[r][threadIdx.x]);
    stats[col] = (float)m;
    stats[c + col] = (float)q;
    stats[2 * c + col] = (float)(1.0 / sqrt(q / count + eps));
    stats[3 * c + col] = (float)count;
    local[col] = m;
    local[c + col] = q;
  }
}

// ---- apply -------------------------------------------------------------------

// out[n, oy, ox, :] = relu((y[n, iy[oy], ix[ox], :] - mean) * a + b), NHWC; a
// grid-stride walk over (n*oh rows, runs of 8 outputs, packs)
template <typename T, int P>
__device__ __forceinline__ void apply_body(const T* __restrict__ y, T* __restrict__ out,
                                           const float* __restrict__ stats,
                                           const float* __restrict__ wt,
                                           const float* __restrict__ bs,
                                           const int* __restrict__ iy, const int* __restrict__ ix,
                                           int n, int h, int w, int c, int oh, int ow) {
  constexpr int kRun = run_of<P>();
  const int packs = c / P;
  const int runs = (ow + kRun - 1) / kRun;
  const int slots = n * oh * runs;
  const int k = gridDim.x * (blockDim.x / packs);  // slots a grid step moves
  const int slot0 = blockIdx.x * (blockDim.x / packs) + threadIdx.x / packs;
  const int c0 = (threadIdx.x % packs) * P;
  const Affine<P> f = affine<P>(stats, wt, bs, c, c0);
  Walk at(slot0, k, runs, oh);
  for (int s = slot0; s < slots; s += k, at.next()) {
    const int ox0 = at.run * kRun;
    const T* src = y + ((int64_t)at.img * h + __ldg(iy + at.row)) * w * c + c0;
    const int cnt = min(kRun, ow - ox0);
    float v[kRun][P];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (j < cnt) load_pack<T, P>(src + (int64_t)__ldg(ix + ox0 + j) * c, v[j]);
    }
    T* dst = out + (((int64_t)at.img * oh + at.row) * ow + ox0) * c + c0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (j < cnt) {
#pragma unroll
        for (int q = 0; q < P; ++q) v[j][q] = fmaxf(f.z(v[j][q], q), 0.f);
        store_pack<T, P>(dst + (int64_t)j * c, v[j]);
      }
    }
  }
}

template <typename T, int P>
__global__ void resize_nearest_bn_relu_kernel(const T* __restrict__ y, T* __restrict__ out,
                                              const float* __restrict__ stats,
                                              const float* __restrict__ wt,
                                              const float* __restrict__ bs,
                                              const int* __restrict__ iy,
                                              const int* __restrict__ ix, int n, int h, int w,
                                              int c, int oh, int ow) {
  apply_body<T, P>(y, out, stats, wt, bs, iy, ix, n, h, w, c, oh, ow);
}

// the same on a stage whose resize is the identity (its tables are)
template <typename T, int P>
__global__ void oc_stage_bn_relu_kernel(const T* __restrict__ y, T* __restrict__ out,
                                        const float* __restrict__ stats,
                                        const float* __restrict__ wt,
                                        const float* __restrict__ bs, const int* __restrict__ iy,
                                        const int* __restrict__ ix, int n, int h, int w, int c,
                                        int oh, int ow) {
  apply_body<T, P>(y, out, stats, wt, bs, iy, ix, n, h, w, c, oh, ow);
}

// ---- backward ----------------------------------------------------------------

// dy (NHWC) summed over the replicas [y0, y1) x [x0, x1) of one source
// pixel, the row's sum first, then the rows, in fp32. S: every range is at
// most 2 long (the OC branch's scales), so the loops unroll to predicated
// loads that issue together.
template <typename T, int P, bool S>
__device__ __forceinline__ void replica_sum(const T* __restrict__ g, int64_t row_stride, int c,
                                            int y0, int y1, int x0, int x1, float* acc) {
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = 0.f;
  if constexpr (S) {
    float d[2][2][P];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int q = 0; q < P; ++q) d[a][b][q] = 0.f;
        if (y0 + a < y1 && x0 + b < x1)
          load_pack<T, P>(g + (y0 + a) * row_stride + (int64_t)(x0 + b) * c, d[a][b]);
      }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int q = 0; q < P; ++q) acc[q] += d[a][0][q] + d[a][1][q];
    }
  } else {
    for (int oy = y0; oy < y1; ++oy) {
      float rs[P];
#pragma unroll
      for (int q = 0; q < P; ++q) rs[q] = 0.f;
      for (int ox = x0; ox < x1; ++ox) {
        float d[P];
        load_pack<T, P>(g + oy * row_stride + (int64_t)ox * c, d);
#pragma unroll
        for (int q = 0; q < P; ++q) rs[q] += d[q];
      }
#pragma unroll
      for (int q = 0; q < P; ++q) acc[q] += rs[q];
    }
  }
}

// Both passes walk the source pixels, block b the slots (row, run) [b*per,
// (b+1)*per) of the n*h rows of w pixels, a thread every k-th of them; each
// pixel's G is summed over its replicas, masked by its own BN output.
// SUMS (pass 1): sum G and G * x_hat per channel into part[b][c] and
// part[parts + b][c] (dynamic shared memory: blockDim * 2P floats). Else
// (pass 2): dx[n, i, j, :] (NHWC) = a * (G - rep * sum(g) / M - rep * x_hat
// * sum(g x_hat) / M), sums (2, c) and M = stats[3][c].
template <typename T, int P, bool S, bool SUMS>
__device__ __forceinline__ void source_body(const T* __restrict__ dy, const T* __restrict__ y,
                                            const float* __restrict__ stats,
                                            const float* __restrict__ wt,
                                            const float* __restrict__ bs,
                                            const double* __restrict__ sums,
                                            const int* __restrict__ ly,
                                            const int* __restrict__ hy,
                                            const int* __restrict__ lx,
                                            const int* __restrict__ hx, T* __restrict__ dx,
                                            double* __restrict__ part, int n, int h, int w,
                                            int c, int oh, int ow) {
  constexpr int kRun = run_of<P>();
  const int packs = c / P;
  const int k = blockDim.x / packs;
  const int pk = threadIdx.x % packs, sl = threadIdx.x / packs;
  const int c0 = pk * P;
  const Affine<P> f = affine<P>(stats, wt, bs, c, c0);
  const int runs = (w + kRun - 1) / kRun;
  const int slots = n * h * runs;
  const int per = (slots + gridDim.x - 1) / gridDim.x;
  const int s0 = blockIdx.x * per;
  const int s1 = min(s0 + per, slots);
  float k1[P], k2[P];
  double sg[P], sgx[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    sg[q] = sgx[q] = 0.0;
    k1[q] = k2[q] = 0.f;
    if constexpr (!SUMS) {
      const float m = stats[3 * c + c0 + q];
      k1[q] = (float)sums[c0 + q] / m;
      k2[q] = (float)sums[c + c0 + q] / m;
    }
  }
  const int64_t row_stride = (int64_t)ow * c;
  Walk at(s0 + sl, k, runs, h);
  for (int s = s0 + sl; s < s1; s += k, at.next()) {
    const int j0 = at.run * kRun;
    const int cnt = min(kRun, w - j0);
    const int y0 = __ldg(ly + at.row), y1 = __ldg(hy + at.row);
    const int64_t rowi = (int64_t)at.img * h + at.row;
    const T* src = y + (rowi * w + j0) * c + c0;
    const T* g = dy + (int64_t)at.img * oh * row_stride + c0;
    T* dst = dx + (rowi * w + j0) * c + c0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (j < cnt) {
        const int x0 = __ldg(lx + j0 + j), x1 = __ldg(hx + j0 + j);
        const float rep = (float)((y1 - y0) * (x1 - x0));
        float d[P];
#pragma unroll
        for (int q = 0; q < P; ++q) d[q] = 0.f;
        if (rep > 0.f) {
          float yv[P], big_g[P];
          load_pack<T, P>(src + (int64_t)j * c, yv);
          replica_sum<T, P, S>(g, row_stride, c, y0, y1, x0, x1, big_g);
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const float xh = __fmul_rn(__fsub_rn(yv[q], f.mean[q]), f.invstd[q]);
            // the forward's ReLU mask, on its own arithmetic
            const float gm = f.z(yv[q], q) > 0.f ? big_g[q] : 0.f;
            if constexpr (SUMS) {
              // fp64: the product exact, the sums rounded once at the end
              sg[q] += (double)gm;
              sgx[q] = fma((double)gm, (double)xh, sgx[q]);
            } else {
              // the plain version's order: a * ((G - rep k1) - (rep x_hat) k2)
              const float t = __fsub_rn(gm, __fmul_rn(rep, k1[q]));
              d[q] = __fmul_rn(f.a[q], __fsub_rn(t, __fmul_rn(__fmul_rn(rep, xh), k2[q])));
            }
          }
        }
        if constexpr (!SUMS) store_pack<T, P>(dst + (int64_t)j * c, d);
      }
    }
  }
  if constexpr (SUMS) {
    extern __shared__ double sh_sums[];
    double* s_g = sh_sums;
    double* s_gx = sh_sums + blockDim.x * P;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      s_g[threadIdx.x * P + q] = sg[q];
      s_gx[threadIdx.x * P + q] = sgx[q];
    }
    __syncthreads();
    if (sl == 0) {
      for (int r = 1; r < k; ++r) {
        const int t = r * packs + pk;
#pragma unroll
        for (int q = 0; q < P; ++q) {
          sg[q] += s_g[t * P + q];
          sgx[q] += s_gx[t * P + q];
        }
      }
      const int64_t parts = gridDim.x;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        part[(int64_t)blockIdx.x * c + c0 + q] = sg[q];
        part[(parts + blockIdx.x) * c + c0 + q] = sgx[q];
      }
    }
  }
}

#define OC_STAGE_SOURCE_KERNEL(name, sums_pass)                                               \
  template <typename T, int P, bool S>                                                        \
  __global__ void name(const T* __restrict__ dy, const T* __restrict__ y,                     \
                       const float* __restrict__ stats, const float* __restrict__ wt,         \
                       const float* __restrict__ bs, const double* __restrict__ sums,         \
                       const int* __restrict__ ly, const int* __restrict__ hy,                \
                       const int* __restrict__ lx, const int* __restrict__ hx,                \
                       T* __restrict__ dx, double* __restrict__ part, int n, int h, int w,    \
                       int c, int oh, int ow) {                                               \
    source_body<T, P, S, sums_pass>(dy, y, stats, wt, bs, sums, ly, hy, lx, hx, dx, part, n, \
                                    h, w, c, oh, ow);                                         \
  }

// pass 1; pass 2; pass 2 on a stage whose resize is the identity
OC_STAGE_SOURCE_KERNEL(oc_stage_bwd_sums_kernel, true)
OC_STAGE_SOURCE_KERNEL(resize_nearest_bn_relu_bwd_kernel, false)
OC_STAGE_SOURCE_KERNEL(oc_stage_bn_relu_bwd_kernel, false)

// ---- layout ------------------------------------------------------------------

constexpr int kTile = 64;
constexpr int kTileThreads = 256;  // 8 granules of 8 values a tile row, 32 rows a pass

// 8 neighbouring values of T at p (16-byte aligned): one 16-byte access for
// bf16, two for fp32
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, float* v) {
  if constexpr (sizeof(T) == 2) {
    load_pack<T, 8>(p, v);
  } else {
    load_pack<T, 4>(p, v);
    load_pack<T, 4>(p + 4, v + 4);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ p, const float* v) {
  if constexpr (sizeof(T) == 2) {
    store_pack<T, 8>(p, v);
  } else {
    store_pack<T, 4>(p, v);
    store_pack<T, 4>(p + 4, v + 4);
  }
}

// out[z][j][i] = in[z][i][j] (+ add[z][j][i]): image z's (rows, cols) matrix
// of Ti transposed into a (cols, rows) one of To, in 64 x 64 tiles. A thread
// reads 8 neighbouring values of an input row and writes 8 of an output row
// (16-byte accesses where `vec`: rows and cols multiples of 8, the pointers
// 16-byte aligned); the tile is fp32 in shared memory with rows of 65, so
// both sides' accesses conflict at most two ways. Sums in fp32, rounded
// once.
template <typename Ti, typename To>
__global__ void __launch_bounds__(kTileThreads)
oc_stage_layout_kernel(const Ti* __restrict__ in, const To* __restrict__ add,
                       To* __restrict__ out, int rows, int cols, int vec) {
  __shared__ float tile[kTile][kTile + 1];
  const int64_t image = (int64_t)blockIdx.z * rows * cols;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int g = threadIdx.x % 8, t = threadIdx.x / 8;
  const Ti* src = in + image;
#pragma unroll
  for (int k = 0; k < kTile / 32; ++k) {
    const int r = r0 + t + 32 * k, c = c0 + 8 * g;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
    if (r < rows) {
      const Ti* p = src + (int64_t)r * cols + c;
      if (vec && c + 8 <= cols) {
        load8<Ti>(p, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (c + e < cols) v[e] = to_f32(p[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) tile[t + 32 * k][8 * g + e] = v[e];
  }
  __syncthreads();
  To* dst = out + image;
  const To* more = add == nullptr ? nullptr : add + image;
#pragma unroll
  for (int k = 0; k < kTile / 32; ++k) {
    const int j = c0 + t + 32 * k, i = r0 + 8 * g;  // out row j, columns i .. i + 7
    if (j >= cols || i >= rows) continue;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = tile[8 * g + e][t + 32 * k];
    const int64_t at = (int64_t)j * rows + i;
    if (vec && i + 8 <= rows) {
      if (more != nullptr) {
        float a[8];
        load8<To>(more + at, a);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += a[e];
      }
      store8<To>(dst + at, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (i + e < rows) {
          if (more != nullptr) v[e] += to_f32(more[at + e]);
          dst[at + e] = from_f32<To>(v[e]);
        }
      }
    }
  }
}

// ---- launches ----------------------------------------------------------------

// threads a block: a whole number of packs' threads, about 256
inline int block_threads(int packs) {
  if (packs > 1024) return 0;
  return packs >= 256 ? packs : packs * (256 / packs);
}

// the walks count slots in int: a map must leave them, and a grid step's
// worth more, below 2^31
inline bool fits(int64_t slots) { return slots + (int64_t)sm_count() * 8 * 1024 < INT32_MAX; }

template <typename T, int P>
cudaError_t launch_stats(const void* y, const int* ly, const int* hy, const int* lx,
                         const int* hx, double* part, int parts, int n, int h, int w, int c,
                         double count, double eps, float* stats, double* local,
                         cudaStream_t s) {
  const int threads = block_threads(c / P);
  const int64_t slots = (int64_t)n * h * ((w + run_of<P>() - 1) / run_of<P>());
  if (threads == 0 || parts <= 0 || !fits(slots)) return cudaErrorInvalidValue;
  double* part_w = part;
  double* part_mean = part + parts;
  double* part_m2 = part_mean + (int64_t)parts * c;
  oc_stage_stats_kernel<T, P><<<parts, threads, sizeof(double) * threads * (1 + 2 * P), s>>>(
      (const T*)y, ly, hy, lx, hx, part_w, part_mean, part_m2, n, h, w, c);
  const dim3 block(kFoldCols, kFoldRows);
  oc_stage_moments_kernel<<<(c + kFoldCols - 1) / kFoldCols, block, 0, s>>>(
      part_w, part_mean, part_m2, parts, c, count, eps, stats, local);
  return cudaSuccess;
}

template <typename T, int P>
cudaError_t launch_apply(const void* y, void* out, const float* stats, const float* wt,
                         const float* bs, const int* iy, const int* ix, int n, int h, int w,
                         int c, int oh, int ow, int identity, cudaStream_t s) {
  const int threads = block_threads(c / P);
  const int64_t slots = (int64_t)n * oh * ((ow + run_of<P>() - 1) / run_of<P>());
  if (threads == 0 || !fits(slots)) return cudaErrorInvalidValue;
  const int grid = grid_for(slots, threads / (c / P), 8);
  auto kernel = identity ? &oc_stage_bn_relu_kernel<T, P> : &resize_nearest_bn_relu_kernel<T, P>;
  kernel<<<grid, threads, 0, s>>>((const T*)y, (T*)out, stats, wt, bs, iy, ix, n, h, w, c, oh,
                                  ow);
  return cudaSuccess;
}

template <typename T, int P, bool S>
cudaError_t launch_bwd_route(const void* dy, const void* y, const float* stats, const float* wt,
                             const float* bs, const int* ly, const int* hy, const int* lx,
                             const int* hx, double* part, int parts, double* sums, void* dx,
                             int n, int h, int w, int c, int oh, int ow, int identity,
                             int passes, cudaStream_t s) {
  const int threads = block_threads(c / P);
  const int64_t slots = (int64_t)n * h * ((w + run_of<P>() - 1) / run_of<P>());
  if (threads == 0 || !fits(slots)) return cudaErrorInvalidValue;
  if (passes & 1) {
    if (parts <= 0) return cudaErrorInvalidValue;
    oc_stage_bwd_sums_kernel<T, P, S><<<parts, threads, sizeof(double) * threads * 2 * P, s>>>(
        (const T*)dy, (const T*)y, stats, wt, bs, sums, ly, hy, lx, hx, (T*)dx, part, n, h, w,
        c, oh, ow);
    launch_reduce_partials<double>(part, part + (int64_t)parts * c, parts, c, sums, sums + c, s);
  }
  if (passes & 2) {
    auto kernel = identity ? &oc_stage_bn_relu_bwd_kernel<T, P, S>
                           : &resize_nearest_bn_relu_bwd_kernel<T, P, S>;
    kernel<<<grid_for(slots, threads / (c / P), 8), threads, 0, s>>>(
        (const T*)dy, (const T*)y, stats, wt, bs, sums, ly, hy, lx, hx, (T*)dx, part, n, h, w,
        c, oh, ow);
  }
  return cudaSuccess;
}

// short_ranges: every [lo, hi) range of both tables is at most 2 long
template <typename T, int P>
cudaError_t launch_bwd(const void* dy, const void* y, const float* stats, const float* wt,
                       const float* bs, const int* ly, const int* hy, const int* lx,
                       const int* hx, double* part, int parts, double* sums, void* dx, int n, int h,
                       int w, int c, int oh, int ow, int identity, int short_ranges, int passes,
                       cudaStream_t s) {
  auto launch = short_ranges ? &launch_bwd_route<T, P, true> : &launch_bwd_route<T, P, false>;
  return launch(dy, y, stats, wt, bs, ly, hy, lx, hx, part, parts, sums, dx, n, h, w, c, oh, ow,
                identity, passes, s);
}

template <typename Ti, typename To>
cudaError_t launch_layout(const void* in, const void* add, void* out, int images, int rows,
                          int cols, cudaStream_t s) {
  const int vec = rows % 8 == 0 && cols % 8 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(add) % 16 == 0;
  const dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile, images);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  oc_stage_layout_kernel<Ti, To><<<grid, kTileThreads, 0, s>>>((const Ti*)in, (const To*)add,
                                                               (To*)out, rows, cols, vec);
  return cudaSuccess;
}

// The route of a dtype (0 = float32, 1 = bfloat16) and a pack: channels a
// thread's access moves, 16 bytes' worth (4 fp32, 8 bf16) or one value
inline int route_of(int dtype, int pack) {
  if (dtype == 0) return pack == 1 ? 0 : (pack == 4 ? 1 : -1);
  if (dtype == 1) return pack == 1 ? 2 : (pack == 8 ? 3 : -1);
  return -1;
}

#define OC_STAGE_ROUTE(launch, ...)                                                         \
  switch (route_of(dtype, pack)) {                                                         \
    case 0:                                                                                 \
      err = launch<float, 1>(__VA_ARGS__);                                                  \
      break;                                                                                \
    case 1:                                                                                 \
      err = launch<float, 4>(__VA_ARGS__);                                                  \
      break;                                                                                \
    case 2:                                                                                 \
      err = launch<__nv_bfloat16, 1>(__VA_ARGS__);                                          \
      break;                                                                                \
    case 3:                                                                                 \
      err = launch<__nv_bfloat16, 8>(__VA_ARGS__);                                          \
      break;                                                                                \
    default:                                                                                \
      return (int)cudaErrorInvalidValue;                                                    \
  }

}  // namespace

// The stage entries take the map y (n, h, w, c) NHWC-contiguous of `dtype`
// (0 = float32, 1 = bfloat16), `pack` channels an access moves (1; 4 for
// fp32 and 8 for bf16 where c is a multiple and every map's pointer 16-byte
// aligned), the tables of ops/resize.py (int32), and return
// cudaGetLastError() after their launches, or cudaErrorInvalidValue for
// arguments they do not take.
//
// Statistics: part (parts * (1 + 2c),) fp64 scratch, parts the blocks of
// the first kernel; stats (4, c) fp32: the mean, M2, 1/sqrt(M2/count + eps)
// and count over the resized map's count values per channel; local (2, c)
// fp64: the mean and M2 unrounded.
extern "C" int mrfp_oc_stage_stats(const void* y, const void* ly, const void* hy, const void* lx,
                                   const void* hx, void* part, int parts, int n, int h, int w,
                                   int c, double count, double eps, void* stats, void* local,
                                   int dtype, int pack, void* stream) {
  if (c <= 0 || c % pack || (int64_t)n * h * w == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* y0 = (const int*)ly;
  const int* y1 = (const int*)hy;
  const int* x0 = (const int*)lx;
  const int* x1 = (const int*)hx;
  double* pt = (double*)part;
  float* st = (float*)stats;
  double* lo = (double*)local;
  cudaError_t err;
  OC_STAGE_ROUTE(launch_stats, y, y0, y1, x0, x1, pt, parts, n, h, w, c, count, eps, st, lo, s)
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Apply: out (n, oh, ow, c) NHWC; iy (oh,), ix (ow,) the source tables; w, b
// the BN weight and bias (c,) fp32; identity: the tables are the identity
// (the kernel's name then names no resize).
extern "C" int mrfp_oc_stage_apply(const void* y, void* out, const void* stats, const void* wt,
                                   const void* bs, const void* iy, const void* ix, int n, int h,
                                   int w, int c, int oh, int ow, int identity, int dtype,
                                   int pack, void* stream) {
  if (c <= 0 || c % pack) return (int)cudaErrorInvalidValue;
  if ((int64_t)n * oh * ow == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const float* st = (const float*)stats;
  const float* fw = (const float*)wt;
  const float* fb = (const float*)bs;
  const int* ty = (const int*)iy;
  const int* tx = (const int*)ix;
  cudaError_t err;
  OC_STAGE_ROUTE(launch_apply, y, out, st, fw, fb, ty, tx, n, h, w, c, oh, ow, identity, s)
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Backward: dy (n, oh, ow, c) NHWC, the output's cotangent; y and stats as
// saved by the forward; ly, hy, lx, hx the tables' [lo, hi) ranges; part (2
// * parts * c,) fp64 scratch and sums (2, c) fp64, pass 1's output and pass
// 2's input (rounded there to fp32); dx (n, h, w, c) NHWC in y's
// dtype. short_ranges: no range is longer than 2 (the sums unroll). passes:
// 1 = pass 1 (part, then sums), 2 = pass 2 (from sums, as a caller may have
// reduced them over processes), 3 = both.
extern "C" int mrfp_oc_stage_bwd(const void* dy, const void* y, const void* stats,
                                 const void* wt, const void* bs, const void* ly, const void* hy,
                                 const void* lx, const void* hx, void* part, int parts,
                                 void* sums, void* dx, int n, int h, int w, int c, int oh, int ow,
                                 int identity, int short_ranges, int passes, int dtype, int pack,
                                 void* stream) {
  if (c <= 0 || c % pack || passes < 1 || passes > 3) return (int)cudaErrorInvalidValue;
  if ((int64_t)n * h * w == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const float* st = (const float*)stats;
  const float* fw = (const float*)wt;
  const float* fb = (const float*)bs;
  const int* y0 = (const int*)ly;
  const int* y1 = (const int*)hy;
  const int* x0 = (const int*)lx;
  const int* x1 = (const int*)hx;
  double* pt = (double*)part;
  double* sm = (double*)sums;
  cudaError_t err;
  OC_STAGE_ROUTE(launch_bwd, dy, y, st, fw, fb, y0, y1, x0, x1, pt, parts, sm, dx, n, h, w, c, oh,
                 ow, identity, short_ranges, passes, s)
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Layout: out[z] = in[z]^T (+ add[z]) for each of `images` (rows, cols)
// matrices: NCHW -> NHWC with (rows, cols) = (c, h*w), NHWC -> NCHW with
// (h*w, c). in_dtype, out_dtype: 0 = float32, 1 = bfloat16 (a cast on the
// way); add: null, or an out-shaped map of out_dtype.
extern "C" int mrfp_oc_stage_layout(const void* in, const void* add, void* out, int images,
                                    int rows, int cols, int in_dtype, int out_dtype,
                                    void* stream) {
  if ((int64_t)images * rows * cols == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (in_dtype * 2 + out_dtype) {
    case 0:
      err = launch_layout<float, float>(in, add, out, images, rows, cols, s);
      break;
    case 1:
      err = launch_layout<float, __nv_bfloat16>(in, add, out, images, rows, cols, s);
      break;
    case 2:
      err = launch_layout<__nv_bfloat16, float>(in, add, out, images, rows, cols, s);
      break;
    case 3:
      err = launch_layout<__nv_bfloat16, __nv_bfloat16>(in, add, out, images, rows, cols, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
