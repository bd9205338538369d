// A 1x1 convolution that also emits the per-channel BatchNorm sums of its
// output: for each sample n of an NCHW-contiguous x (N, Cin, HW) and a weight
// w (Cout, Cin),
//
//   y[n] = w @ x[n]                                  (Cout, HW), x's dtype
//   s1[c] = sum over n, p of y[n, c, p]              fp32
//   s2[c] = sum over n, p of y[n, c, p]^2            fp32
//
// Replaces the TPU kernel mrfp_tpu/ops/pallas_dot_stats.py::dot_with_stats
// (_kernel). The TPU kernel walks row tiles of the flattened (N*H*W, Cin) map
// in order on one core and carries the sums from one grid step to the next in
// VMEM scratch. Here blocks run in parallel and in no order, so each block
// writes the sums of its own tile to a partial row, and a second kernel adds
// the partial rows in a fixed order (common.cuh): two runs agree bit for bit,
// where fp32 atomics would not. As on the TPU, the sums are of the STORED
// value: y is rounded to its dtype first, and the rounded value and its
// square are summed, so BatchNorm sees exactly what the next layer sees.
// The sums are taken in fp64 (the square of an fp32 value is exact there)
// and rounded once to fp32, so they hardly depend on the order of the
// terms: the plain version, which sums the same stored values in fp64 in
// torch's order, gives the same fp32 sums wherever the two y agree (in fp32
// they agree bit for bit with cuBLAS's unless cuBLAS splits K). fp32 sums in
// two orders differ in their last bits, and an fp32 step on random weights
// amplifies a change of that size to percents of the early gradients
// (ROADMAP C3). The epilogue's fp64 adds are a few hundred a thread against
// the main loop's Cin * 64 FMAs.
//
// The GEMM reads NCHW directly, with no transposes: per sample it is
// (Cout x Cin) @ (Cin x HW), and HW is the contiguous axis of both x and y.
// Two kernels compute it, chosen by dtype and shape before the launch
// (ops/cuda_dot_stats.py::tensor_core_route); mrfp_dot_with_stats_parts
// tells the wrapper how many partial rows the chosen one writes.
//
// bf16 with Cin % 8 == 0 and HW % 8 == 0 (every site of the train step):
// the tensor-core kernel. What bounds it on Hopper: bytes. The 36 bottleneck
// 1x1s of a batch-8 768x768 step do 0.60 TFLOP (0.61 ms at 989 TFLOP/s) and
// move 3.5 GB (1.06 ms at 3.35 TB/s); the CUDA-core loop reached 9-19
// TFLOP/s, 33x the bound. A block of two warpgroups computes 128-channel x
// 128-pixel tiles of one sample with wgmma (m64n128k16, bf16 in, fp32
// accumulate), one warpgroup per 64 channels. Its operands come by TMA into a
// ring of four 32 KB shared-memory stages (w: 128 x 64 channels, K
// contiguous; x: 64 channels x 2 boxes of 64 pixels, pixels contiguous, read
// by wgmma through its transpose bit), all with the 128-byte swizzle, each
// stage completing on an mbarrier; thread 0 refills a stage as soon as both
// warpgroups have retired the wgmma that read it, so three stages of loads
// are in flight behind the one being multiplied. TMA zero-fills any ragged
// edge (Cout, Cin or HW past the tensor), so the tile's products are exact
// there. The tensor maps are encoded on the host through
// cudaGetDriverEntryPoint, so the library links nothing new.
//
// A block walks several consecutive pixel tiles of its sample (the grid is
// about one block an SM), and its ring runs on across tile boundaries: the
// next tile's loads are in flight while this tile's epilogue runs, which
// matters where Cin is 64-256 and a tile is one to four stages deep. The
// epilogue rounds the accumulators to bf16, writes them into a staging
// buffer in the swizzled box layout (no bank conflicts) and leaves in TMA
// stores, which clip the ragged edge; each thread adds its two rows' stored
// values to fp64 sums it carries across the block's tiles, the four lanes
// of a row add theirs in a fixed butterfly at the end, and one partial row
// per block goes out: few partial rows, so the fixed-order second pass is
// short.
//
// fp32, and bf16 shapes the tensor maps cannot take (rows not 16-byte
// aligned): the CUDA-core kernel. A block computes a 64-channel x
// 128-pixel tile of one sample; per step of 16 input channels it stages the
// w tile (k-major) and the x tile in shared memory as fp32, and each of its
// 128 threads accumulates an 8 x 8 patch in fp32 registers with FMAs. A
// thread's patch is two 4-row by two 4-column quarters 32 rows / 64 columns
// apart, so its float4 reads of shared memory do not conflict. Ragged edges
// (any Cout, Cin, HW) are zero-filled on load and masked on store. It keeps
// fp32 exact (no TF32): the fp32 fused step is the parity check, not the
// hot path.

#include <cuda.h>  // CUtensorMap and its enums (no libcuda link: see encoder())

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kBM = 64;       // output channels per block
constexpr int kBN = 128;      // pixels per block
constexpr int kBK = 16;       // input channels per step
constexpr int kThreads = 128; // 8 channel groups x 16 pixel groups, 8 x 8 each
constexpr int kPadA = 4;      // keeps the transposed w-tile stores off one bank

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_stats_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                 double* __restrict__ part1, double* __restrict__ part2, int cin, int cout,
                 int hw) {
  __shared__ __align__(16) float as[kBK][kBM + kPadA];
  __shared__ __align__(16) float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // pixel group: columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid >> 4;  // channel group: rows ty*4 .. +3 and 32 + ty*4 .. +3
  const int n = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kBN;
  const T* xn = x + (int64_t)n * cin * hw;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += kBK) {
    // w tile (kBM x kBK): consecutive threads read consecutive input channels
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int m = idx / kBK, k = idx % kBK;
      const int gm = m0 + m, gk = k0 + k;
      as[k][m] = (gm < cout && gk < cin) ? to_f32(w[(int64_t)gm * cin + gk]) : 0.f;
    }
    // x tile (kBK x kBN): consecutive threads read consecutive pixels
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int k = idx / kBN, j = idx % kBN;
      const int gk = k0 + k, gj = j0 + j;
      bs[k][j] = (gk < cin && gj < hw) ? to_f32(xn[(int64_t)gk * hw + gj]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][32 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: round, store, and sum the stored values per channel
  T* yn = y + (int64_t)n * cout * hw;
  const int64_t prow = (int64_t)n * gridDim.x + blockIdx.x;  // this tile's partial row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + (i - 4));
    double s1 = 0.0, s2 = 0.0;
    if (m < cout) {
      T* row = yn + (int64_t)m * hw;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
        if (c < hw) {
          const T v = from_f32<T>(acc[i][j]);
          row[c] = v;
          const double f = to_f32(v);
          s1 += f;
          s2 += f * f;
        }
      }
    }
    // the 16 pixel groups of this channel are the 16 lanes of one half warp:
    // a butterfly over them adds in a fixed order
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (tx == 0 && m < cout) {
      part1[prow * cout + m] = s1;
      part2[prow * cout + m] = s2;
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, double* part1, double* part2, int n, int cin,
            int cout, int hw, cudaStream_t s) {
  const dim3 grid((hw + kBN - 1) / kBN, (cout + kBM - 1) / kBM, n);
  dot_stats_kernel<T><<<grid, kThreads, 0, s>>>((const T*)x, (const T*)w, (T*)y, part1, part2,
                                                cin, cout, hw);
}

// --- the tensor-core kernel (bf16) ----------------------------------------

constexpr int kTcBM = 128;                          // output channels per block
constexpr int kTcBN = 128;                          // pixels per block
constexpr int kTcBK = 64;                           // input channels per stage
constexpr int kTcStages = 4;
constexpr int kTcThreads = 256;                     // two warpgroups
constexpr int kTcABytes = kTcBM * kTcBK * 2;        // w: 128 rows of 128 B
constexpr int kTcBHalf = kTcBK * 64 * 2;            // x: 64 rows of 64 pixels (128 B)
constexpr int kTcStageBytes = kTcABytes + 2 * kTcBHalf;
constexpr int kTcYBytes = kTcBM * kTcBN * 2;        // the y tile's staging buffer
constexpr int kTcSmemBytes = kTcStages * kTcStageBytes + kTcYBytes + 1024 + 8 * kTcStages;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

// d += A (64 x 16, K-major) @ B (16 x 128, pixels contiguous: transpose bit)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// (Cout, Cin) w, x (n, Cin, HW) and y (n, Cout, HW) through their tensor maps.
// Block (bx, by, n) computes channels 128 bx on, pixel tiles by * per_block
// on (at most per_block of them, 128 pixels each) of sample n, and writes the
// sums of its stored y to partial row n * gridDim.y + by.
__global__ void __launch_bounds__(kTcThreads, 1)
dot_stats_tc_kernel(const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_y, double* __restrict__ part1,
                    double* __restrict__ part2, int cin, int cout, int hw, int per_block) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms sit on 1024 B
  unsigned char* ytile = smem_raw + (base - raw) + kTcStages * kTcStageBytes;
  const uint32_t bars = base + kTcStages * kTcStageBytes + kTcYBytes;  // "full", one a stage
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int m0 = blockIdx.x * kTcBM, n = blockIdx.z;
  const int tile0 = blockIdx.y * per_block;
  const int tiles = min(per_block, (hw + kTcBN - 1) / kTcBN - tile0);
  const int kt = (cin + kTcBK - 1) / kTcBK;
  const int steps = tiles * kt;  // step q: k block q % kt of pixel tile q / kt

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int q) {
    const int s = q % kTcStages, k0 = (q % kt) * kTcBK, j0 = (tile0 + q / kt) * kTcBN;
    const uint32_t st = base + s * kTcStageBytes, bar = bars + 8 * s;
    mbar_expect_tx(bar, kTcStageBytes);
    tma_load_2d(st, &map_w, k0, m0, bar);
    tma_load_3d(st + kTcABytes, &map_x, j0, k0, n, bar);
    tma_load_3d(st + kTcABytes + kTcBHalf, &map_x, j0 + 64, k0, n, bar);
  };
  if (tid == 0)
    for (int q = 0; q < kTcStages && q < steps; ++q) load(q);

  // accumulator layout: thread t of the warpgroup holds rows ra = 16 * warp +
  // lane / 4 and ra + 8, columns 8 j + 2 (lane % 4) + {0, 1}, j = 0 .. 15
  const int t = tid & 127, lane = tid & 31;
  const int ra = (t >> 5) * 16 + (lane >> 2), rb = ra + 8;
  unsigned char* tile = ytile + wg * (2 * kTcBHalf);  // two 64 x 64 boxes, swizzled
  double a1 = 0.0, a2 = 0.0, b1 = 0.0, b2 = 0.0;      // this block's sums, rows ra and rb
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int q = 0; q < steps; ++q) {
    const int s = q % kTcStages, kb = q % kt;
    const uint32_t st = base + s * kTcStageBytes;
    mbar_wait(bars + 8 * s, (q / kTcStages) & 1);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      // A: this warpgroup's 64 rows, 16 channels on (32 B within the 128 B row);
      // B: 16 channel rows on (2 KB), the two 64-pixel boxes 8 KB apart
      const uint64_t a = sw128_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t b = sw128_desc(st + kTcABytes + kk * 16 * 128, kTcBHalf, 1024);
      wgmma_m64n128k16(d, a, b);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (kb == kt - 1) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // the tile is done
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // q - 1 retired
    }
    __syncthreads();  // ... in both warpgroups: thread 0 may refill step q - 1's stage
    if (tid == 0 && q >= 1 && q - 1 + kTcStages < steps) load(q - 1 + kTcStages);
    if (kb != kt - 1) continue;

    // the epilogue of pixel tile q / kt, while the next tile's loads fly
    const int j0 = (tile0 + q / kt) * kTcBN;
    if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the staging is free
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const int cc = c & 63;
      unsigned char* box = tile + (j >> 3) * kTcBHalf;
      const __nv_bfloat162 va = __float22bfloat162_rn(make_float2(d[4 * j], d[4 * j + 1]));
      const __nv_bfloat162 vb = __float22bfloat162_rn(make_float2(d[4 * j + 2], d[4 * j + 3]));
      *reinterpret_cast<__nv_bfloat162*>(box + ra * 128 + (((cc >> 3) ^ (ra & 7)) << 4) +
                                         (cc & 7) * 2) = va;
      *reinterpret_cast<__nv_bfloat162*>(box + rb * 128 + (((cc >> 3) ^ (rb & 7)) << 4) +
                                         (cc & 7) * 2) = vb;
      if (j0 + c < hw) {  // HW is even and c is even: c + 1 is in too
        const float2 fa = __bfloat1622float2(va), fb = __bfloat1622float2(vb);
        a1 += (double)fa.x;
        a2 += (double)fa.x * fa.x;
        a1 += (double)fa.y;
        a2 += (double)fa.y * fa.y;
        b1 += (double)fb.x;
        b2 += (double)fb.x * fb.x;
        b1 += (double)fb.y;
        b2 += (double)fb.y * fb.y;
      }
      d[4 * j] = d[4 * j + 1] = d[4 * j + 2] = d[4 * j + 3] = 0.f;
    }
    // the tile's generic stores, then the warpgroup's TMA stores (which clip)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (t == 0 && m0 + wg * 64 < cout) {
      for (int h = 0; h < 2; ++h)
        if (j0 + h * 64 < hw)
          tma_store_3d(&map_y, smem_u32(tile + h * kTcBHalf), j0 + h * 64, m0 + wg * 64, n);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // the four lanes of a row, in a fixed order
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    a2 += __shfl_xor_sync(0xffffffffu, a2, off);
    b1 += __shfl_xor_sync(0xffffffffu, b1, off);
    b2 += __shfl_xor_sync(0xffffffffu, b2, off);
  }
  const int64_t prow = (int64_t)n * gridDim.y + blockIdx.y;
  const int ma = m0 + wg * 64 + ra, mb = m0 + wg * 64 + rb;
  if ((lane & 3) == 0) {
    if (ma < cout) {
      part1[prow * cout + ma] = a1;
      part2[prow * cout + ma] = a2;
    }
    if (mb < cout) {
      part1[prow * cout + mb] = b1;
      part2[prow * cout + mb] = b2;
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// How the tensor-core kernel splits a sample's pixel tiles: blocks of
// `per_block` consecutive tiles, `groups` of them, so that the whole grid
// (channel tiles x groups x samples) is about one block an SM.
struct TcSplit {
  int per_block, groups;
};

TcSplit tc_split(int n, int cout, int hw) {
  const int tiles = (hw + kTcBN - 1) / kTcBN;
  const int64_t others = (int64_t)((cout + kTcBM - 1) / kTcBM) * n;
  const int want = (int)std::max<int64_t>(1, std::min<int64_t>(tiles, sm_count() / others));
  const int per_block = (tiles + want - 1) / want;
  return {per_block, (tiles + per_block - 1) / per_block};
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 map with the 128-byte swizzle; dims innermost first, strides in bytes.
bool encode_bf16(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int rank,
                 const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_tc(const void* x, const void* w, void* y, double* part1, double* part2, int n,
                      int cin, int cout, int hw, cudaStream_t s) {
  if (cin <= 0 || cin % 8 || hw % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) & 15)
    return cudaErrorInvalidValue;  // the maps need 16-byte aligned rows
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap mw, mx, my;
  const cuuint64_t dw[2] = {(cuuint64_t)cin, (cuuint64_t)cout}, sw[1] = {(cuuint64_t)cin * 2};
  const cuuint32_t bw[2] = {kTcBK, kTcBM};
  const cuuint64_t dx[3] = {(cuuint64_t)hw, (cuuint64_t)cin, (cuuint64_t)n};
  const cuuint64_t sx[2] = {(cuuint64_t)hw * 2, (cuuint64_t)hw * cin * 2};
  const cuuint32_t bx[3] = {64, kTcBK, 1};
  const cuuint64_t dy[3] = {(cuuint64_t)hw, (cuuint64_t)cout, (cuuint64_t)n};
  const cuuint64_t sy[2] = {(cuuint64_t)hw * 2, (cuuint64_t)hw * cout * 2};
  const cuuint32_t by[3] = {64, 64, 1};
  if (!encode_bf16(fn, &mw, w, 2, dw, sw, bw) || !encode_bf16(fn, &mx, x, 3, dx, sx, bx) ||
      !encode_bf16(fn, &my, y, 3, dy, sy, by))
    return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        dot_stats_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemBytes);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const TcSplit split = tc_split(n, cout, hw);
  if (split.groups > 65535) return cudaErrorInvalidValue;  // grid.y
  const dim3 grid((cout + kTcBM - 1) / kTcBM, split.groups, n);
  dot_stats_tc_kernel<<<grid, kTcThreads, kTcSmemBytes, s>>>(mw, mx, my, part1, part2, cin,
                                                             cout, hw, split.per_block);
  return cudaSuccess;
}

}  // namespace

// The number of partial rows the caller allocates, (2, parts, cout) fp64:
// one per 128-pixel tile and sample for the CUDA-core kernel, one per group
// of tiles and sample for the tensor-core kernel.
extern "C" int mrfp_dot_with_stats_parts(int n, int cout, int hw, int tensor_cores) {
  if (n <= 0 || cout <= 0 || hw <= 0) return 0;
  if (tensor_cores) return n * tc_split(n, cout, hw).groups;
  return n * ((hw + kBN - 1) / kBN);
}

// x (n, cin, hw), w (cout, cin), y (n, cout, hw): contiguous, all of `dtype`
// (0 = float32, 1 = bfloat16); part: (2, parts, cout) fp64 scratch; s1, s2:
// (cout,) fp32; tensor_cores: 1 for the tensor-core kernel (bf16, cin and hw
// multiples of 8, 16-byte aligned pointers), 0 for the CUDA-core kernel.
// Returns cudaGetLastError() after the launches.
extern "C" int mrfp_dot_with_stats(const void* x, const void* w, void* y, void* part, int parts,
                                   void* s1, void* s2, int n, int cin, int cout, int hw,
                                   int dtype, int tensor_cores, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cout <= 0) return (int)cudaSuccess;
  if (n <= 0 || hw <= 0) {
    cudaMemsetAsync(s1, 0, sizeof(float) * cout, s);
    cudaMemsetAsync(s2, 0, sizeof(float) * cout, s);
    return (int)cudaGetLastError();
  }
  const int tiles_y = (cout + kBM - 1) / kBM;
  if (parts != mrfp_dot_with_stats_parts(n, cout, hw, tensor_cores) || n > 65535 ||
      tiles_y > 65535)
    return (int)cudaErrorInvalidValue;
  double* part1 = (double*)part;
  double* part2 = part1 + (int64_t)parts * cout;
  if (tensor_cores) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    const cudaError_t err = launch_tc(x, w, y, part1, part2, n, cin, cout, hw, s);
    if (err != cudaSuccess) return (int)err;
  } else if (dtype == 0) {
    launch<float>(x, w, y, part1, part2, n, cin, cout, hw, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, y, part1, part2, n, cin, cout, hw, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_reduce_partials(part1, part2, parts, cout, (float*)s1, (float*)s2, s);
  return (int)cudaGetLastError();
}
