// 3x3 convolution (stride 1, zero padding 1) with optional per-channel
// statistics, for Hopper (sm_90a). Two kernels; the wrapper's route
// (conv3x3.py:kernel_route) and the entry points below pick by shape and type:
//   * conv3x3_mma_kernel: bf16 with Cin == Cout == 64 (any B, H, W): the
//     products run on the tensor cores. This is the shape of the port's main
//     path (layer1 of the ResNets at 56 x 56);
//   * conv3x3_kernel: everything else the wrapper accepts (f32, or channel
//     counts other than 64, multiples of 8): f32 FMAs on widened values.
//
// Both replace tools/fused_conv_bn_bench.py:pallas_conv3x3 (kernel
// _conv_kernel): for x (B, H, W, Cin) NHWC and nine (Cin, Cout) taps, nine
// shifted (H*W, Cin) x (Cin, Cout) products accumulated in f32, plus a bias,
// rounded to x's type; with stats also the per-channel sum and sum of
// squares of the f32 accumulator (bias included, before the rounding) over
// all B*H*W positions. The TPU kernel takes one pre-padded image per grid
// step and carries the statistics across the ordered grid.
//
// Bound in bf16 at (64, 56, 56, 64) -> 64: 51.4 MB moved and 14.8 GFLOP, so
// bytes (at 3.35 TB/s) and tensor-core operations (at 989 TFLOP/s) bound it
// about equally, 0.015 ms each: the design has to keep both busy at once.
//
// conv3x3_mma_kernel, an implicit GEMM (M = pixels, N = 64, K = 9 * 64):
//   * one persistent block of 8 warps (two warpgroups) per SM. It loads all
//     nine taps' bf16 weights (73,728 bytes) into shared memory once and then
//     walks pixel tiles in a static order (tile = block + i * grid), so which
//     block sums which tile, and with it the statistics, is the same on
//     every run;
//   * a tile is 8 x 28 output pixels: 56 = 7 x 8 = 2 x 28, so a 56 x 56
//     image is tiled exactly (8 x 16 would waste 12.5 % of every row of
//     tiles) and the (8+2) x (28+2) halo costs 1.34 reads per pixel (8 x 8
//     costs 1.56), most of them from L2. The halo tile comes by cp.async in
//     16-byte pieces, zero-filled (src-size 0) outside the image: no padded
//     copy of x and no branch in the MMA loop. Two halo buffers: the copy
//     of tile i + 1 is in flight under the MMAs of tile i, one barrier a
//     tile;
//   * wgmma.m64n64k16 (bf16 in, f32 out), 9 taps x 4 k16 steps a tile. B,
//     the weights, is read by the tensor cores straight from shared memory
//     through a descriptor: a tap's 64 rows (cout) of 128 bytes (cin) in the
//     128-byte swizzle, chunk c of row r at c ^ (r & 7). A cannot go by
//     descriptor: for a tap the 64 pixel rows of an A tile lie at (y + dy,
//     x + dx) in the halo and a tile row ends after 28 pixels, so they are
//     no matrix with one row stride. Each warp gathers its 16 rows with
//     ldmatrix.x4 (every lane gives the address of its own pixel's 16-byte
//     chunk) and hands them to wgmma in registers. A warpgroup owns two m64
//     blocks of the tile's 224 pixels (the last half block is padding, an
//     eighth of the MMAs); the fragments of step s + 1 are loaded while the
//     MMA groups s - 1 and s run. A pixel's 128 bytes in the halo are stored
//     like a weight row, except that the halo's row stride is 32 pixels and
//     bit 2 of the swizzle is flipped in odd halo rows: the eight rows of
//     every ldmatrix 8 x 8 then hit eight different bank groups, also where
//     eight pixels of the 28-wide tile step into the next row;
//   * epilogue from registers: + bias, statistics, round to bf16, a 4 x 4
//     transpose inside each quad by shuffles so that a lane owns 8
//     consecutive channels, 16-byte stores (a quad writes 64 contiguous
//     bytes of a pixel). Statistics: a lane carries its channels' sums across
//     all its tiles, the warp adds its lanes by a fixed shuffle tree, the
//     block adds its warps in order, and conv3x3_combine_kernel adds the
//     blocks' partials in order. No atomics.
//
// Measured on an H100 (chip_smoke.py): 0.048 ms at batch 64 against cuDNN's
// 0.081, 32 % of the bound (the same design with mma.sync.m16n8k16 and B by
// ldmatrix, 7 warps of 32 pixels each: 0.053 ms). What holds it there: an
// m64n64k16 step reads 2 KB of A and 2 KB of B from shared memory for 32
// clocks of tensor work, which is all of the SM's 128 bytes a clock, and the
// eight warps run in step, so the tensor cores idle while all of them copy
// the next halo and while all of them store. A producer warp for the copies
// and two consumer warpgroups a tile apart (one storing while the other
// multiplies) is the step after this one.
//
// conv3x3_kernel (the simple, exact version, at 53 % of the f32 FMA peak):
//   * no padded copy of x: a block loads its (8+2) x (16+2) halo tile into
//     shared memory and writes zeros for positions outside the image;
//   * a block of 128 threads computes 8 x 16 output pixels x 64 output
//     channels; a thread holds 8 pixels (one tile column) x 8 channels in
//     registers. Cin is walked in chunks of 16: the chunk of the input tile
//     and of all nine weight taps sits in shared memory as f32 (48,384
//     bytes, so four blocks fit an SM). Eight threads that share a tile
//     column read the same x values (a broadcast) and 128 contiguous bytes
//     of weights, so the 16-byte shared loads have no bank conflicts;
//   * statistics: each block reduces its tile in shared memory, in a fixed
//     order, to one f32 partial per channel; a second kernel adds the
//     partials in a fixed order. No atomics: the same result on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int kTH = 8;        // tile rows = pixels per thread
constexpr int kTW = 16;       // tile columns = pixel groups per block
constexpr int kTC = 64;       // output channels per block
constexpr int kKC = 16;       // input channels per shared-memory chunk
constexpr int kThreads = 128;
constexpr int kHaloW = kTW + 2;
constexpr int kHaloH = kTH + 2;
constexpr int kXs = kHaloH * kHaloW * kKC;  // floats of the input chunk
constexpr int kWs = 9 * kKC * kTC;          // floats of the weight chunk

// 16 bytes of input as floats: 4 f32 or 8 bf16.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* dst) {
    *reinterpret_cast<float4*>(dst) =
        __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* dst) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float2 f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __bfloat1622float2(h[i]);
    *reinterpret_cast<float4*>(dst) =
        make_float4(f[0].x, f[0].y, f[1].x, f[1].y);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(f[2].x, f[2].y, f[3].x, f[3].y);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p,
                                                const float* v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&lo);
    raw.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// x: (B, H, W, Cin) of T; w: (9, Cin, Cout) f32, tap-major (dy * 3 + dx);
// bias: (Cout,) f32 or null; out: (B, H, W, Cout) of T. part_sum/part_sq:
// (gridDim.x, Cout) f32 or null. The wrapper guarantees Cin % 8 == 0,
// Cout % 8 == 0 and 16-byte aligned pointers.
template <typename T, bool kStats>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out, int H,
                   int W, int Cin, int Cout, int tiles_x, int tiles_y,
                   float* __restrict__ part_sum, float* __restrict__ part_sq) {
  __shared__ __align__(16) float smem[kXs + kWs];
  float* x_s = smem;
  float* w_s = smem + kXs;

  const int tid = threadIdx.x;
  const int tc = tid & 7;    // channels tc*4 .. +3 and 32 + tc*4 .. +3
  const int tp = tid >> 3;   // tile column
  int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int b = tile / tiles_y;
  const int y0 = ty * kTH, x0 = tx * kTW;
  const int co0 = blockIdx.y * kTC;
  const T* xb = x + static_cast<size_t>(b) * H * W * Cin;

  float acc[kTH][8];
#pragma unroll
  for (int i = 0; i < kTH; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  constexpr int kV = Vec<T>::kN;
  constexpr int kVecPerPix = kKC / kV;
  for (int k0 = 0; k0 < Cin; k0 += kKC) {
    __syncthreads();  // the previous chunk has been consumed
    for (int idx = tid; idx < kHaloH * kHaloW * kVecPerPix; idx += kThreads) {
      const int pix = idx / kVecPerPix, v = idx % kVecPerPix;
      const int gy = y0 - 1 + pix / kHaloW, gx = x0 - 1 + pix % kHaloW;
      const int c = k0 + v * kV;
      float* dst = x_s + pix * kKC + v * kV;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin) {
        Vec<T>::load(xb + (static_cast<size_t>(gy) * W + gx) * Cin + c, dst);
      } else {
#pragma unroll
        for (int j = 0; j < kV; j += 4)
          *reinterpret_cast<float4*>(dst + j) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    for (int idx = tid; idx < 9 * kKC * (kTC / 4); idx += kThreads) {
      const int c4 = idx % (kTC / 4), row = idx / (kTC / 4);
      const int kk = row % kKC, tap = row / kKC;
      const int ci = k0 + kk, co = co0 + c4 * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ci < Cin && co < Cout)
        val = __ldg(reinterpret_cast<const float4*>(
            w + (static_cast<size_t>(tap) * Cin + ci) * Cout + co));
      *reinterpret_cast<float4*>(w_s + row * kTC + c4 * 4) = val;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const float* xs = x_s + (dy * kHaloW + tp + dx) * kKC;
      const float* ws = w_s + tap * kKC * kTC + tc * 4;
#pragma unroll
      for (int k4 = 0; k4 < kKC / 4; ++k4) {
        float4 xv[kTH];
#pragma unroll
        for (int i = 0; i < kTH; ++i)
          xv[i] = *reinterpret_cast<const float4*>(xs + i * kHaloW * kKC +
                                                   k4 * 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 wa =
              *reinterpret_cast<const float4*>(ws + (k4 * 4 + kk) * kTC);
          const float4 wb =
              *reinterpret_cast<const float4*>(ws + (k4 * 4 + kk) * kTC + 32);
#pragma unroll
          for (int i = 0; i < kTH; ++i) {
            const float xval = component(xv[i], kk);
            acc[i][0] = fmaf(xval, wa.x, acc[i][0]);
            acc[i][1] = fmaf(xval, wa.y, acc[i][1]);
            acc[i][2] = fmaf(xval, wa.z, acc[i][2]);
            acc[i][3] = fmaf(xval, wa.w, acc[i][3]);
            acc[i][4] = fmaf(xval, wb.x, acc[i][4]);
            acc[i][5] = fmaf(xval, wb.y, acc[i][5]);
            acc[i][6] = fmaf(xval, wb.z, acc[i][6]);
            acc[i][7] = fmaf(xval, wb.w, acc[i][7]);
          }
        }
      }
    }
  }

  // epilogue: bias, statistics of the f32 values, rounded store
  const int gx = x0 + tp;
  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int co = co0 + half * 32 + tc * 4;
    if (co >= Cout) continue;
    float bv[4] = {0.f, 0.f, 0.f, 0.f};
    if (bias != nullptr) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(bias + co));
      bv[0] = t.x, bv[1] = t.y, bv[2] = t.z, bv[3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < kTH; ++i) {
      const int gy = y0 + i;
      if (gy >= H || gx >= W) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][half * 4 + j] + bv[j];
        if (kStats) {
          s[half * 4 + j] += v[j];
          q[half * 4 + j] = fmaf(v[j], v[j], q[half * 4 + j]);
        }
      }
      Vec<T>::store4(
          out + ((static_cast<size_t>(b) * H + gy) * W + gx) * Cout + co, v);
    }
  }
  if (!kStats) return;

  // the 16 tile columns' sums, added in column order
  __syncthreads();
  float* red_s = smem;
  float* red_q = smem + kTW * kTC;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red_s[tp * kTC + half * 32 + tc * 4 + j] = s[half * 4 + j];
      red_q[tp * kTC + half * 32 + tc * 4 + j] = q[half * 4 + j];
    }
  __syncthreads();
  if (tid < kTC && co0 + tid < Cout) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int p = 0; p < kTW; ++p) {
      ts += red_s[p * kTC + tid];
      tq += red_q[p * kTC + tid];
    }
    const size_t o = static_cast<size_t>(blockIdx.x) * Cout + co0 + tid;
    part_sum[o] = ts;
    part_sq[o] = tq;
  }
}

// (rows, C) partials -> (C,): 32 row lanes per channel stride over the rows,
// then one thread adds the 32 lane sums in order.
__global__ void __launch_bounds__(1024)
    conv3x3_combine_kernel(const float* __restrict__ part_sum,
                           const float* __restrict__ part_sq, int rows, int C,
                           float* __restrict__ sum, float* __restrict__ sq) {
  __shared__ float sh_s[32][33];
  __shared__ float sh_q[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f, q = 0.f;
  if (c < C) {
    for (int r = threadIdx.y; r < rows; r += 32) {
      s += part_sum[static_cast<size_t>(r) * C + c];
      q += part_sq[static_cast<size_t>(r) * C + c];
    }
  }
  sh_s[threadIdx.y][threadIdx.x] = s;
  sh_q[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  float ts = 0.f, tq = 0.f;
#pragma unroll
  for (int y = 0; y < 32; ++y) {
    ts += sh_s[y][threadIdx.x];
    tq += sh_q[y][threadIdx.x];
  }
  sum[c] = ts;
  sq[c] = tq;
}

// ---------------------------------------------------------------------------
// bf16, Cin == Cout == 64: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMC = 64;                 // input and output channels
constexpr int kMTH = 8, kMTW = 28;      // output pixels of a tile
constexpr int kMPixels = kMTH * kMTW;   // 224: three and a half m64 blocks
constexpr int kMWarps = 8;              // two warpgroups x two m64 blocks
constexpr int kMThreads = kMWarps * 32;
constexpr int kMHaloH = kMTH + 2, kMHaloW = kMTW + 2;
constexpr int kMHaloStride = 32;        // pixels between halo rows
constexpr int kMPixBytes = kMC * 2;     // 128: eight 16-byte chunks
constexpr int kMHaloBytes = kMHaloH * kMHaloStride * kMPixBytes;
constexpr int kMWeightBytes = 9 * kMC * kMPixBytes;
constexpr int kMSmemBytes = kMWeightBytes + 2 * kMHaloBytes;
static_assert(kMPixels <= kMWarps / 4 * 2 * 64, "m64 blocks cover the tile");
static_assert(kMWeightBytes % 1024 == 0, "128-byte swizzle atoms");
static_assert(kMHaloW <= kMHaloStride, "halo row stride");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the accumulators where they are between asynchronous MMAs.
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) += a (64 x 16 bf16, this warp's 16 rows as four registers
// in the mma.m16n8k16 A layout) x b (16 x 64 bf16 in shared memory, by
// descriptor). Asynchronous: a and d are in use until wgmma_wait.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Eight pixels that follow each other in the tile's 28-wide order, a step
// into the next tile row included (hp + 8 there: hence the row's bit), get
// eight different values.
__device__ __forceinline__ int halo_swizzle(int hp) {
  return (hp ^ ((hp >> 3) & 4)) & 7;
}

__device__ __forceinline__ void load_halo(const __nv_bfloat16* __restrict__ x,
                                          uint32_t buf, int tile, int H, int W,
                                          int tiles_x, int tiles_y, int tid) {
  const int tx = tile % tiles_x;
  const int rest = tile / tiles_x;
  const int ty = rest % tiles_y;
  const int b = rest / tiles_y;
  const int y0 = ty * kMTH - 1, x0 = tx * kMTW - 1;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * W * kMC;
  for (int idx = tid; idx < kMHaloH * kMHaloW * 8; idx += kMThreads) {
    const int c = idx & 7, pix = idx >> 3;
    const int hy = pix / kMHaloW, hx = pix - hy * kMHaloW;
    const int gy = y0 + hy, gx = x0 + hx;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const __nv_bfloat16* src =
        in ? xb + (static_cast<size_t>(gy) * W + gx) * kMC + c * 8 : x;
    const int hp = hy * kMHaloStride + hx;
    const uint32_t dst = buf + hp * kMPixBytes + ((c ^ halo_swizzle(hp)) << 4);
    cp_async16(dst, src, in ? 16 : 0);
  }
}

// Four packed bf16x2 values per lane, one per 8-channel block: after the
// call lane t of a quad holds block t's eight channels (v[j] from lane j).
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool hi2 = t & 2, hi1 = t & 1;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi2 ? v[0] : v[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi2 ? v[1] : v[3], 2);
  if (hi2) {
    v[0] = r0;
    v[1] = r1;
  } else {
    v[2] = r0;
    v[3] = r1;
  }
  r0 = __shfl_xor_sync(0xffffffffu, hi1 ? v[0] : v[1], 1);
  r1 = __shfl_xor_sync(0xffffffffu, hi1 ? v[2] : v[3], 1);
  if (hi1) {
    v[0] = r0;
    v[2] = r1;
  } else {
    v[1] = r0;
    v[3] = r1;
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x: (B, H, W, 64) bf16; wpk: (9, Cout = 64, Cin = 64) bf16, tap-major
// (dy * 3 + dx); bias: (64,) f32 or null; out: (B, H, W, 64) bf16.
// part_sum/part_sq: (gridDim.x, 64) f32 with kStats. All 16-byte aligned.
template <bool kStats>
__global__ void __launch_bounds__(kMThreads, 1)
    conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ wpk,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int H, int W,
                       int tiles_x, int tiles_y, int n_tiles,
                       float* __restrict__ part_sum,
                       float* __restrict__ part_sq) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t w_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t halo_s = w_s + kMWeightBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // the weights, once: row (tap * 64 + cout) of 64 cin, chunk c at
  // c ^ (row & 7)
  for (int idx = tid; idx < 9 * kMC * 8; idx += kMThreads) {
    const int c = idx & 7, row = idx >> 3;
    cp_async16(w_s + row * kMPixBytes + ((c ^ (row & 7)) << 4),
               wpk + row * kMC + c * 8, 16);
  }
  load_halo(x, halo_s, blockIdx.x, H, W, tiles_x, tiles_y, tid);
  cp_async_commit();

  // Warpgroup wg owns m64 blocks 2 wg and 2 wg + 1 of the tile's pixels (in
  // row-major order of the 28-wide tile); warp w of it rows 16 w .. 16 w + 15
  // of each. For ldmatrix this lane gives the address of pixel (lane & 15)
  // of those rows, k half (lane >> 4). Pixels beyond the tile's 224 (the
  // second half of the last block) read pixel 0 and are never stored.
  const int row0 = (warp >> 2) * 128 + (warp & 3) * 16;
  int a_pix[2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    int p = row0 + mb * 64 + (lane & 15);
    if (p >= kMPixels) p = 0;
    const int py = p / kMTW;
    a_pix[mb] = py * kMHaloStride + (p - py * kMTW);
  }
  const int a_khalf = lane >> 4;
  // B by descriptor: a tap's (64 cout x 64 cin) is 64 rows of 128 bytes in
  // the 128-byte swizzle (layout 1), 1,024 bytes between 8-row groups; a k16
  // step is 32 bytes further along the row
  const uint64_t b_desc = static_cast<uint64_t>((w_s & 0x3FFFF) >> 4) |
                          (1ull << 16) | (64ull << 32) | (1ull << 62);

  float bv[8][2];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    bv[nb][0] = bias != nullptr ? __ldg(bias + nb * 8 + 2 * t) : 0.f;
    bv[nb][1] = bias != nullptr ? __ldg(bias + nb * 8 + 2 * t + 1) : 0.f;
  }
  float st_s[8][2], st_q[8][2];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
    st_s[nb][0] = st_s[nb][1] = st_q[nb][0] = st_q[nb][1] = 0.f;

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    cp_async_wait<0>();
    // what the copies wrote, before the MMAs read the weights by descriptor
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile `tile` has landed; tile - grid has been consumed
    if (tile + gridDim.x < n_tiles)
      load_halo(x, halo_s + ((it + 1) & 1) * kMHaloBytes, tile + gridDim.x, H,
                W, tiles_x, tiles_y, tid);
    cp_async_commit();
    const uint32_t buf = halo_s + (it & 1) * kMHaloBytes;

    float acc[2][32];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[mb][e] = 0.f;

    // 36 k16 steps (9 taps x 4), one group of two MMAs each. The A
    // fragments of step s + 1 are loaded while groups s - 1 and s run, into
    // the registers group s - 2 has finished with.
    uint32_t fa[3][2][4];
    auto load_step = [&](int s, uint32_t (&a)[2][4]) {
      const int tap = s >> 2, ks = s & 3;
      const int dy = tap / 3, dx = tap - dy * 3;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const int hp = a_pix[mb] + dy * kMHaloStride + dx;
        ldmatrix_x4(a[mb], buf + hp * kMPixBytes +
                               (((ks * 2 + a_khalf) ^ halo_swizzle(hp)) << 4));
      }
    };
    load_step(0, fa[0]);
    pin(acc[0]);
    pin(acc[1]);
#pragma unroll
    for (int s = 0; s < 36; ++s) {
      const uint64_t desc =
          b_desc + static_cast<uint64_t>(((s >> 2) * kMC * kMPixBytes +
                                          (s & 3) * 32) >> 4);
      wgmma_fence();
      wgmma_m64n64k16(acc[0], fa[s % 3][0], desc);
      wgmma_m64n64k16(acc[1], fa[s % 3][1], desc);
      wgmma_commit();
      if (s + 1 < 36) {
        wgmma_wait<2>();
        load_step(s + 1, fa[(s + 1) % 3]);
      }
    }
    wgmma_wait<0>();
    pin(acc[0]);
    pin(acc[1]);

    // epilogue: this lane holds pixels (mb, half): row g + 8 * half of its
    // warp's 16 rows of m64 block mb, channels nb * 8 + 2 t, + 1 of every
    // 8-channel block nb
    const int tx = tile % tiles_x;
    const int rest = tile / tiles_x;
    const int ty = rest % tiles_y;
    const int b = rest / tiles_y;
    __nv_bfloat16* ob = out + static_cast<size_t>(b) * H * W * kMC;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = row0 + mb * 64 + half * 8 + g;
        const int py = p / kMTW;
        const int gy = ty * kMTH + py, gx = tx * kMTW + (p - py * kMTW);
        const bool in = p < kMPixels && gy < H && gx < W;
        uint32_t v[8];
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float lo = acc[mb][nb * 4 + 2 * half] + bv[nb][0];
          const float hi = acc[mb][nb * 4 + 2 * half + 1] + bv[nb][1];
          if (kStats && in) {
            st_s[nb][0] += lo;
            st_s[nb][1] += hi;
            st_q[nb][0] = fmaf(lo, lo, st_q[nb][0]);
            st_q[nb][1] = fmaf(hi, hi, st_q[nb][1]);
          }
          v[nb] = pack_bf16x2(lo, hi);
        }
        uint32_t v0[4] = {v[0], v[1], v[2], v[3]};
        uint32_t v1[4] = {v[4], v[5], v[6], v[7]};
        quad_transpose(v0, t);
        quad_transpose(v1, t);
        if (in) {
          __nv_bfloat16* o = ob + (static_cast<size_t>(gy) * W + gx) * kMC;
          *reinterpret_cast<uint4*>(o + t * 8) =
              make_uint4(v0[0], v0[1], v0[2], v0[3]);
          *reinterpret_cast<uint4*>(o + (4 + t) * 8) =
              make_uint4(v1[0], v1[1], v1[2], v1[3]);
        }
      }
  }
  if (!kStats) return;

  // lanes of equal t hold the same channels: add them over g by a fixed
  // tree, then the warps in order
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + kMWeightBytes);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = st_s[nb][e], q = st_q[nb][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (g == 0) {
        red[warp * kMC + nb * 8 + 2 * t + e] = s;
        red[(kMWarps + warp) * kMC + nb * 8 + 2 * t + e] = q;
      }
    }
  __syncthreads();
  if (tid < kMC) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int w = 0; w < kMWarps; ++w) {
      ts += red[w * kMC + tid];
      tq += red[(kMWarps + w) * kMC + tid];
    }
    part_sum[blockIdx.x * kMC + tid] = ts;
    part_sq[blockIdx.x * kMC + tid] = tq;
  }
}

template <bool kStats>
cudaError_t allow_mma_smem() {
  static size_t granted[kSmemAttrDevices] = {};
  return allow_dynamic_smem(
      reinterpret_cast<const void*>(conv3x3_mma_kernel<kStats>), kMSmemBytes,
      granted);
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const float* bias, void* out,
                   int B, int H, int W, int Cin, int Cout, float* part_sum,
                   float* part_sq, bool stats, cudaStream_t stream) {
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kTH - 1) / kTH;
  const dim3 grid(static_cast<unsigned>(B) * tiles_x * tiles_y,
                  (Cout + kTC - 1) / kTC);
  if (stats)
    conv3x3_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), w, bias, static_cast<T*>(out), H, W, Cin,
        Cout, tiles_x, tiles_y, part_sum, part_sq);
  else
    conv3x3_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), w, bias, static_cast<T*>(out), H, W, Cin,
        Cout, tiles_x, tiles_y, nullptr, nullptr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The FMA kernel's tile of output pixels, for the wrapper's scratch: its
// partials have B * ceil(H / rows) * ceil(W / cols) rows.
void hairci_conv3x3_tile(int* rows, int* cols) {
  *rows = kTH;
  *cols = kTW;
}

// The FMA kernel, any shape the wrapper accepts. x: (B, H, W, Cin)
// contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1); w: (9, Cin, Cout) f32;
// bias: (Cout,) f32 or null; out: (B, H, W, Cout) of x's type. With sum != null also part_sum, part_sq ((pixel tiles, Cout) f32
// scratch) and sum, sq ((Cout,) f32). Returns the CUDA error code of the
// launches (0 on success).
int hairci_conv3x3(const void* x, int bf16, const void* w, const void* bias,
                   void* out, int B, int H, int W, int Cin, int Cout,
                   void* part_sum, void* part_sq, void* sum, void* sq,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stats = sum != nullptr;
  float* ps = static_cast<float*>(part_sum);
  float* pq = static_cast<float*>(part_sq);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, wf, bf, out, B, H, W, Cin, Cout, ps, pq,
                                   stats, s)
           : launch<float>(x, wf, bf, out, B, H, W, Cin, Cout, ps, pq, stats,
                           s);
  if (err != cudaSuccess || !stats) return static_cast<int>(err);
  const int rows = B * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  conv3x3_combine_kernel<<<(Cout + 31) / 32, dim3(32, 32), 0, s>>>(
      ps, pq, rows, Cout, static_cast<float*>(sum), static_cast<float*>(sq));
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel's tile of output pixels; its grid is min(B *
// ceil(H / rows) * ceil(W / cols), the card's SM count) persistent blocks,
// and the partials have one row per block.
void hairci_conv3x3_mma_tile(int* rows, int* cols) {
  *rows = kMTH;
  *cols = kMTW;
}

// bf16, Cin == Cout == 64 only (else cudaErrorInvalidValue). x: (B, H, W, 64)
// bf16 contiguous; wpk: (9, 64 out, 64 in) bf16; bias: (64,) f32 or null;
// out: (B, H, W, 64) bf16. grid: the persistent blocks (see above). With
// sum != null also part_sum, part_sq ((grid, 64) f32 scratch) and sum, sq
// ((64,) f32). Returns the CUDA error code of the launches (0 on success).
int hairci_conv3x3_mma(const void* x, const void* wpk, const void* bias,
                       void* out, int B, int H, int W, int Cin, int Cout,
                       int grid, void* part_sum, void* part_sq, void* sum,
                       void* sq, void* stream) {
  if (Cin != kMC || Cout != kMC || B < 1 || H < 1 || W < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stats = sum != nullptr;
  const int tiles_x = (W + kMTW - 1) / kMTW, tiles_y = (H + kMTH - 1) / kMTH;
  const long long n_tiles = static_cast<long long>(B) * tiles_x * tiles_y;
  if (n_tiles > 0x7fffffffLL || grid > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(wpk);
  const float* bp = static_cast<const float*>(bias);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  float* ps = static_cast<float*>(part_sum);
  float* pq = static_cast<float*>(part_sq);
  cudaError_t err = stats ? allow_mma_smem<true>() : allow_mma_smem<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stats)
    conv3x3_mma_kernel<true><<<grid, kMThreads, kMSmemBytes, s>>>(
        xp, wp, bp, op, H, W, tiles_x, tiles_y, static_cast<int>(n_tiles), ps,
        pq);
  else
    conv3x3_mma_kernel<false><<<grid, kMThreads, kMSmemBytes, s>>>(
        xp, wp, bp, op, H, W, tiles_x, tiles_y, static_cast<int>(n_tiles),
        nullptr, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || !stats) return static_cast<int>(err);
  conv3x3_combine_kernel<<<(kMC + 31) / 32, dim3(32, 32), 0, s>>>(
      ps, pq, grid, kMC, static_cast<float*>(sum), static_cast<float*>(sq));
  return static_cast<int>(cudaGetLastError());
}

const char* hairci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
