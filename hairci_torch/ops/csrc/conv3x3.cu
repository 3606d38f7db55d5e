// 3x3 convolution (stride 1, zero padding 1) with optional per-channel
// statistics, for Hopper (sm_90a).
//
// Replaces tools/fused_conv_bn_bench.py:pallas_conv3x3 (kernel _conv_kernel):
// for x (B, H, W, Cin) NHWC and w (3, 3, Cin, Cout), nine shifted
// (H*W, Cin) x (Cin, Cout) products accumulated in f32, plus a bias, rounded
// to x's type; with stats also the per-channel sum and sum of squares of the
// f32 accumulator (bias included, before the rounding) over all B*H*W
// positions.
//
// Bound at the tool's shape (256, 56, 56, 64) -> 64 in bf16: 102.8 MB in and
// 102.8 MB out against 59.2 GFLOP, so bytes and tensor-core operations bound
// it about equally (0.061 ms each). This kernel does its products as f32
// FMAs on widened values, for f32 and bf16 inputs alike, so its own ceiling
// is the f32 FMA rate (67 TFLOP/s: 0.88 ms at that shape), not the tensor
// cores': it is the simple, exact version.
//
// The TPU kernel takes one pre-padded image per grid step and carries the
// statistics across the ordered grid. Here:
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

// The tile of output pixels one block computes, for the wrapper's scratch:
// the partials have B * ceil(H / rows) * ceil(W / cols) rows.
void hairci_conv3x3_tile(int* rows, int* cols) {
  *rows = kTH;
  *cols = kTW;
}

// x: (B, H, W, Cin) contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1);
// w: (9, Cin, Cout) f32; bias: (Cout,) f32 or null; out: (B, H, W, Cout) of
// x's type. With sum != null also part_sum, part_sq ((pixel tiles, Cout) f32
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

const char* hairci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
