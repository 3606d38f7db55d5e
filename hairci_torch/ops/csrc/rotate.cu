// Nearest 3-shear rotation with an optional 3-tap Gaussian blur, for Hopper
// (sm_90a).
//
// Replaces hairci/ops/rotate_pallas.py:rotate_shear_pallas (kernel
// _rotate_kernel, helpers _shift_lanes, _shift_rows, _blur3): per image, the
// Paeth decomposition x-shift, y-shift, x-shift, each shift rounded half up,
// floor(t + 0.5), and clamped to +-max_shift; a pixel whose source falls
// outside in any pass takes the fill value. Then, optionally, the separable
// blur w1 * v + w0 * (up + down), rows first, with reflect edges.
//
// Bound: one read and one write of the f32 NHWC batch (77 MB at 64 x 224 x
// 224 x 3). The TPU kernel rolls whole images through a ladder of shifts
// because gathers were slow there. Here each output pixel composes the three
// integer shifts into one source coordinate and gathers it: three validity
// tests, one read. With the blur, a block first gathers its 8 x 32 tile and
// a one-pixel reflected halo into shared memory, then blurs from there.
//
// Bit parity with the plain twin: the wrapper computes alpha = -tan(theta/2),
// beta = sin(theta) and the blur weights in torch, as the twin does, and the
// kernel forms t = coef * d + 0.5 and the blur sums with __fmul_rn/__fadd_rn,
// which nvcc never contracts into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;

__device__ __forceinline__ int shift_of(float coef, float d) {
  return static_cast<int>(floorf(__fadd_rn(__fmul_rn(coef, d), 0.5f)));
}

__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

struct Shear {
  float alpha, beta, cy, cx;
  int H, W, mx, my;
};

// Source pixel (sr, sc) of output pixel (r, c), undoing the passes from the
// last to the first. A shift rolls by the clamped amount (mod the axis
// length) and tests the unclamped source for range, as the roll ladder does.
__device__ __forceinline__ bool source_of(const Shear& s, int r, int c,
                                          int& sr, int& sc) {
  int n = shift_of(s.alpha, static_cast<float>(r) - s.cy);  // third pass
  bool ok = c - n >= 0 && c - n <= s.W - 1;
  const int c2 = wrap(c - clampi(n, -s.mx, s.mx), s.W);
  n = shift_of(s.beta, static_cast<float>(c2) - s.cx);  // second pass
  ok = ok && r - n >= 0 && r - n <= s.H - 1;
  sr = wrap(r - clampi(n, -s.my, s.my), s.H);
  n = shift_of(s.alpha, static_cast<float>(sr) - s.cy);  // first pass
  ok = ok && c2 - n >= 0 && c2 - n <= s.W - 1;
  sc = wrap(c2 - clampi(n, -s.mx, s.mx), s.W);
  return ok;
}

__device__ __forceinline__ Shear make_shear(const float* alpha,
                                            const float* beta, int b, int H,
                                            int W, int mx, int my) {
  Shear s;
  s.alpha = alpha[b];
  s.beta = beta[b];
  s.cy = 0.5f * static_cast<float>(H - 1);
  s.cx = 0.5f * static_cast<float>(W - 1);
  s.H = H;
  s.W = W;
  s.mx = mx;
  s.my = my;
  return s;
}

__global__ void __launch_bounds__(kTileW* kTileH)
    rotate_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                  const float* __restrict__ beta, float* __restrict__ out,
                  int H, int W, int C, int mx, int my, float fill) {
  const int c = blockIdx.x * kTileW + threadIdx.x;
  const int r = blockIdx.y * kTileH + threadIdx.y;
  const int b = blockIdx.z;
  if (r >= H || c >= W) return;
  const Shear s = make_shear(alpha, beta, b, H, W, mx, my);
  int sr, sc;
  const bool ok = source_of(s, r, c, sr, sc);
  const float* src = x + ((static_cast<long long>(b) * H + sr) * W + sc) * C;
  float* dst = out + ((static_cast<long long>(b) * H + r) * W + c) * C;
  for (int ch = 0; ch < C; ++ch) dst[ch] = ok ? src[ch] : fill;
}

// reflect without repeating the edge: -1 -> 1, n -> n - 2; positions past
// the halo of a ragged tile are clamped (their values are never used)
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i > n - 1) i = 2 * (n - 1) - i;
  return clampi(i, 0, n - 1);
}

// Dynamic shared memory: (kTileH + 2) x (kTileW + 2) x C floats.
__global__ void __launch_bounds__(kTileW* kTileH)
    rotate_blur_kernel(const float* __restrict__ x,
                       const float* __restrict__ alpha,
                       const float* __restrict__ beta,
                       const float* __restrict__ w0s,
                       const float* __restrict__ w1s, float* __restrict__ out,
                       int H, int W, int C, int mx, int my, float fill) {
  extern __shared__ float tile[];
  constexpr int kTW = kTileW + 2;
  constexpr int kTH = kTileH + 2;
  const int b = blockIdx.z;
  const Shear s = make_shear(alpha, beta, b, H, W, mx, my);
  const int r0 = blockIdx.y * kTileH - 1;
  const int c0 = blockIdx.x * kTileW - 1;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < kTH * kTW; i += kTileW * kTileH) {
    const int r = reflect(r0 + i / kTW, H);
    const int c = reflect(c0 + i % kTW, W);
    int sr, sc;
    const bool ok = source_of(s, r, c, sr, sc);
    const float* src =
        x + ((static_cast<long long>(b) * H + sr) * W + sc) * C;
    for (int ch = 0; ch < C; ++ch) tile[i * C + ch] = ok ? src[ch] : fill;
  }
  __syncthreads();
  const int r = blockIdx.y * kTileH + threadIdx.y;
  const int c = blockIdx.x * kTileW + threadIdx.x;
  if (r >= H || c >= W) return;
  const float w0 = w0s[b];
  const float w1 = w1s[b];
  float* dst = out + ((static_cast<long long>(b) * H + r) * W + c) * C;
  const int ty = threadIdx.y + 1;
  const int tx = threadIdx.x + 1;
  for (int ch = 0; ch < C; ++ch) {
    float v[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {  // rows first, at columns tx-1 .. tx+1
      const int col = tx - 1 + j;
      const float up = tile[((ty - 1) * kTW + col) * C + ch];
      const float mid = tile[(ty * kTW + col) * C + ch];
      const float down = tile[((ty + 1) * kTW + col) * C + ch];
      v[j] = __fadd_rn(__fmul_rn(w1, mid), __fmul_rn(w0, __fadd_rn(up, down)));
    }
    dst[ch] = __fadd_rn(__fmul_rn(w1, v[1]), __fmul_rn(w0, __fadd_rn(v[0], v[2])));
  }
}

}  // namespace

extern "C" {

// x, out: (B, H, W, C) f32 contiguous; alpha, beta: (B,) f32; w0, w1: (B,)
// f32 blur weights, or null for no blur. Returns the CUDA error code of the
// launch (0 on success).
int hairci_rotate(const void* x, const void* alpha, const void* beta,
                  const void* w0, const void* w1, void* out, int B, int H,
                  int W, int C, int mx, int my, float fill, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  const dim3 block(kTileW, kTileH);
  const float* xp = static_cast<const float*>(x);
  const float* ap = static_cast<const float*>(alpha);
  const float* bp = static_cast<const float*>(beta);
  float* op = static_cast<float*>(out);
  if (w0 == nullptr) {
    rotate_kernel<<<grid, block, 0, s>>>(xp, ap, bp, op, H, W, C, mx, my,
                                         fill);
  } else {
    const size_t smem = sizeof(float) * (kTileH + 2) * (kTileW + 2) * C;
    rotate_blur_kernel<<<grid, block, smem, s>>>(
        xp, ap, bp, static_cast<const float*>(w0),
        static_cast<const float*>(w1), op, H, W, C, mx, my, fill);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hairci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
