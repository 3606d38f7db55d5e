// Nearest 3-shear rotation with an optional 3-tap Gaussian blur, for Hopper
// (sm_90a).
//
// Replaces hairci/ops/rotate_pallas.py:70 _rotate_kernel (rotate_shear_pallas,
// helpers _shift_lanes, _shift_rows, _blur3): per image, the Paeth
// decomposition x-shift, y-shift, x-shift, each shift rounded half up,
// floor(t + 0.5), and clamped to +-max_shift, the roll taken mod the axis; a
// pixel whose unclamped source falls outside in any pass takes the fill
// value. Then, optionally, the separable blur w1 * v + w0 * (up + down), rows
// first, with reflect edges.
//
// Bound: one read and one write of the f32 NHWC batch, 77 MB at 64 x 224 x
// 224 x 3: 0.023 ms at 3.35 TB/s. The TPU kernel rolls whole images through a
// ladder of shifts because gathers were slow there; here a block owns a band
// of full-width rows of one image, and every gathered value and every stored
// value costs as few instructions as it can:
// - Shift tables. The shift of passes 1 and 3 depends only on the row, that
//   of pass 2 only on the column, so each block first writes the image's
//   H + W shifts into shared memory, each as the unclamped shift (for the
//   fill test) and the clamped one reduced mod the axis (so the wrap is one
//   conditional add). A gathered pixel then costs three table reads and three
//   unsigned range tests: no floor, no modulo.
// - One gather. A thread walks down one column of the band (with the blur,
//   from one reflected row above it to one below), reading each pixel once
//   from x at x's own strides (the SHAM step hands over a view in NCHW
//   order), four rows' loads in flight together.
// - The blur once per value. The vertical pass runs in registers on the
//   walk, so shared memory holds each band row once, already blurred
//   vertically; the horizontal pass reads three aligned float4 of shared
//   memory per four outputs and picks its neighbours from registers.
// - 16-byte stores. Full-width rows make a band one contiguous span of the
//   output; the band sits in shared memory at the span's 16-byte phase, so
//   every store is a float4, scalar only at the span's ragged ends.
// - One launch, nothing on the host. alpha = -tan(theta/2), beta =
//   sin(theta) and the blur weights are computed in the kernel, as the TPU
//   kernel computes them.
//
// Bit parity with the plain twin: the twin's torch ops on the card are CUDA's
// tanf, sinf and expf, theta / 2.0 an exact * 0.5, -1.0 / t a reciprocal then
// a negation, e / d an IEEE divide; the kernel makes the same calls, and
// forms every product and sum with __fmul_rn/__fadd_rn, which nvcc never
// contracts into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "smem_attr.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBandRowsBlur = 16;  // output rows of a band, with the blur
constexpr int kBandRowsPlain = 8;  // and without
constexpr int kLead = 4;           // floats of shared memory before a band
constexpr int kBatchPlain = 8;     // rows a thread gathers at a time
constexpr int kBatchBlur = 4;
constexpr size_t kMaxSmem = 232448;
constexpr int kTooWide = -1;  // returned when one band row does not fit

struct Args {
  const float* x;
  long long sb, sh, sw, sc;  // x's strides, in elements
  const float* theta;
  const float* sigma;  // null: no blur
  float* out;          // (B, H, W, C) contiguous
  int H, W, C, mx, my;
  float fill;
  int rows;         // output rows of a band
  int bands;        // bands of an image
  int band_floats;  // shared floats before the shift tables
};

__device__ __forceinline__ int shift_of(float coef, float d) {
  // clamped to +-2^30 before the conversion: the range tests give the same
  // answer for any larger shift
  const float t = floorf(__fadd_rn(__fmul_rn(coef, d), 0.5f));
  return static_cast<int>(fminf(fmaxf(t, -1073741824.0f), 1073741824.0f));
}

// the clamped shift mod size, in [0, size)
__device__ __forceinline__ int clamp_mod(int n, int max_shift, int size) {
  int m = min(max(n, -max_shift), max_shift);
  if (max_shift >= size) m %= size;
  return m < 0 ? m + size : m;
}

// reflect without repeating the edge: -1 -> 1, n -> n - 2
__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i > n - 1 ? 2 * (n - 1) - i : i);
}

__device__ __forceinline__ float blur3(float w0, float w1, float a, float v,
                                       float b) {
  return __fadd_rn(__fmul_rn(w1, v), __fmul_rn(w0, __fadd_rn(a, b)));
}

// Dynamic shared memory: band_floats floats, then the tables nxu, nxm (H
// ints each) and nyu, nym (W each). Band element j (the j-th float of the
// band's span of the output) sits at smem[kLead + ph + j], ph the span's
// phase to 16 bytes, so smem[kLead + 4 q .. + 3] holds the q-th aligned
// quad of the span. With the blur, band row i holds the gathered rows
// blurred vertically.
template <int kC, bool kBlur>
__global__ void __launch_bounds__(kThreads) rotate_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, W = a.W;
  const int C = kC > 0 ? kC : a.C;
  const int WC = W * C;
  const int band = blockIdx.x % a.bands;
  const int b = blockIdx.x / a.bands;
  const int r0 = band * a.rows;
  const int rows = min(a.rows, H - r0);
  const int halo = kBlur ? 1 : 0;
  const long long start = (static_cast<long long>(b) * H + r0) * WC;
  const int ph = static_cast<int>(
      ((reinterpret_cast<uintptr_t>(a.out) >> 2) + start) & 3);
  float* band_s = smem + kLead + ph;
  int* nxu = reinterpret_cast<int*>(smem + a.band_floats);
  int* nxm = nxu + H;
  int* nyu = nxm + H;
  int* nym = nyu + W;

  // both loads in flight together: each is a round trip before any gather
  const float theta = a.theta[b];
  const float sigma = kBlur ? a.sigma[b] : 1.0f;
  const float alpha = -tanf(__fmul_rn(theta, 0.5f));
  const float beta = sinf(theta);
  const float cy = 0.5f * static_cast<float>(H - 1);
  const float cx = 0.5f * static_cast<float>(W - 1);
  for (int i = threadIdx.x; i < H + W; i += kThreads) {
    if (i < H) {
      const int n = shift_of(alpha, static_cast<float>(i) - cy);
      nxu[i] = n;
      nxm[i] = clamp_mod(n, a.mx, W);
    } else {
      const int c = i - H;
      const int n = shift_of(beta, static_cast<float>(c) - cx);
      nyu[c] = n;
      nym[c] = clamp_mod(n, a.my, H);
    }
  }
  __syncthreads();

  float w0 = 0.0f, w1 = 0.0f;
  if (kBlur) {
    // e = exp(-(1 / (2 sigma sigma))), d = 1 + 2 e; w0 = e / d, w1 = 1 / d
    const float e =
        expf(-__frcp_rn(__fmul_rn(__fmul_rn(2.0f, sigma), sigma)));
    const float d = __fadd_rn(1.0f, __fmul_rn(2.0f, e));
    w0 = __fdiv_rn(e, d);
    w1 = __frcp_rn(d);
  }

  // gather: output pixel (r, c) reads x at (sr, sc), undoing the passes from
  // the last to the first. A thread walks down one column of the band
  // (with the blur, from the reflected row above it to the one below),
  // kBatch rows at a time: it looks them up and starts all their loads
  // before it uses any, so that the loads are in flight together. With the
  // blur it keeps the last two rows in registers and writes each band row
  // once, blurred vertically; without, it writes the rows as they come.
  // With C > 4 it walks once for each channel.
  constexpr int kCh = kC > 0 ? kC : 1;
  constexpr int kBatch = kBlur ? kBatchBlur : kBatchPlain;
  const float* xb = a.x + b * a.sb;
  const int stored = rows + 2 * halo;
  for (int c = threadIdx.x; c < W; c += kThreads) {
    for (int ch0 = 0; ch0 < C; ch0 += kCh) {
      float up[kCh] = {}, mid[kCh] = {};
      for (int g0 = 0; g0 < stored; g0 += kBatch) {
        long long off[kBatch];
        bool ok[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          int r = r0 - halo + min(g0 + u, stored - 1);
          if (kBlur) r = reflect(r, H);
          ok[u] = static_cast<unsigned>(c - nxu[r]) < static_cast<unsigned>(W);
          int c2 = c - nxm[r];
          c2 += c2 < 0 ? W : 0;
          ok[u] &= static_cast<unsigned>(r - nyu[c2]) < static_cast<unsigned>(H);
          int sr = r - nym[c2];
          sr += sr < 0 ? H : 0;
          ok[u] &= static_cast<unsigned>(c2 - nxu[sr]) < static_cast<unsigned>(W);
          int sc = c2 - nxm[sr];
          sc += sc < 0 ? W : 0;
          off[u] = sr * a.sh + sc * a.sw + ch0 * a.sc;
        }
        float v[kBatch][kCh];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int k = 0; k < kCh; ++k)
            v[u][k] = ok[u] ? __ldg(xb + off[u] + k * a.sc) : a.fill;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int g = g0 + u;
          if (g >= stored) break;
          float* dst = band_s + (g - 2 * halo) * WC + c * C + ch0;
#pragma unroll
          for (int k = 0; k < kCh; ++k) {
            if (!kBlur) {
              dst[k] = v[u][k];
            } else {
              if (g >= 2) dst[k] = blur3(w0, w1, up[k], mid[k], v[u][k]);
              up[k] = mid[k];
              mid[k] = v[u][k];
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // the band's span, a quad of 4 floats at a time on 16-byte boundaries;
  // with the blur, the horizontal pass on the way out. f is the column
  // (float within the row) of the quad's first float
  const int n = rows * WC;
  const int quads = (n + ph + 3) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(smem + kLead);
  float* ob = a.out + start - ph;
  const int step_f = (4 * kThreads) % WC;
  int f = (4 * static_cast<int>(threadIdx.x) - ph) % WC;
  f += f < 0 ? WC : 0;
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    const int j0 = 4 * q - ph;
    float v[4];
    if (!kBlur) {
      const float4 t = s4[q];
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else if (kC > 0 && kC <= 4) {
      // floats j0 - 4 .. j0 + 7 (s4[-1] is the lead): every neighbour at
      // +-C of the quad's floats, in registers
      const float4 lo = s4[q - 1], mi = s4[q], hi = s4[q + 1];
      const float w[12] = {lo.x, lo.y, lo.z, lo.w, mi.x, mi.y,
                           mi.z, mi.w, hi.x, hi.y, hi.z, hi.w};
      int fk = f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float lft = fk < C ? w[4 + k + C] : w[4 + k - C];
        const float rgt = fk >= WC - C ? w[4 + k - C] : w[4 + k + C];
        v[k] = blur3(w0, w1, lft, w[4 + k], rgt);
        if (++fk == WC) fk = 0;
      }
    } else {
      int fk = f;
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k;
        if (j >= 0 && j < n) {
          const int lj = fk < C ? j + C : j - C;
          const int rj = fk >= WC - C ? j - C : j + C;
          v[k] = blur3(w0, w1, band_s[lj], band_s[j], band_s[rj]);
        } else {
          v[k] = 0.0f;
        }
        if (++fk == WC) fk = 0;
      }
    }
    float* dst = ob + 4 * q;
    if (j0 >= 0 && j0 + 4 <= n) {
      __stwb(reinterpret_cast<float4*>(dst),
             make_float4(v[0], v[1], v[2], v[3]));
    } else {
      for (int k = 0; k < 4; ++k)
        if (j0 + k >= 0 && j0 + k < n) __stwb(dst + k, v[k]);
    }
    f += step_f;
    if (f >= WC) f -= WC;
  }
}

template <int kC, bool kBlur>
cudaError_t launch(const Args& a, int blocks, size_t bytes,
                   cudaStream_t stream) {
  static size_t granted[kSmemAttrDevices];
  const void* kernel = reinterpret_cast<const void*>(&rotate_kernel<kC, kBlur>);
  const cudaError_t err = allow_dynamic_smem(kernel, bytes, granted);
  if (err != cudaSuccess) return err;
  rotate_kernel<kC, kBlur><<<blocks, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, H, W, C) f32 at element strides (sb, sh, sw, sc); theta: (B,) f32
// angles; sigma: (B,) f32 blur sigmas, or null for no blur; out: (B, H, W,
// C) f32 contiguous. Returns the CUDA error code of the launch (0 on
// success), or -1 when one band row does not fit in shared memory.
int hairci_rotate(const void* x, long long sb, long long sh, long long sw,
                  long long sc, const void* theta, const void* sigma,
                  void* out, int B, int H, int W, int C, int mx, int my,
                  float fill, void* stream) {
  const bool blur = sigma != nullptr;
  const size_t row_bytes = sizeof(float) * static_cast<size_t>(W) * C;
  // the band's lead, tail and rounding, and the shift tables
  const size_t fixed = sizeof(float) * 20 + sizeof(int) * 2 * (H + W);
  if (fixed + row_bytes > kMaxSmem) return kTooWide;
  const int fit = static_cast<int>((kMaxSmem - fixed) / row_bytes);
  Args a;
  a.x = static_cast<const float*>(x);
  a.sb = sb;
  a.sh = sh;
  a.sw = sw;
  a.sc = sc;
  a.theta = static_cast<const float*>(theta);
  a.sigma = static_cast<const float*>(sigma);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.W = W;
  a.C = C;
  a.mx = mx;
  a.my = my;
  a.fill = fill;
  a.rows = std::min(std::min(blur ? kBandRowsBlur : kBandRowsPlain, H), fit);
  a.bands = (H + a.rows - 1) / a.rows;
  a.band_floats = (a.rows * W * C + 16 + 3) / 4 * 4;
  const size_t bytes =
      sizeof(float) * a.band_floats + sizeof(int) * 2 * (H + W);
  const long long blocks = static_cast<long long>(B) * a.bands;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(blocks);
  cudaError_t err;
  // the channel counts with a kernel of their own: 3 (RGB, the SHAM step),
  // 1 and 4; any other takes the kernel for any C
  switch (C + (blur ? 8 : 0)) {
    case 1: err = launch<1, false>(a, n, bytes, s); break;
    case 3: err = launch<3, false>(a, n, bytes, s); break;
    case 4: err = launch<4, false>(a, n, bytes, s); break;
    case 9: err = launch<1, true>(a, n, bytes, s); break;
    case 11: err = launch<3, true>(a, n, bytes, s); break;
    case 12: err = launch<4, true>(a, n, bytes, s); break;
    default:
      err = blur ? launch<0, true>(a, n, bytes, s)
                 : launch<0, false>(a, n, bytes, s);
  }
  return static_cast<int>(err);
}

const char* hairci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
