// BatchNorm's apply and its backward for Hopper (sm_90a), in the
// non-centred form the ResNet trunk uses: y = x * w + b per channel, with
// w = weight / sqrt(var + eps) and b = bias - mean * w formed by the wrapper
// (ops/bn_apply.py), then, where the block asks, + residual and ReLU.
//
// Replaces no TPU kernel. In the JAX package XLA fuses this chain (the
// normalise of hairci/models/norm.py, the residual add and the ReLU of
// hairci/models/resnet.py) and differentiates it. Run eagerly, PyTorch made
// one f32 pass for each of cast, multiply, add and cast back, one more for
// each ReLU and residual add, replayed every one of them in the backward,
// and kept an f32 copy of every BN input for the multiply's gradient.
//
// Bound: bytes. Each kernel does a few FLOPs an element, far below the
// ~295 bf16 FLOPs a byte where the card's arithmetic would bound it, so its
// time is its reads and writes, each made once:
//   * bn_apply_kernel reads x (and the residual) and writes y;
//   * bn_grad_sums_kernel reads dy and x (and y, for the ReLU's mask) and
//     writes two f32 sums a channel, A = sum g and B = sum g * x, where g is
//     dy with the ReLU's mask applied;
//   * bn_grad_input_kernel reads the same and writes dx = g * w + g_s +
//     2 x * g_sq (and d residual = g).
// Every intermediate lives in registers in f32; nothing is kept in f32
// between the passes. The layout is bn_stats.cu's: every lane moves 16 bytes
// (8 bf16 or 4 f32 channels) and a thread has kUnroll rows' loads in flight
// before it computes any of them; a block is (row lanes x channel groups),
// so a thread keeps its channels' per-channel vectors in registers for all
// its rows and a warp reads whole 128-byte lines of a row. The reduce adds
// its row splits' partials as bn_stats does: the block that draws a channel
// tile's last ticket adds them in index order, so the sums are the same
// bits on every run (no float atomics).
//
// Rounding. The apply multiplies and adds with __fmul_rn and __fadd_rn (no
// contraction into an FMA), rounds to T, adds the residual in f32 and
// rounds again, then takes max(., 0) keeping a NaN: the bits of PyTorch's
// separate f32 multiply, f32 add, cast, add of two T tensors and ReLU. dx is
// ((g * w) + g_s) + ((2 x) * g_sq) in that order, each step rounded, then
// rounded once to T: the bits of the plain twin's expression.
//
// Where C or a pointer's alignment rules out 16-byte accesses the same
// kernels run with one element a lane (V == 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // rows' loads in flight per thread

// V channels of one row, widened to f32 on load and rounded on store.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    p[0] = v[0];
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[1]) {
    p[0] = __float2bfloat16_rn(v[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// f rounded to the nearest value a T holds, as f32.
template <typename T>
__device__ __forceinline__ float round_to(float f);

template <>
__device__ __forceinline__ float round_to<float>(float f) {
  return f;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

// dy where the ReLU's output was above 0 (PyTorch's threshold_backward:
// 0 where out <= 0), or dy without a ReLU.
__device__ __forceinline__ float masked(float dy, float out, bool relu) {
  return relu && out <= 0.f ? 0.f : dy;
}

// V per-channel f32 values from c0 (read once a thread; no alignment asked).
template <int V>
__device__ __forceinline__ void load_channels(const float* p, int c0,
                                              float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __ldg(p + c0 + j);
}

// The tile of a thread: channel group g of 2^log_tg, row lane of kThreads /
// 2^log_tg; the rows of block row split blockIdx.y.
struct Tile {
  int lane, lanes, c0;
  long long begin, end;
  template <int V>
  __device__ __forceinline__ static Tile of(long long M, int log_tg,
                                            long long rows_per_split) {
    Tile t;
    const int tg = 1 << log_tg;
    t.lanes = kThreads >> log_tg;
    t.lane = threadIdx.x >> log_tg;
    t.c0 = (blockIdx.x * tg + (threadIdx.x & (tg - 1))) * V;
    t.begin = static_cast<long long>(blockIdx.y) * rows_per_split;
    t.end = min(M, t.begin + rows_per_split);
    return t;
  }
};

// y = relu(round(residual + round(x * w + b))), each step optional as the
// flags say. x, residual, y: (M, C).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    T* __restrict__ y, const float* __restrict__ w,
                    const float* __restrict__ b, long long M, int C,
                    int log_tg, long long rows_per_split, int relu) {
  const Tile t = Tile::of<V>(M, log_tg, rows_per_split);
  if (t.c0 >= C) return;
  float wv[V], bv[V];
  load_channels<V>(w, t.c0, wv);
  load_channels<V>(b, t.c0, bv);
  const bool has_res = res != nullptr;

  auto finish = [&](float (&v)[V], const float (&q)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float o = round_to<T>(__fadd_rn(__fmul_rn(v[j], wv[j]), bv[j]));
      if (has_res) o = round_to<T>(__fadd_rn(q[j], o));
      if (relu) o = isnan(o) ? o : fmaxf(o, 0.f);
      v[j] = o;
    }
  };

  long long r = t.begin + t.lane;
  for (; r + (kUnroll - 1) * t.lanes < t.end; r += kUnroll * t.lanes) {
    float v[kUnroll][V], q[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      Vec<T, V>::load(x + (r + u * t.lanes) * C + t.c0, v[u]);
    if (has_res) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        Vec<T, V>::load(res + (r + u * t.lanes) * C + t.c0, q[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      finish(v[u], q[u]);
      Vec<T, V>::store(y + (r + u * t.lanes) * C + t.c0, v[u]);
    }
  }
  for (; r < t.end; r += t.lanes) {
    float v[V], q[V];
    Vec<T, V>::load(x + r * C + t.c0, v);
    if (has_res) Vec<T, V>::load(res + r * C + t.c0, q);
    finish(v, q);
    Vec<T, V>::store(y + r * C + t.c0, v);
  }
}

// A = sum of g, B = sum of g * x over the rows, per channel, in f32; g is dy
// masked by out > 0 where out is given. The two-stage scheme of
// bn_stats_kernel: part (splits, 2, C) f32, sums (2, C) f32, counter one per
// channel tile, zero on entry and on exit.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_grad_sums_kernel(const T* __restrict__ dy, const T* __restrict__ out,
                        const T* __restrict__ x, long long M, int C,
                        int log_tg, long long rows_per_split, int splits,
                        float* part, float* __restrict__ sums,
                        unsigned int* counter) {
  __shared__ __align__(16) float sh_a[kThreads * V];
  __shared__ __align__(16) float sh_b[kThreads * V];
  __shared__ bool is_last;

  const int t = threadIdx.x;
  const Tile tile = Tile::of<V>(M, log_tg, rows_per_split);
  const int tc = (1 << log_tg) * V;  // channels of this tile (<= 256)
  const bool relu = out != nullptr;

  float a[V], bb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = bb[j] = 0.f;
  if (tile.c0 < C) {
    long long r = tile.begin + tile.lane;
    const int lanes = tile.lanes;
    for (; r + (kUnroll - 1) * lanes < tile.end; r += kUnroll * lanes) {
      float g[kUnroll][V], xv[kUnroll][V], o[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long off = (r + u * lanes) * C + tile.c0;
        Vec<T, V>::load(dy + off, g[u]);
        Vec<T, V>::load(x + off, xv[u]);
        if (relu) Vec<T, V>::load(out + off, o[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float gj = masked(g[u][j], relu ? o[u][j] : 1.f, relu);
          a[j] += gj;
          bb[j] = fmaf(gj, xv[u][j], bb[j]);
        }
    }
    for (; r < tile.end; r += lanes) {
      float g[V], xv[V], o[V];
      const long long off = r * C + tile.c0;
      Vec<T, V>::load(dy + off, g);
      Vec<T, V>::load(x + off, xv);
      if (relu) Vec<T, V>::load(out + off, o);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float gj = masked(g[j], relu ? o[j] : 1.f, relu);
        a[j] += gj;
        bb[j] = fmaf(gj, xv[j], bb[j]);
      }
    }
  }
  // sh[lane][channel of the tile]: t * V == lane * tc + g * V
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sh_a[t * V + j] = a[j];
    sh_b[t * V + j] = bb[j];
  }
  __syncthreads();
  const int lanes = tile.lanes;
  const int ch = blockIdx.x * tc + t;  // for t < tc
  if (t < tc && ch < C) {
    float ta = 0.f, tb = 0.f;
    for (int y = 0; y < lanes; ++y) {
      ta += sh_a[y * tc + t];
      tb += sh_b[y * tc + t];
    }
    if (splits == 1) {
      sums[ch] = ta;
      sums[C + ch] = tb;
    } else {
      float* row = part + static_cast<long long>(blockIdx.y) * 2 * C;
      row[ch] = ta;
      row[C + ch] = tb;
      __threadfence();
    }
  }
  if (splits == 1) return;

  __syncthreads();
  if (t == 0) {
    const unsigned int ticket = atomicAdd(&counter[blockIdx.x], 1u);
    is_last = ticket == static_cast<unsigned int>(splits) - 1u;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the tile's partials, added in an order that depends on nothing but the
  // shape: thread (split lane sl, channel cg) adds splits sl, sl + SL, ...;
  // then channel t adds the SL lane sums in lane order
  const int sl_n = kThreads / tc;
  const int cg = t % tc, sl = t / tc;
  const int cb = blockIdx.x * tc + cg;
  float as = 0.f, bs = 0.f;
  if (cb < C) {
#pragma unroll 4
    for (int i = sl; i < splits; i += sl_n) {
      const float* row = part + static_cast<long long>(i) * 2 * C + cb;
      as += __ldcg(row);
      bs += __ldcg(row + C);
    }
  }
  sh_a[t] = as;
  sh_b[t] = bs;
  __syncthreads();
  if (t < tc && ch < C) {
    float ta = 0.f, tb = 0.f;
    for (int y = 0; y < sl_n; ++y) {
      ta += sh_a[y * tc + t];
      tb += sh_b[y * tc + t];
    }
    sums[ch] = ta;
    sums[C + ch] = tb;
  }
  if (t == 0) counter[blockIdx.x] = 0u;  // ready for the next launch
}

// dx = round(((g * w) + g_s) + ((2 x) * g_sq)), and d residual = g where
// dres is given; g is dy masked by out > 0 where out is given.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_grad_input_kernel(const T* __restrict__ dy, const T* __restrict__ out,
                         const T* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ gs,
                         const float* __restrict__ gq, T* __restrict__ dx,
                         T* __restrict__ dres, long long M, int C,
                         int log_tg, long long rows_per_split) {
  const Tile t = Tile::of<V>(M, log_tg, rows_per_split);
  if (t.c0 >= C) return;
  float wv[V], sv[V], qv[V];
  load_channels<V>(w, t.c0, wv);
  load_channels<V>(gs, t.c0, sv);
  load_channels<V>(gq, t.c0, qv);
  const bool relu = out != nullptr;

  auto finish = [&](long long off, float (&g)[V], const float (&xv)[V],
                    const float (&o)[V]) {
    float d[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      g[j] = masked(g[j], relu ? o[j] : 1.f, relu);
      d[j] = __fadd_rn(__fadd_rn(__fmul_rn(g[j], wv[j]), sv[j]),
                       __fmul_rn(__fmul_rn(2.f, xv[j]), qv[j]));
    }
    Vec<T, V>::store(dx + off, d);
    if (dres != nullptr) Vec<T, V>::store(dres + off, g);
  };

  long long r = t.begin + t.lane;
  for (; r + (kUnroll - 1) * t.lanes < t.end; r += kUnroll * t.lanes) {
    float g[kUnroll][V], xv[kUnroll][V], o[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = (r + u * t.lanes) * C + t.c0;
      Vec<T, V>::load(dy + off, g[u]);
      Vec<T, V>::load(x + off, xv[u]);
      if (relu) Vec<T, V>::load(out + off, o[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      finish((r + u * t.lanes) * C + t.c0, g[u], xv[u], o[u]);
  }
  for (; r < t.end; r += t.lanes) {
    float g[V], xv[V], o[V];
    const long long off = r * C + t.c0;
    Vec<T, V>::load(dy + off, g);
    Vec<T, V>::load(x + off, xv);
    if (relu) Vec<T, V>::load(out + off, o);
    finish(off, g, xv, o);
  }
}

// Calls f with a value whose type names the element type and the lanes'
// width: bf16 (0 or 1) and vec (1, or 8 for bf16 and 4 for f32).
template <typename T_, int V_>
struct Kind {
  using T = T_;
  static constexpr int V = V_;
};

template <typename F>
cudaError_t dispatch(int bf16, int vec, F&& f) {
  if (bf16)
    return vec == 8 ? f(Kind<__nv_bfloat16, 8>{})
                    : f(Kind<__nv_bfloat16, 1>{});
  return vec == 4 ? f(Kind<float, 4>{}) : f(Kind<float, 1>{});
}

bool bad_plan(int bf16, int vec, int log_tg, int splits) {
  return log_tg < 0 || log_tg > 5 || splits < 1 || splits > 65535 ||
         (vec != 1 && vec != (bf16 ? 8 : 4));
}

dim3 grid_of(int C, int vec, int log_tg, int splits) {
  const int groups = (C + vec - 1) / vec;
  return dim3((groups + (1 << log_tg) - 1) >> log_tg, splits);
}

}  // namespace

extern "C" {

// The block's shape, for the wrapper's plan: threads per block and rows'
// loads in flight per thread.
void hairci_bn_apply_block(int* threads, int* unroll) {
  *threads = kThreads;
  *unroll = kUnroll;
}

// Every tensor (M, C) contiguous, all f32 (bf16 == 0) or all bf16
// (bf16 == 1); w, b: C f32 values. res may be null (no residual); relu 0 or
// 1. vec: channels per lane, 1 or the 16-byte width (8 bf16, 4 f32; needs
// C % vec == 0 and every (M, C) pointer 16-byte aligned). log_tg: log2 of
// the channel groups per block (0..5); splits row splits of rows_per_split
// rows. One launch; returns its CUDA error code (0 on success).
int hairci_bn_apply(const void* x, const void* res, void* y, const void* w,
                    const void* b, int bf16, long long M, int C, int vec,
                    int log_tg, int splits, long long rows_per_split,
                    int relu, void* stream) {
  if (bad_plan(bf16, vec, log_tg, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(C, vec, log_tg, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(bf16, vec, [&](auto kind) {
    using T = typename decltype(kind)::T;
    bn_apply_kernel<T, decltype(kind)::V><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(res),
        static_cast<T*>(y), static_cast<const float*>(w),
        static_cast<const float*>(b), M, C, log_tg, rows_per_split, relu);
    return cudaGetLastError();
  }));
}

// dy, x and out (null without a ReLU) as hairci_bn_apply's tensors. part:
// (splits, 2, C) f32 scratch, unused when splits == 1; sums: (2, C) f32, A
// then B; counter: one zeroed unsigned int per channel tile, left zeroed.
int hairci_bn_grad_sums(const void* dy, const void* out, const void* x,
                        int bf16, long long M, int C, int vec, int log_tg,
                        int splits, long long rows_per_split, void* part,
                        void* sums, void* counter, void* stream) {
  if (bad_plan(bf16, vec, log_tg, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(C, vec, log_tg, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(bf16, vec, [&](auto kind) {
    using T = typename decltype(kind)::T;
    bn_grad_sums_kernel<T, decltype(kind)::V><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(dy), static_cast<const T*>(out),
        static_cast<const T*>(x), M, C, log_tg, rows_per_split, splits,
        static_cast<float*>(part), static_cast<float*>(sums),
        static_cast<unsigned int*>(counter));
    return cudaGetLastError();
  }));
}

// dy, out, x as above; w, gs, gq: C f32 values; dx (M, C); dres (M, C) or
// null.
int hairci_bn_grad_input(const void* dy, const void* out, const void* x,
                         const void* w, const void* gs, const void* gq,
                         void* dx, void* dres, int bf16, long long M, int C,
                         int vec, int log_tg, int splits,
                         long long rows_per_split, void* stream) {
  if (bad_plan(bf16, vec, log_tg, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of(C, vec, log_tg, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(bf16, vec, [&](auto kind) {
    using T = typename decltype(kind)::T;
    bn_grad_input_kernel<T, decltype(kind)::V><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(dy), static_cast<const T*>(out),
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<const float*>(gs), static_cast<const float*>(gq),
        static_cast<T*>(dx), static_cast<T*>(dres), M, C, log_tg,
        rows_per_split);
    return cudaGetLastError();
  }));
}

const char* hairci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
