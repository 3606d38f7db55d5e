// Per-channel BatchNorm statistics for Hopper (sm_90a).
//
// Replaces tools/bn_stats_bench.py:pallas_stats (kernel _stats_kernel): the
// f32 sum and sum of squares over the rows of an (M, C) channel-last view,
// read once. The port's BatchNorm turns them into the mean and the biased
// variance, E[x^2] - E[x]^2, as hairci/models/norm.py does.
//
// Bound: one read of the input, M * C * sizeof(T) bytes, against 3 FLOPs per
// element: memory-bound, and at the small shapes of a training step
// latency-bound (a launch costs the card 3 us before it reads a byte; inputs
// beyond the 50 MB L2 stream at about 3.0 of the 3.35 TB/s). To keep the
// memory busy across ~0.6 us of latency an SM must hold ~15 KB of loads in
// flight, so:
//   * every lane loads 16 bytes (8 bf16 or 4 f32 channels) and a thread
//     starts kUnroll = 4 such loads for four different rows before it adds
//     any of them: a block of 256 threads holds 16 KB in flight, and the plan
//     (bn_stats.py:plan) puts about four blocks on an SM;
//   * a block is (row lanes x channel groups): the 2^log_tg lanes of a
//     channel tile read neighbouring 16-byte groups of one row. The plan
//     takes 8 groups, one 128-byte line of a row: a warp then covers 4 rows
//     x 64 channels per load whatever C is, C = 64 in bf16 is one tile, and
//     wider C becomes more channel tiles (grid.x) with fewer row splits
//     each. That keeps the second stage small: what the last block of a tile
//     adds grows with splits x tile width (with 32 groups a tile the 55
//     inputs of a step took the card 2.21 ms, with 8 they take 1.67);
//   * one launch. The TPU kernel carries the two sums in scratch across a
//     grid that runs in order; GPU blocks run in no order. Each block adds
//     its threads' sums in shared memory in row-lane order and writes one
//     partial per channel; the block that draws the last ticket of its
//     channel tile (atomicAdd after __threadfence) adds the tile's partials:
//     256 threads as (split lanes x 16-byte channel groups) stride over the
//     splits, then the split lanes are added in lane order. The ticket only
//     decides WHO adds, never the order of the additions, so the result is
//     the same bits on every run. The last block sets its counter back to 0:
//     the wrapper keeps one zeroed counter array per stream and never has
//     to clear it. With splits == 1 (small inputs) there is no second stage
//     and no ticket: the block writes the result itself.
// Where C or the pointer's alignment rules out 16-byte loads the same kernel
// runs with one element per lane (vec == 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // independent loads in flight per thread

// One load of V channels, widened to f32.
template <typename T, int V>
struct Load;

template <>
struct Load<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
};

template <>
struct Load<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float (&v)[4]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};

template <>
struct Load<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <>
struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
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
};

// CW partials of consecutive channels, read through L2 (another block wrote
// them during this launch).
template <int CW>
__device__ __forceinline__ void load_partial(const float* p, float (&v)[CW]) {
  if constexpr (CW == 4) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    v[0] = __ldcg(p);
  }
}

// x: (M, C). Grid (channel tiles, splits); block kThreads = (row lanes x
// 2^log_tg channel groups of V channels). part: (splits, 2, C) f32; out:
// (2, C) f32 (sums, then sums of squares); counter: one per channel tile,
// zero on entry and on exit. With V > 1 the wrapper guarantees C % V == 0
// and a 16-byte aligned x.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const T* __restrict__ x, long long M, int C, int log_tg,
                    long long rows_per_split, int splits, float* part,
                    float* __restrict__ out, unsigned int* counter) {
  __shared__ __align__(16) float sh_s[kThreads * V];
  __shared__ __align__(16) float sh_q[kThreads * V];
  __shared__ bool is_last;

  const int t = threadIdx.x;
  const int tg = 1 << log_tg;          // channel groups of this tile
  const int lanes = kThreads >> log_tg;  // row lanes
  const int g = t & (tg - 1), lane = t >> log_tg;
  const int tc = tg * V;               // channels of this tile (<= 256)
  const int c0 = (blockIdx.x * tg + g) * V;
  const long long begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long end = min(M, begin + rows_per_split);

  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
  if (c0 < C) {
    const T* p = x + c0;
    long long r = begin + lane;
    for (; r + (kUnroll - 1) * lanes < end; r += kUnroll * lanes) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        Load<T, V>::run(p + (r + static_cast<long long>(u) * lanes) * C, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s[j] += v[u][j];
          q[j] = fmaf(v[u][j], v[u][j], q[j]);
        }
    }
    for (; r < end; r += lanes) {
      float v[V];
      Load<T, V>::run(p + r * C, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] += v[j];
        q[j] = fmaf(v[j], v[j], q[j]);
      }
    }
  }
  // sh[lane][channel of the tile]: t * V == lane * tc + g * V
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sh_s[t * V + j] = s[j];
    sh_q[t * V + j] = q[j];
  }
  __syncthreads();
  const int ch = blockIdx.x * tc + t;  // for t < tc
  if (t < tc && ch < C) {
    float ts = 0.f, tq = 0.f;
    for (int y = 0; y < lanes; ++y) {
      ts += sh_s[y * tc + t];
      tq += sh_q[y * tc + t];
    }
    if (splits == 1) {
      out[ch] = ts;
      out[C + ch] = tq;
    } else {
      float* row = part + static_cast<long long>(blockIdx.y) * 2 * C;
      row[ch] = ts;
      row[C + ch] = tq;
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
  // shape: thread (split lane sl, channel group cg) adds splits sl, sl + SL,
  // ...; then channel t adds the SL lane sums in lane order
  constexpr int CW = V > 1 ? 4 : 1;
  const int groups = tc / CW;          // a power of two, <= 64
  const int sl_n = kThreads / groups;
  const int cg = t & (groups - 1), sl = t / groups;
  const int cb = blockIdx.x * tc + cg * CW;
  float as[CW], aq[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) as[j] = aq[j] = 0.f;
  if (cb < C) {
#pragma unroll 4
    for (int i = sl; i < splits; i += sl_n) {
      const float* row = part + static_cast<long long>(i) * 2 * C + cb;
      float vs[CW], vq[CW];
      load_partial<CW>(row, vs);
      load_partial<CW>(row + C, vq);
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        as[j] += vs[j];
        aq[j] += vq[j];
      }
    }
  }
  // sh[sl][channel of the tile]: t * CW == sl * tc + cg * CW
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    sh_s[t * CW + j] = as[j];
    sh_q[t * CW + j] = aq[j];
  }
  __syncthreads();
  if (t < tc && ch < C) {
    float ts = 0.f, tq = 0.f;
    for (int y = 0; y < sl_n; ++y) {
      ts += sh_s[y * tc + t];
      tq += sh_q[y * tc + t];
    }
    out[ch] = ts;
    out[C + ch] = tq;
  }
  if (t == 0) counter[blockIdx.x] = 0u;  // ready for the next launch
}

template <typename T, int V>
cudaError_t launch(const void* x, long long M, int C, int log_tg, int splits,
                   long long rows_per_split, float* part, float* out,
                   unsigned int* counter, cudaStream_t stream) {
  const int groups = (C + V - 1) / V;
  const dim3 grid((groups + (1 << log_tg) - 1) >> log_tg, splits);
  bn_stats_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), M, C, log_tg, rows_per_split, splits, part,
      out, counter);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The block's shape, for the wrapper's plan: threads per block and
// independent loads per thread and loop turn.
void hairci_bn_stats_block(int* threads, int* unroll) {
  *threads = kThreads;
  *unroll = kUnroll;
}

// x: (M, C) contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1). vec: channels
// per lane, 1 or the 16-byte width (4 for f32, 8 for bf16; needs C % vec == 0
// and x 16-byte aligned). log_tg: log2 of the channel groups per block
// (0..5). part: (splits, 2, C) f32 scratch, unused when splits == 1; out:
// (2, C) f32; counter: ceil(C / vec / 2^log_tg) zeroed unsigned ints, left
// zeroed. One launch. Returns its CUDA error code (0 on success).
int hairci_bn_stats(const void* x, int bf16, long long M, int C, int vec,
                    int log_tg, int splits, long long rows_per_split,
                    void* part, void* out, void* counter, void* stream) {
  if (log_tg < 0 || log_tg > 5 || splits < 1 || splits > 65535 ||
      (vec != 1 && vec != (bf16 ? 8 : 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  float* po = static_cast<float*>(out);
  unsigned int* pc = static_cast<unsigned int*>(counter);
  cudaError_t err;
  if (bf16) {
    err = vec == 8 ? launch<__nv_bfloat16, 8>(x, M, C, log_tg, splits,
                                              rows_per_split, pp, po, pc, s)
                   : launch<__nv_bfloat16, 1>(x, M, C, log_tg, splits,
                                              rows_per_split, pp, po, pc, s);
  } else {
    err = vec == 4 ? launch<float, 4>(x, M, C, log_tg, splits, rows_per_split,
                                      pp, po, pc, s)
                   : launch<float, 1>(x, M, C, log_tg, splits, rows_per_split,
                                      pp, po, pc, s);
  }
  return static_cast<int>(err);
}

const char* hairci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
