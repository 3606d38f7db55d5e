// Per-channel BatchNorm statistics for Hopper (sm_90a).
//
// Replaces tools/bn_stats_bench.py:pallas_stats (kernel _stats_kernel): the
// f32 sum and sum of squares over the rows of an (M, C) channel-last view,
// read once. The port's BatchNorm turns them into the mean and the biased
// variance, E[x^2] - E[x]^2, as hairci/models/norm.py does.
//
// Bound: one read of the input, M * C * sizeof(T) bytes (822 MB for the
// tool's 512*56*56 x 256 bf16), against 3 FLOPs per element: memory-bound.
// The TPU kernel carries the two sums in scratch across a grid that runs in
// order. GPU blocks run in no order, so this is two stages and no atomics
// (the result is the same from run to run):
//   1. bn_partial_kernel, grid (channel tiles x row splits). A warp reads V
//      consecutive channels per lane of one row (float4 for f32, bf16x2 for
//      bf16: neighbouring lanes on neighbouring addresses); the block's 8
//      warps stride over the split's rows; f32 partials are summed across
//      the warps in shared memory and written as (splits, C).
//   2. bn_combine_kernel, one thread per channel, adds the splits in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // threads across channels
constexpr int kRows = 8;    // threads across rows
constexpr int kMaxVec = 4;

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
struct Load<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float (&v)[2]) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  }
};

// With V > 1 the wrapper guarantees C % V == 0, so c0 < C covers all V.
template <typename T, int V>
__global__ void __launch_bounds__(kLanes* kRows)
    bn_partial_kernel(const T* __restrict__ x, long long M, int C,
                      long long rows_per_split, float* __restrict__ part_sum,
                      float* __restrict__ part_sq) {
  __shared__ float sh_sum[kRows][kLanes * kMaxVec];
  __shared__ float sh_sq[kRows][kLanes * kMaxVec];
  const int c0 = (blockIdx.x * kLanes + threadIdx.x) * V;
  const long long begin = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long end = min(M, begin + rows_per_split);
  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
  if (c0 < C) {
    for (long long r = begin + threadIdx.y; r < end; r += kRows) {
      float v[V];
      Load<T, V>::run(x + r * C + c0, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] += v[j];
        q[j] = fmaf(v[j], v[j], q[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sh_sum[threadIdx.y][threadIdx.x * V + j] = s[j];
    sh_sq[threadIdx.y][threadIdx.x * V + j] = q[j];
  }
  __syncthreads();
  if (threadIdx.y != 0 || c0 >= C) return;
  float* out_s = part_sum + static_cast<long long>(blockIdx.y) * C + c0;
  float* out_q = part_sq + static_cast<long long>(blockIdx.y) * C + c0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int y = 0; y < kRows; ++y) {
      ts += sh_sum[y][threadIdx.x * V + j];
      tq += sh_sq[y][threadIdx.x * V + j];
    }
    out_s[j] = ts;
    out_q[j] = tq;
  }
}

__global__ void bn_combine_kernel(const float* __restrict__ part_sum,
                                  const float* __restrict__ part_sq,
                                  int splits, int C, float* __restrict__ sum,
                                  float* __restrict__ sq) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f, q = 0.f;
  for (int i = 0; i < splits; ++i) {
    s += part_sum[static_cast<long long>(i) * C + c];
    q += part_sq[static_cast<long long>(i) * C + c];
  }
  sum[c] = s;
  sq[c] = q;
}

template <typename T, int V>
void launch_partial(const void* x, long long M, int C, int splits,
                    long long rows_per_split, float* part_sum, float* part_sq,
                    cudaStream_t stream) {
  const dim3 grid((C + kLanes * V - 1) / (kLanes * V), splits);
  const dim3 block(kLanes, kRows);
  bn_partial_kernel<T, V><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), M, C, rows_per_split, part_sum, part_sq);
}

}  // namespace

extern "C" {

// x: (M, C) contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1). vec: channels
// per lane (1, or 4 for f32 / 2 for bf16 when C and the pointer allow it).
// part_*: (splits, C) f32 scratch; sum, sq: (C,) f32. Returns the CUDA error
// code of the launches (0 on success).
int hairci_bn_stats(const void* x, int bf16, long long M, int C, int vec,
                    int splits, long long rows_per_split, void* part_sum,
                    void* part_sq, void* sum, void* sq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_sum);
  float* pq = static_cast<float*>(part_sq);
  if (bf16) {
    if (vec == 2)
      launch_partial<__nv_bfloat16, 2>(x, M, C, splits, rows_per_split, ps, pq,
                                       s);
    else
      launch_partial<__nv_bfloat16, 1>(x, M, C, splits, rows_per_split, ps, pq,
                                       s);
  } else {
    if (vec == 4)
      launch_partial<float, 4>(x, M, C, splits, rows_per_split, ps, pq, s);
    else
      launch_partial<float, 1>(x, M, C, splits, rows_per_split, ps, pq, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_combine_kernel<<<(C + 255) / 256, 256, 0, s>>>(
      ps, pq, splits, C, static_cast<float*>(sum), static_cast<float*>(sq));
  return static_cast<int>(cudaGetLastError());
}

const char* hairci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
