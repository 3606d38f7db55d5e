// Fused gallery scoring + top-k for Hopper (sm_90a).
//
// Replaces hairci/ops/topk_pallas.py:_topk_kernel (and its helper
// _select_topk): scores = q . g^T accumulated in f32, then the k best per
// query, ordered by (score desc, index asc), rows >= n never read.
//
// Bound: one read of the gallery, N * D * sizeof(storage) bytes (320 MB at
// N = 103,945, D = 768 in f32), against 2 * Q * N * D FLOPs. At small Q the
// kernel is memory-bound; the design streams every gallery row exactly once
// per query tile with 16-byte coalesced loads and never writes the (Q, N)
// score matrix that the plain version materialises and sorts.
//
// The TPU kernel carries a running top-k in scratch across a grid that runs
// in order. GPU blocks run in no order, so this is two stages:
//   1. topk_partial_kernel, grid (query tiles x gallery splits). A block holds
//      its query tile in shared memory; each warp walks rows of its split,
//      computes the QT dot products of a row with f32 FMAs (IEEE, no TF32),
//      reduces them across the warp, and keeps a per-query top-k in
//      registers. The block merges its warps' lists and writes a
//      (Q, splits, K) partial.
//   2. topk_merge_kernel, one warp per query, merges splits * K candidates.
// No atomics: the result is the same from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace {

constexpr int kWarps = 8;                  // warps per stage-1 block
constexpr int kThreads = kWarps * 32;
constexpr int kMergeWarps = 4;             // queries per stage-2 block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// (score desc, index asc): the order of the TPU kernel's merge.
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// Insert (ns, ni) into a sorted register list of length K.
template <int K>
__device__ __forceinline__ void insert(float (&s)[K], int (&ix)[K], float ns,
                                       int ni) {
  if (!better(ns, ni, s[K - 1], ix[K - 1])) return;
  s[K - 1] = ns;
  ix[K - 1] = ni;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (better(s[j], ix[j], s[j - 1], ix[j - 1])) {
      const float ts = s[j];
      s[j] = s[j - 1];
      s[j - 1] = ts;
      const int ti = ix[j];
      ix[j] = ix[j - 1];
      ix[j - 1] = ti;
    }
  }
}

template <int K>
__device__ __forceinline__ void clear(float (&s)[K], int (&ix)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    s[j] = neg_inf();
    ix[j] = kNoIndex;
  }
}

// 16-byte loads: 4 f32 or 8 bf16 (bf16 -> f32 is exact: the high half-word).
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int kN = 4; };
template <> struct Vec<uint16_t> { static constexpr int kN = 8; };

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load_vec(const uint16_t* p, float (&v)[8]) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    v[2 * t] = __uint_as_float(w[t] << 16);
    v[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
  }
}

__device__ __forceinline__ float load_one(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_one(const uint16_t* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
}

// Stage 1. QT = 2^LOG_QT queries per block, K = list length.
// Lane l of a warp ends each row holding the score of query l >> (5 - LOG_QT)
// of the tile; every lane of that group holds the same bits.
template <typename T, int LOG_QT, int K>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const float* __restrict__ q, const T* __restrict__ g,
                    int Q, int N, int D, int nvec, int rows_per_split,
                    int splits, float* __restrict__ part_s,
                    int* __restrict__ part_i) {
  constexpr int QT = 1 << LOG_QT;
  constexpr int VN = Vec<T>::kN;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);

  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  for (int e = threadIdx.x; e < QT * D; e += kThreads) {
    const int j = e / D;
    qs[e] = (q0 + j < Q) ? q[static_cast<size_t>(q0) * D + e] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int my_q = lane >> (5 - LOG_QT);
  float best_s[K];
  int best_i[K];
  clear<K>(best_s, best_i);

  const int r0 = split * rows_per_split;
  const int r1 = min(N, r0 + rows_per_split);
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const T* row = g + static_cast<size_t>(r) * D;
    float acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0.f;
#pragma unroll 2
    for (int c = lane; c < nvec; c += 32) {
      float v[VN];
      load_vec(row + c * VN, v);
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const float* qj = qs + j * D + c * VN;
#pragma unroll
        for (int t = 0; t < VN; t += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qj + t);
          acc[j] = fmaf(v[t], qq.x, acc[j]);
          acc[j] = fmaf(v[t + 1], qq.y, acc[j]);
          acc[j] = fmaf(v[t + 2], qq.z, acc[j]);
          acc[j] = fmaf(v[t + 3], qq.w, acc[j]);
        }
      }
    }
    for (int d = nvec * VN + lane; d < D; d += 32) {
      const float v = load_one(row + d);
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[j] = fmaf(v, qs[j * D + d], acc[j]);
    }
    // reduce-scatter over the top LOG_QT lane bits (each step halves the
    // values a lane keeps), then a butterfly over the remaining bits
#pragma unroll
    for (int st = 0; st < LOG_QT; ++st) {
      const int off = 16 >> st;
      const int half = QT >> (st + 1);
      const bool upper = (lane & off) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float lo = acc[i];
        const float hi = acc[i + half];
        const float recv = __shfl_xor_sync(kFull, upper ? lo : hi, off);
        acc[i] = (upper ? hi : lo) + recv;
      }
    }
#pragma unroll
    for (int off = 16 >> LOG_QT; off > 0; off >>= 1)
      acc[0] += __shfl_xor_sync(kFull, acc[0], off);
    insert<K>(best_s, best_i, acc[0], r);
  }

  // merge the warps' lists: shared memory now holds [kWarps][QT][K] pairs
  __syncthreads();
  float* cs = qs;
  int* ci = reinterpret_cast<int*>(qs + kWarps * QT * K);
  if ((lane & ((32 >> LOG_QT) - 1)) == 0) {
    const int base = (warp * QT + my_q) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      cs[base + j] = best_s[j];
      ci[base + j] = best_i[j];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < QT && q0 + t < Q) {
    float s[K];
    int ix[K];
    clear<K>(s, ix);
    for (int w = 0; w < kWarps; ++w) {
      const int base = (w * QT + t) * K;
#pragma unroll
      for (int j = 0; j < K; ++j) insert<K>(s, ix, cs[base + j], ci[base + j]);
    }
    const size_t out = (static_cast<size_t>(q0 + t) * splits + split) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      part_s[out + j] = s[j];
      part_i[out + j] = ix[j];
    }
  }
}

// Stage 2: one warp per query merges its n_cand = splits * K candidates.
template <int K>
__global__ void __launch_bounds__(kMergeWarps * 32)
topk_merge_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_i, int Q, int n_cand, int k,
                  float* __restrict__ out_s, int64_t* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (qi >= Q) return;  // uniform across the warp
  float s[K];
  int ix[K];
  clear<K>(s, ix);
  const float* ps = part_s + static_cast<size_t>(qi) * n_cand;
  const int* pi = part_i + static_cast<size_t>(qi) * n_cand;
  for (int c = lane; c < n_cand; c += 32) insert<K>(s, ix, ps[c], pi[c]);
  for (int r = 0; r < k; ++r) {
    float bs = s[0];
    int bi = ix[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFull, bs, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (s[0] == bs && ix[0] == bi) {  // this lane's head won: pop it
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        s[j] = s[j + 1];
        ix[j] = ix[j + 1];
      }
      s[K - 1] = neg_inf();
      ix[K - 1] = kNoIndex;
    }
    if (lane == 0) {
      out_s[static_cast<size_t>(qi) * k + r] = bs;
      out_i[static_cast<size_t>(qi) * k + r] = bi;
    }
  }
}

template <typename T, int LOG_QT, int K>
cudaError_t launch(const float* q, const T* g, int Q, int N, int D, int k,
                   int splits, int nvec, float* part_s, int* part_i,
                   float* out_s, int64_t* out_i, cudaStream_t stream) {
  constexpr int QT = 1 << LOG_QT;
  const size_t q_bytes = static_cast<size_t>(QT) * D * sizeof(float);
  const size_t merge_bytes = static_cast<size_t>(kWarps) * QT * K * 8;
  const size_t smem = q_bytes > merge_bytes ? q_bytes : merge_bytes;
  auto kernel = topk_partial_kernel<T, LOG_QT, K>;
  static size_t granted[kSmemAttrDevices] = {};
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel),
                                       smem, granted);
  if (err != cudaSuccess) return err;
  const int rows_per_split = (N + splits - 1) / splits;
  const dim3 grid((Q + QT - 1) / QT, splits);
  kernel<<<grid, kThreads, smem, stream>>>(q, g, Q, N, D, nvec,
                                           rows_per_split, splits, part_s,
                                           part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_blocks = (Q + kMergeWarps - 1) / kMergeWarps;
  topk_merge_kernel<K><<<merge_blocks, kMergeWarps * 32, 0, stream>>>(
      part_s, part_i, Q, splits * K, k, out_s, out_i);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_qt(int log_qt, const float* q, const T* g, int Q, int N,
                      int D, int k, int splits, int nvec, float* part_s,
                      int* part_i, float* out_s, int64_t* out_i,
                      cudaStream_t stream) {
  switch (log_qt) {
    case 0:
      return launch<T, 0, K>(q, g, Q, N, D, k, splits, nvec, part_s, part_i,
                             out_s, out_i, stream);
    case 3:
      return launch<T, 3, K>(q, g, Q, N, D, k, splits, nvec, part_s, part_i,
                             out_s, out_i, stream);
    case 5:
      return launch<T, 5, K>(q, g, Q, N, D, k, splits, nvec, part_s, part_i,
                             out_s, out_i, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_k(int kcap, int log_qt, const float* q, const T* g, int Q,
                     int N, int D, int k, int splits, int nvec, float* part_s,
                     int* part_i, float* out_s, int64_t* out_i,
                     cudaStream_t stream) {
  switch (kcap) {
    case 8:
      return launch_qt<T, 8>(log_qt, q, g, Q, N, D, k, splits, nvec, part_s,
                             part_i, out_s, out_i, stream);
    case 16:
      return launch_qt<T, 16>(log_qt, q, g, Q, N, D, k, splits, nvec, part_s,
                              part_i, out_s, out_i, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (Q, D) f32; g (N, D) f32 or bf16 (g_bf16 = 1); rows >= N are not read.
// part_s/part_i: scratch of Q * splits * kcap; out_s (Q, k) f32, out_i
// (Q, k) int64. nvec = D / (4 or 8) when rows and queries allow 16-byte
// loads, else 0. Returns the cudaError_t of the launches (0 on success).
int hairci_topk_gallery_search(const void* q, const void* g, int g_bf16,
                               int Q, int N, int D, int k, int log_qt,
                               int kcap, int splits, int nvec, void* part_s,
                               void* part_i, void* out_s, void* out_i,
                               void* stream) {
  if (k < 1 || k > kcap || Q < 1 || N < 1 || D < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* os = static_cast<float*>(out_s);
  int64_t* oi = static_cast<int64_t*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      g_bf16 ? launch_k<uint16_t>(kcap, log_qt, qf,
                                  static_cast<const uint16_t*>(g), Q, N, D, k,
                                  splits, nvec, ps, pi, os, oi, st)
             : launch_k<float>(kcap, log_qt, qf, static_cast<const float*>(g),
                               Q, N, D, k, splits, nvec, ps, pi, os, oi, st);
  return static_cast<int>(err);
}

const char* hairci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
