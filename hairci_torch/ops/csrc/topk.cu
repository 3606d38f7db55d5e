// Fused gallery scoring + top-k for Hopper (sm_90a).
//
// Replaces hairci/ops/topk_pallas.py:_topk_kernel (:43) and its helper
// _select_topk (:26): scores = q . g^T accumulated in f32, then the k best
// per query, ordered by (score desc, index asc), rows >= n never read.
//
// The TPU kernel carries a running top-k in scratch across a grid that runs
// in order. GPU blocks run in no order, so there are two stages: a stage 1
// that writes a (Q, splits, K) list of partial winners, one list per query
// and gallery split, and topk_merge_kernel, one warp per query, which merges
// splits * K candidates. No atomics: the result is the same from run to run.
// Stage 1 has two routes; ops/topk.py's plan() picks one.
//
// The single-query route, topk_partial_kernel (Q below the batched
// threshold). Bound: one read of the gallery, N * D * sizeof(storage) bytes
// (320 MB at N = 103,945, D = 768 in f32), against 2 * Q * N * D FLOPs: at
// small Q the kernel is memory-bound. Grid (query tiles x gallery splits). A
// block holds its query tile in shared memory; each warp walks rows of its
// split with 16-byte coalesced loads, computes the QT dot products of a row
// with f32 FMAs (IEEE, no TF32), reduces them across the warp, and keeps a
// per-query top-k in registers; the block merges its warps' lists. It never
// writes the (Q, N) score matrix that the plain version materialises and
// sorts.
//
// The batched route, topk_tc_kernel (Q at or above the threshold): a GEMM on
// the tensor cores with a top-k epilogue. At Q = 256 the FMA route above
// reads one f32 of q from shared memory per FMA (about 82 GB for 20.4 G
// FMAs, most of its 3.5 ms on an H100 80GB HBM3 at 700 W) and reads the
// gallery once per 32 queries. Bound at Q = 256, N = 103,945, D = 768: three
// products of 2 * Q * N * D operations each, at 495 TFLOP/s (TF32) 0.248 ms
// for an f32 gallery and at 989 TFLOP/s (bf16) 0.124 ms for a bf16 one; the
// gallery's bytes 0.095 / 0.048 ms at 3.35 TB/s. The design:
//   - a block owns 128 queries and one gallery split of whole 128-row tiles;
//     the grid's x is the query tile, so the query tiles of one split run
//     together and the second read of a tile comes from the 50 MB L2;
//   - for each tile a K loop over D in slices of 64 stages the gallery slice
//     and the query slice in shared memory by cp.async (a ring of two: the
//     next slice lands while this one is multiplied; rows >= n and the K
//     tail are zero-filled, never read), and 8 warps, each 64 rows x 32
//     queries, multiply them with mma.sync (slices of 64 rather than 32:
//     half the barriers and the fixed cost of a slice);
//   - precision is f32, not TF32. f32 gallery: 3xTF32 (m16n8k8.tf32); each
//     operand x = big + small with big = tf32(x) and small = tf32(x - big)
//     (tf32 = round to nearest, ties away, on the low 13 mantissa bits, in
//     software), and the sum takes small.big + big.small + big.big. bf16
//     gallery: the row is exact in bf16; q = q0 + q1 + q2 with q0 = bf16(q),
//     q1 = bf16(q - q0), q2 = bf16(q - q0 - q1), three m16n8k16.bf16
//     products. The split is made in registers as each fragment is loaded
//     from shared memory: no extra launch, no extra bytes. The tensor cores
//     truncate as they accumulate: one accumulator over all of D = 768 (288
//     mma for f32) drifted by up to 9.2e-6 from the f32 twin (chip_smoke.py
//     on an H100 80GB HBM3 at 700 W) against a tolerance of 1e-5. So each
//     slice's sums start from zero and are folded into the score tile in
//     shared memory with IEEE adds (24 / 12 mma a chain);
//   - each (query, row) score is summed in a fixed order (the slices in
//     turn, each its products smallest first) by one thread, with no
//     split-K across blocks: its bits do not depend on where the row falls
//     in a tile or a split, so duplicated rows tie exactly;
//   - the epilogue: the 128 x 128 score tile sits in shared memory (query
//     major, padded so that neither the fragments' adds nor the scan meet a
//     bank conflict), and two threads a query scan 64 rows each against the
//     k-th score of their register list; the comparison keys on (score,
//     index), so the order of the visit does not matter, and it is staggered
//     by lane. The next tile's first slice lands during the scan.
// The batched route takes D a multiple of 4 (f32 gallery) or 8 (bf16) and
// 16-byte aligned pointers; other inputs take the single-query route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
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

// ---------------------------------------------------------------------------
// The batched route: stage 1 as a GEMM on the tensor cores with a top-k
// epilogue (the note at the top of the file).
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;      // gallery rows a tile (the GEMM's M)
constexpr int kTcQueries = 128;   // queries a block (the GEMM's N)
constexpr int kTcK = 64;          // K slice staged at a time
constexpr int kTcStages = 2;      // ring of slices, one in flight
constexpr int kTcWarpRows = 64;   // a warp's tile: 64 rows x 32 queries
constexpr int kTcWarpQueries = 32;
constexpr int kTcScoreStride = kTcRows + 4;  // floats a query of the scores
constexpr int kTcScanRows = kTcRows * kTcQueries / kThreads;  // 64 a thread
static_assert((kTcRows / kTcWarpRows) * (kTcQueries / kTcWarpQueries) ==
                  kWarps,
              "the warps tile the block");

// Rows are padded so that the lanes of one fragment load hit 32 banks.
template <typename T> struct TcTile;
template <> struct TcTile<float> {
  static constexpr int kGStride = kTcK + 4;   // f32 a gallery row: 272 B
  static constexpr int kQStride = kTcK + 4;   // f32 a query row: 272 B
};
template <> struct TcTile<uint16_t> {
  static constexpr int kGStride = kTcK + 8;   // bf16 a gallery row: 144 B
  static constexpr int kQStride = kTcK + 8;   // f32 a query row: 288 B
};

template <typename T> __host__ __device__ constexpr int tc_g_bytes() {
  return kTcRows * TcTile<T>::kGStride * static_cast<int>(sizeof(T));
}
template <typename T> __host__ __device__ constexpr int tc_stage_bytes() {
  return tc_g_bytes<T>() + kTcQueries * TcTile<T>::kQStride * 4;
}
template <typename T> __host__ __device__ constexpr int tc_smem_bytes() {
  return kTcStages * tc_stage_bytes<T>() + kTcQueries * kTcScoreStride * 4;
}

// One K slice of a tile into a stage: the gallery's rows row0.. (zero past
// N, never read) and the queries q0.. (zero past Q), columns k0..k0+63 (zero
// past D). D is a multiple of a 16-byte copy's elements.
template <typename T>
__device__ __forceinline__ void tc_stage(uint32_t dst, const float* q,
                                         const T* g, int Q, int N, int D,
                                         int q0, int row0, int k0) {
  constexpr int kGVec = 16 / sizeof(T);
  constexpr int kGPerRow = kTcK / kGVec;
  for (int c = threadIdx.x; c < kTcRows * kGPerRow; c += kThreads) {
    const int r = c / kGPerRow;
    const int col = (c % kGPerRow) * kGVec;
    const bool in = row0 + r < N && k0 + col < D;
    const T* src = in ? g + static_cast<size_t>(row0 + r) * D + k0 + col : g;
    cp_async16(dst + (r * TcTile<T>::kGStride + col) * sizeof(T), src,
               in ? 16 : 0);
  }
  dst += tc_g_bytes<T>();
  constexpr int kQPerRow = kTcK / 4;
  for (int c = threadIdx.x; c < kTcQueries * kQPerRow; c += kThreads) {
    const int r = c / kQPerRow;
    const int col = (c % kQPerRow) * 4;
    const bool in = q0 + r < Q && k0 + col < D;
    const float* src =
        in ? q + static_cast<size_t>(q0 + r) * D + k0 + col : q;
    cp_async16(dst + (r * TcTile<T>::kQStride + col) * 4, src, in ? 16 : 0);
  }
}

// x = big + small + (a rest below 2^-22 |x|): tf32 by round to nearest, ties
// away, on the low 13 mantissa bits (what cvt.rna.tf32 rounds to).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float rest = x - __uint_as_float(big);   // exact
  small = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

// (x, y) = the sum of three bf16 pairs w[0] + w[1] + w[2] to about 24 bits;
// x in the low half of each word, as mma takes the lower k there.
__device__ __forceinline__ void split_bf16x3(float x, float y,
                                             uint32_t (&w)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
    x -= __uint_as_float(w[i] << 16);          // exact
    y -= __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's 64 x 32 tile over one K slice: acc[mt][nt] is the m16n8 tile of
// rows wr + 16 mt.. and queries wq + 8 nt.. (lane: g = lane / 4, t = lane %
// 4). The gallery is the row-major A, the queries the column-major B.
// Products go smallest first, each over all 16 tiles before the next, so no
// mma waits on the one before it.
template <typename T> struct TcMath;

template <> struct TcMath<float> {
  static __device__ __forceinline__ void slice(const float* gs,
                                               const float* qs, int wr,
                                               int wq, int g, int t,
                                               float (&acc)[4][4][4]) {
    constexpr int GS = TcTile<float>::kGStride;
    constexpr int QS = TcTile<float>::kQStride;
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 8) {
      uint32_t ab[4][4], as[4][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* p = gs + (wr + mt * 16 + g) * GS + kk + t;
        split_tf32(p[0], ab[mt][0], as[mt][0]);
        split_tf32(p[8 * GS], ab[mt][1], as[mt][1]);
        split_tf32(p[4], ab[mt][2], as[mt][2]);
        split_tf32(p[8 * GS + 4], ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* p = qs + (wq + nt * 8 + g) * QS + kk + t;
        split_tf32(p[0], bb[nt][0], bs[nt][0]);
        split_tf32(p[4], bb[nt][1], bs[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], as[mt], bb[nt]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
    }
  }
};

template <> struct TcMath<uint16_t> {
  static __device__ __forceinline__ void slice(const uint16_t* gs,
                                               const float* qs, int wr,
                                               int wq, int g, int t,
                                               float (&acc)[4][4][4]) {
    constexpr int GS = TcTile<uint16_t>::kGStride;
    constexpr int QS = TcTile<uint16_t>::kQStride;
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 16) {
      uint32_t a[4][4], b[3][4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint32_t* p = reinterpret_cast<const uint32_t*>(
            gs + (wr + mt * 16 + g) * GS + kk + 2 * t);
        a[mt][0] = p[0];
        a[mt][1] = p[8 * GS / 2];
        a[mt][2] = p[4];
        a[mt][3] = p[8 * GS / 2 + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* p = qs + (wq + nt * 8 + g) * QS + kk + 2 * t;
        const float2 lo = *reinterpret_cast<const float2*>(p);
        const float2 hi = *reinterpret_cast<const float2*>(p + 8);
        uint32_t wl[3], wh[3];
        split_bf16x3(lo.x, lo.y, wl);
        split_bf16x3(hi.x, hi.y, wh);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          b[i][nt][0] = wl[i];
          b[i][nt][1] = wh[i];
        }
      }
#pragma unroll
      for (int i = 2; i >= 0; --i)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[i][nt]);
    }
  }
};

// Stage 1 of the batched route. Grid (query tiles of 128, gallery splits of
// tiles_per_split tiles of 128 rows). Writes the (Q, splits, K) partials
// that topk_merge_kernel reads.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 1)
topk_tc_kernel(const float* __restrict__ q, const T* __restrict__ g, int Q,
               int N, int D, int tiles_per_split, int splits,
               float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float* scores =
      reinterpret_cast<float*>(smem + kTcStages * tc_stage_bytes<T>());

  const int q0 = blockIdx.x * kTcQueries;
  const int split = blockIdx.y;
  const int tile0 = split * tiles_per_split;
  const int tiles = max(0, min((N + kTcRows - 1) / kTcRows,
                               tile0 + tiles_per_split) - tile0);
  const int nk = (D + kTcK - 1) / kTcK;
  const int steps = tiles * nk;
  auto stage = [&](int step) {
    tc_stage<T>(sbase + (step % kTcStages) * tc_stage_bytes<T>(), q, g, Q, N,
                D, q0, (tile0 + step / nk) * kTcRows, (step % nk) * kTcK);
  };
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < steps) stage(s);
    cp_async_commit();
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gi = lane >> 2, ti = lane & 3;
  const int wr = (warp / (kTcQueries / kTcWarpQueries)) * kTcWarpRows;
  const int wq = (warp % (kTcQueries / kTcWarpQueries)) * kTcWarpQueries;
  // the scan: thread -> (query, half of the tile's rows)
  const int my_q = threadIdx.x % kTcQueries;
  const int my_rows = (threadIdx.x / kTcQueries) * kTcScanRows;
  const bool q_ok = q0 + my_q < Q;
  float best_s[K];
  int best_i[K];
  clear<K>(best_s, best_i);
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kTcStages - 2>();   // this step's slice has landed
    __syncthreads();                  // and every warp is done with the last
    if (step + kTcStages - 1 < steps) stage(step + kTcStages - 1);
    cp_async_commit();
    const unsigned char* buf = smem + (step % kTcStages) * tc_stage_bytes<T>();
    TcMath<T>::slice(reinterpret_cast<const T*>(buf),
                     reinterpret_cast<const float*>(buf + tc_g_bytes<T>()),
                     wr, wq, gi, ti, acc);
    // fold the slice's sums into the tile's scores (query-major) with IEEE
    // adds, and start the next slice from zero: the tensor cores truncate
    // as they accumulate, and one chain of 288 mma over D = 768 drifts by
    // ~1e-5. Each score is owned by one thread, in a fixed order.
    const int ks = step % nk;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wr + mt * 16 + gi + (i >> 1) * 8;
          const int qq = wq + nt * 8 + 2 * ti + (i & 1);
          float& s = scores[qq * kTcScoreStride + row];
          s = ks == 0 ? acc[mt][nt][i] : s + acc[mt][nt][i];
          acc[mt][nt][i] = 0.f;
        }
    if (ks != nk - 1) continue;

    // the tile is done: each thread scans its query's half of the rows
    __syncthreads();
    if (q_ok) {
      const int row0 = (tile0 + step / nk) * kTcRows + my_rows;
      const float* mine = scores + my_q * kTcScoreStride + my_rows;
#pragma unroll 4
      for (int j = 0; j < kTcScanRows; ++j) {
        const int r = (j + (lane >> 3)) & (kTcScanRows - 1);
        if (row0 + r < N) insert<K>(best_s, best_i, mine[r], row0 + r);
      }
    }
    // the next tile's scores are written after at least one more barrier
  }

  // merge the two halves' lists of each query
  __syncthreads();
  float* cs = scores;
  int* ci = reinterpret_cast<int*>(scores + kThreads * K);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    cs[threadIdx.x * K + j] = best_s[j];
    ci[threadIdx.x * K + j] = best_i[j];
  }
  __syncthreads();
  if (threadIdx.x < kTcQueries && q_ok) {
    const int other = (threadIdx.x + kTcQueries) * K;
#pragma unroll
    for (int j = 0; j < K; ++j)
      insert<K>(best_s, best_i, cs[other + j], ci[other + j]);
    const size_t out = (static_cast<size_t>(q0 + my_q) * splits + split) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      part_s[out + j] = best_s[j];
      part_i[out + j] = best_i[j];
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

template <typename T, int K>
cudaError_t launch_tc(const float* q, const T* g, int Q, int N, int D, int k,
                      int splits, int tiles_per_split, float* part_s,
                      int* part_i, float* out_s, int64_t* out_i,
                      cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<T>();
  static_assert(smem <= 232448, "one block's shared memory");
  static_assert(kThreads * K * 8 <= kTcQueries * kTcScoreStride * 4,
                "the halves' lists fit where the scores were");
  auto kernel = topk_tc_kernel<T, K>;
  static size_t granted[kSmemAttrDevices] = {};
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel),
                                       smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + kTcQueries - 1) / kTcQueries, splits);
  kernel<<<grid, kThreads, smem, stream>>>(q, g, Q, N, D, tiles_per_split,
                                           splits, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int merge_blocks = (Q + kMergeWarps - 1) / kMergeWarps;
  topk_merge_kernel<K><<<merge_blocks, kMergeWarps * 32, 0, stream>>>(
      part_s, part_i, Q, splits * K, k, out_s, out_i);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc_k(int kcap, const float* q, const T* g, int Q, int N,
                        int D, int k, int splits, int tiles_per_split,
                        float* part_s, int* part_i, float* out_s,
                        int64_t* out_i, cudaStream_t stream) {
  switch (kcap) {
    case 8:
      return launch_tc<T, 8>(q, g, Q, N, D, k, splits, tiles_per_split,
                             part_s, part_i, out_s, out_i, stream);
    case 16:
      return launch_tc<T, 16>(q, g, Q, N, D, k, splits, tiles_per_split,
                              part_s, part_i, out_s, out_i, stream);
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

// The batched route (tensor cores). Arguments as above; the gallery is cut
// into tiles of 128 rows, tiles_per_split of them a split, and
// splits * tiles_per_split * 128 >= N. D must be a multiple of 4 (f32
// gallery) or 8 (bf16), and q and g 16-byte aligned.
int hairci_topk_gallery_search_tc(const void* q, const void* g, int g_bf16,
                                  int Q, int N, int D, int k, int kcap,
                                  int splits, int tiles_per_split,
                                  void* part_s, void* part_i, void* out_s,
                                  void* out_i, void* stream) {
  const int vec = g_bf16 ? 8 : 4;
  if (k < 1 || k > kcap || Q < 1 || N < 1 || D < 1 || splits < 1 ||
      tiles_per_split < 1 || D % vec != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
      static_cast<long long>(splits) * tiles_per_split * kTcRows < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* os = static_cast<float*>(out_s);
  int64_t* oi = static_cast<int64_t*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      g_bf16 ? launch_tc_k<uint16_t>(kcap, qf,
                                     static_cast<const uint16_t*>(g), Q, N, D,
                                     k, splits, tiles_per_split, ps, pi, os,
                                     oi, st)
             : launch_tc_k<float>(kcap, qf, static_cast<const float*>(g), Q,
                                  N, D, k, splits, tiles_per_split, ps, pi,
                                  os, oi, st);
  return static_cast<int>(err);
}

const char* hairci_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
