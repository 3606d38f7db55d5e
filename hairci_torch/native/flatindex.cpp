// Host flat index of the port: its own copy of hairci/native/flatindex.cpp,
// byte for byte the same file format (magic | dim | metric | n | data), so
// each package reads the other's files. It stands in for the reference's
// FAISS IndexFlatL2/IP (the reference's HairPretraining/app/inference.py:
// 79-131 and DualViewHair's quantitative_eval.py:120-155) on the host: for
// CPU-only deployments, index persistence, and processes without a card.
// The card's search is GalleryIndex with the CUDA top-k kernel.
//
// Exact top-k semantics match GalleryIndex: inner-product (or negative
// squared-L2) scores descending, ties broken by lower row index.
// Multi-threaded over queries with std::thread.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

struct FlatIndex {
  int64_t dim;
  int metric;  // 0 = inner product, 1 = L2
  std::vector<float> data;  // row-major (n, dim)
  int64_t n = 0;
};

FlatIndex* flat_index_new(int64_t dim, int metric) {
  auto* idx = new FlatIndex();
  idx->dim = dim;
  idx->metric = metric;
  return idx;
}

void flat_index_free(FlatIndex* idx) { delete idx; }

int64_t flat_index_size(const FlatIndex* idx) { return idx->n; }

void flat_index_add(FlatIndex* idx, const float* vecs, int64_t n) {
  idx->data.insert(idx->data.end(), vecs, vecs + n * idx->dim);
  idx->n += n;
}

static inline float score_row(const float* q, const float* row, int64_t d,
                              int metric) {
  float ip = 0.f, nn = 0.f;
  for (int64_t i = 0; i < d; ++i) {
    ip += q[i] * row[i];
    if (metric == 1) {
      float diff = q[i] - row[i];
      nn += diff * diff;
    }
  }
  return metric == 1 ? -nn : ip;
}

// scores: (nq, k) descending; indices: (nq, k)
void flat_index_search(const FlatIndex* idx, const float* queries, int64_t nq,
                       int64_t k, float* out_scores, int64_t* out_indices,
                       int num_threads) {
  const int64_t d = idx->dim;
  const int64_t n = idx->n;
  k = std::min<int64_t>(k, n);
  if (num_threads <= 0)
    num_threads = std::max(1u, std::thread::hardware_concurrency());

  auto worker = [&](int64_t q0, int64_t q1) {
    std::vector<std::pair<float, int64_t>> heap;
    for (int64_t q = q0; q < q1; ++q) {
      const float* qv = queries + q * d;
      heap.clear();
      heap.reserve(n);
      for (int64_t r = 0; r < n; ++r)
        heap.emplace_back(score_row(qv, idx->data.data() + r * d, d,
                                    idx->metric),
                          r);
      // top-k: descending score, ascending index on ties
      std::partial_sort(heap.begin(), heap.begin() + k, heap.end(),
                        [](const auto& a, const auto& b) {
                          if (a.first != b.first) return a.first > b.first;
                          return a.second < b.second;
                        });
      for (int64_t j = 0; j < k; ++j) {
        out_scores[q * k + j] = heap[j].first;
        out_indices[q * k + j] = heap[j].second;
      }
    }
  };

  std::vector<std::thread> threads;
  int64_t per = (nq + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t q0 = t * per, q1 = std::min<int64_t>(nq, q0 + per);
    if (q0 >= q1) break;
    threads.emplace_back(worker, q0, q1);
  }
  for (auto& t : threads) t.join();
}

// --- persistence: magic | dim | metric | n | data -------------------------
int flat_index_save(const FlatIndex* idx, const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const char magic[8] = {'H', 'C', 'I', 'F', 'L', 'A', 'T', '1'};
  std::fwrite(magic, 1, 8, f);
  int64_t meta[3] = {idx->dim, idx->metric, idx->n};
  std::fwrite(meta, sizeof(int64_t), 3, f);
  std::fwrite(idx->data.data(), sizeof(float), idx->data.size(), f);
  std::fclose(f);
  return 0;
}

FlatIndex* flat_index_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 ||
      std::memcmp(magic, "HCIFLAT1", 8) != 0) {
    std::fclose(f);
    return nullptr;
  }
  int64_t meta[3];
  if (std::fread(meta, sizeof(int64_t), 3, f) != 3) {
    std::fclose(f);
    return nullptr;
  }
  auto* idx = new FlatIndex();
  idx->dim = meta[0];
  idx->metric = static_cast<int>(meta[1]);
  idx->n = meta[2];
  idx->data.resize(idx->n * idx->dim);
  size_t want = idx->data.size();
  if (std::fread(idx->data.data(), sizeof(float), want, f) != want) {
    std::fclose(f);
    delete idx;
    return nullptr;
  }
  std::fclose(f);
  return idx;
}

}  // extern "C"
