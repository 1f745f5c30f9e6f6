// graphops: host-side graph preprocessing for pygat_tpu_torch.
//
// The port's own copy of the host library beside the JAX package
// (csrc/graphops.cpp, ABI version 1): CSR construction, reverse
// Cuthill-McKee (RCM) node ordering and symmetric-normalised edge weights.
// RCM packs each receiver's senders near it in id order, which is what the
// citation loader's ``reorder=True`` relabels the graph by.
//
// A plain C ABI loaded with ctypes (pygat_tpu_torch/native.py), built with
// the host C++ compiler at first use into pygat_tpu_torch/_build/. All
// functions are single-threaded, allocation-free on the hot path, and
// O(N + E) (the per-row sorts aside).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Counting-sort edges by receiver into CSR. rowptr must hold n+1 entries;
// col_out/perm_out must hold e entries. perm_out[k] = original index of the
// k-th sorted edge (ties keep ascending sender via a stable second pass).
void graphops_build_csr(int64_t n, int64_t e,
                        const int32_t* senders, const int32_t* receivers,
                        int32_t* rowptr, int32_t* col_out, int32_t* perm_out) {
  std::memset(rowptr, 0, sizeof(int32_t) * (n + 1));
  for (int64_t i = 0; i < e; ++i) rowptr[receivers[i] + 1]++;
  for (int64_t r = 0; r < n; ++r) rowptr[r + 1] += rowptr[r];

  // bucket fill (stable in input order), then sort each row by sender
  std::vector<int32_t> cursor(rowptr, rowptr + n);
  for (int64_t i = 0; i < e; ++i) {
    int32_t r = receivers[i];
    int32_t pos = cursor[r]++;
    col_out[pos] = senders[i];
    perm_out[pos] = static_cast<int32_t>(i);
  }
  std::vector<std::pair<int32_t, int32_t>> row;
  for (int64_t r = 0; r < n; ++r) {
    int32_t lo = rowptr[r], hi = rowptr[r + 1];
    if (hi - lo < 2) continue;
    row.clear();
    for (int32_t k = lo; k < hi; ++k) row.emplace_back(col_out[k], perm_out[k]);
    std::sort(row.begin(), row.end());
    for (int32_t k = lo; k < hi; ++k) {
      col_out[k] = row[k - lo].first;
      perm_out[k] = row[k - lo].second;
    }
  }
}

// Reverse Cuthill-McKee ordering over an undirected CSR graph.
// order_out[new_id] = old_id. Deterministic: component seeds are the
// lowest-degree unvisited nodes, neighbors visited in degree order.
void graphops_rcm_order(int64_t n, const int32_t* rowptr, const int32_t* col,
                        int32_t* order_out) {
  std::vector<int32_t> degree(n);
  for (int64_t v = 0; v < n; ++v) degree[v] = rowptr[v + 1] - rowptr[v];

  std::vector<int32_t> by_degree(n);
  for (int64_t v = 0; v < n; ++v) by_degree[v] = static_cast<int32_t>(v);
  std::stable_sort(by_degree.begin(), by_degree.end(),
                   [&](int32_t a, int32_t b) { return degree[a] < degree[b]; });

  std::vector<uint8_t> visited(n, 0);
  std::vector<int32_t> queue;
  queue.reserve(n);
  std::vector<int32_t> nbrs;
  int64_t emitted = 0;
  int64_t seed_scan = 0;

  while (emitted < n) {
    // next unvisited seed (lowest degree)
    while (seed_scan < n && visited[by_degree[seed_scan]]) ++seed_scan;
    int32_t seed = by_degree[seed_scan];
    visited[seed] = 1;
    size_t head = queue.size();
    queue.push_back(seed);
    ++emitted;
    while (head < queue.size()) {
      int32_t v = queue[head++];
      nbrs.clear();
      for (int32_t k = rowptr[v]; k < rowptr[v + 1]; ++k) {
        int32_t u = col[k];
        if (u >= 0 && u < n && !visited[u]) {
          visited[u] = 1;
          nbrs.push_back(u);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(), [&](int32_t a, int32_t b) {
        return degree[a] != degree[b] ? degree[a] < degree[b] : a < b;
      });
      for (int32_t u : nbrs) {
        queue.push_back(u);
        ++emitted;
      }
    }
  }
  // reverse (the "R" in RCM)
  for (int64_t i = 0; i < n; ++i) order_out[i] = queue[n - 1 - i];
}

// Symmetric-normalized edge weights in one pass:
// w[k] = 1/sqrt(deg[recv_k] * deg[send_k]) over the given (already
// symmetrized, self-looped) edge set — the D^-1/2 (A+I) D^-1/2 values the
// citation pipeline needs (reference utils.py:73-79 semantics for 0/1
// adjacencies).
void graphops_sym_norm_weights(int64_t n, int64_t e,
                               const int32_t* senders, const int32_t* receivers,
                               float* w_out) {
  std::vector<float> deg(n, 0.f);
  for (int64_t i = 0; i < e; ++i) deg[receivers[i]] += 1.f;
  std::vector<float> inv_sqrt(n);
  for (int64_t v = 0; v < n; ++v)
    inv_sqrt[v] = deg[v] > 0.f ? 1.f / std::sqrt(deg[v]) : 0.f;
  for (int64_t i = 0; i < e; ++i)
    w_out[i] = inv_sqrt[receivers[i]] * inv_sqrt[senders[i]];
}

int32_t graphops_abi_version() { return 1; }

}  // extern "C"
