// Host-side native graph builder (a copy of the JAX package's
// native/graph_builder.cpp, comments aside; the code is the same).
//
// The analogue of the reference's native data layer: COO->CSC/CSR
// conversion with edge perm (the reference's src/data/storage.rs:103-127)
// and ind2ptr (storage.rs:67-101, whose serial loop carries a
// "TODO: parallelize").  Large graphs (ogbn-products: 124M edges) cannot
// afford a Python-loop build; this uses a two-pass stable counting sort —
// O(E + N), serial histogram + gather — instead of the reference's
// O(E log E) argsort, and emits the same (ptrs, indices, perm) triple.
//
// Also carries a golden sequential neighbor sampler (xorshift RNG) used by
// the benchmark harness as the measured stand-in for the reference's Rust
// CPU sampler, mirroring the hot loop of
// the reference's src/algo/neighbor_sampling.rs:195-218.
//
// Build: g++ -O3 -fopenmp -shared -fPIC (see native/__init__.py), into
// build/native/ at the root of the checkout.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Sorted leading-index array -> pointer array (storage.rs:67-101 semantics).
void tgt_ind2ptr(const int64_t* ind, int64_t nnz, int64_t m, int64_t* out) {
  // out[i] = number of entries < i  (ind is sorted ascending)
  int64_t idx = 0;
  out[0] = 0;
  for (int64_t i = 0; i < m; ++i) {
    while (idx < nnz && ind[idx] < i + 1) ++idx;
    out[i + 1] = idx;
  }
}

// COO -> CSC (csc=1) or CSR (csc=0) with stable (major, minor) order and
// perm mapping sorted position -> original edge id.
// Outputs: ptrs (n_major+1), indices (E), perm (E).
void tgt_coo_to_csx(const int64_t* row, const int64_t* col, int64_t E,
                    int64_t num_rows, int64_t num_cols, int csc,
                    int64_t* ptrs, int64_t* indices, int64_t* perm) {
  const int64_t* major = csc ? col : row;   // sorted first
  const int64_t* minor = csc ? row : col;   // sorted within major
  const int64_t n_major = csc ? num_cols : num_rows;
  const int64_t n_minor = csc ? num_rows : num_cols;

  // Pass 1: stable counting sort by minor.
  std::vector<int64_t> tmp_perm(E);
  {
    std::vector<int64_t> hist(n_minor + 1, 0);
    for (int64_t e = 0; e < E; ++e) ++hist[minor[e] + 1];
    for (int64_t i = 0; i < n_minor; ++i) hist[i + 1] += hist[i];
    for (int64_t e = 0; e < E; ++e) tmp_perm[hist[minor[e]]++] = e;
  }

  // Pass 2: stable counting sort by major (over the minor-sorted order).
  {
    std::vector<int64_t> hist(n_major + 1, 0);
    for (int64_t e = 0; e < E; ++e) ++hist[major[e] + 1];
    for (int64_t i = 0; i < n_major; ++i) hist[i + 1] += hist[i];
    // ptrs = prefix histogram
    for (int64_t i = 0; i <= n_major; ++i) ptrs[i] = hist[i];
    for (int64_t k = 0; k < E; ++k) {
      const int64_t e = tmp_perm[k];
      const int64_t pos = hist[major[e]]++;
      perm[pos] = e;
      indices[pos] = minor[e];
    }
  }
}

// xorshift64* PRNG — documented golden RNG for the CPU reference sampler.
static inline uint64_t xs64(uint64_t* s) {
  uint64_t x = *s;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  *s = x;
  return x * 0x2545F4914F6CDD1DULL;
}

// Golden sequential uniform-with-replacement neighbor sampler over CSC —
// the measured CPU baseline analogue of the reference's hot loop
// (neighbor_sampling.rs:195-218).  Layer-wise expansion, tree semantics.
// Returns number of sampled nodes.  Buffers must hold the full capacity:
// cap = n_inputs * prod(1 + fanout_l) upper bound; caller sizes them.
int64_t tgt_neighbor_sample_golden(
    const int64_t* col_ptrs, const int64_t* row_indices,
    const int64_t* inputs, int64_t n_inputs,
    const int64_t* fanouts, int64_t n_hops,
    uint64_t seed,
    int64_t* samples, int64_t* rows, int64_t* cols, int64_t* eptr,
    int64_t* n_edges_out) {
  uint64_t st = seed ? seed : 0x9E3779B97F4A7C15ULL;
  int64_t n = 0, m = 0;
  for (int64_t i = 0; i < n_inputs; ++i) samples[n++] = inputs[i];
  int64_t begin = 0, end = n;
  for (int64_t h = 0; h < n_hops; ++h) {
    const int64_t k = fanouts[h];
    for (int64_t i = begin; i < end; ++i) {
      const int64_t w = samples[i];
      const int64_t lo = col_ptrs[w], hi = col_ptrs[w + 1];
      const int64_t deg = hi - lo;
      if (deg == 0) continue;
      for (int64_t s = 0; s < k; ++s) {
        const int64_t e = lo + (int64_t)(xs64(&st) % (uint64_t)deg);
        const int64_t v = row_indices[e];
        rows[m] = n;
        cols[m] = i;
        eptr[m] = e;
        ++m;
        samples[n++] = v;
      }
    }
    begin = end;
    end = n;
  }
  *n_edges_out = m;
  return n;
}

// Golden WITHOUT-replacement sampler: Algorithm-R reservoir per frontier
// node — the reference's exact law (src/utils/sampling.rs:
// 6-26, used by UnweightedSampler<false>).  Same tree layout as the
// with-replacement golden above.
int64_t tgt_neighbor_sample_golden_wor(
    const int64_t* col_ptrs, const int64_t* row_indices,
    const int64_t* inputs, int64_t n_inputs,
    const int64_t* fanouts, int64_t n_hops,
    uint64_t seed,
    int64_t* samples, int64_t* rows, int64_t* cols, int64_t* eptr,
    int64_t* n_edges_out) {
  uint64_t st = seed ? seed : 0x9E3779B97F4A7C15ULL;
  int64_t n = 0, m = 0;
  for (int64_t i = 0; i < n_inputs; ++i) samples[n++] = inputs[i];
  int64_t begin = 0, end = n;
  std::vector<int64_t> res;
  for (int64_t h = 0; h < n_hops; ++h) {
    const int64_t k = fanouts[h];
    res.resize(k);
    for (int64_t i = begin; i < end; ++i) {
      const int64_t w = samples[i];
      const int64_t lo = col_ptrs[w], hi = col_ptrs[w + 1];
      int64_t cnt = 0;
      for (int64_t e = lo; e < hi; ++e) {       // reservoir over the row
        if (cnt < k) {
          res[cnt] = e;
        } else {
          const int64_t j = (int64_t)(xs64(&st) % (uint64_t)(cnt + 1));
          if (j < k) res[j] = e;
        }
        ++cnt;
      }
      const int64_t got = cnt < k ? cnt : k;
      for (int64_t s = 0; s < got; ++s) {
        rows[m] = n;
        cols[m] = i;
        eptr[m] = res[s];
        ++m;
        samples[n++] = row_indices[res[s]];
      }
    }
    begin = end;
    end = n;
  }
  *n_edges_out = m;
  return n;
}

// Golden WEIGHTED reservoir sampler: A-Chao-style running-weight-sum
// acceptance with random-slot eviction — the reference's WeightedSampler
// law (src/utils/sampling.rs:28-55).
int64_t tgt_neighbor_sample_golden_weighted(
    const int64_t* col_ptrs, const int64_t* row_indices,
    const double* edge_weights,
    const int64_t* inputs, int64_t n_inputs,
    const int64_t* fanouts, int64_t n_hops,
    uint64_t seed,
    int64_t* samples, int64_t* rows, int64_t* cols, int64_t* eptr,
    int64_t* n_edges_out) {
  uint64_t st = seed ? seed : 0x9E3779B97F4A7C15ULL;
  const double inv = 1.0 / (double)UINT64_MAX;
  int64_t n = 0, m = 0;
  for (int64_t i = 0; i < n_inputs; ++i) samples[n++] = inputs[i];
  int64_t begin = 0, end = n;
  std::vector<int64_t> res;
  for (int64_t h = 0; h < n_hops; ++h) {
    const int64_t k = fanouts[h];
    res.resize(k);
    for (int64_t i = begin; i < end; ++i) {
      const int64_t w = samples[i];
      const int64_t lo = col_ptrs[w], hi = col_ptrs[w + 1];
      double wsum = 0.0;
      int64_t cnt = 0;
      for (int64_t e = lo; e < hi; ++e) {
        const double we = edge_weights[e];
        wsum += we;
        if (cnt < k) {
          res[cnt] = e;
        } else if ((double)xs64(&st) * inv < we * (double)k / wsum) {
          res[(int64_t)(xs64(&st) % (uint64_t)k)] = e;
        }
        ++cnt;
      }
      const int64_t got = cnt < k ? cnt : k;
      for (int64_t s = 0; s < got; ++s) {
        rows[m] = n;
        cols[m] = i;
        eptr[m] = res[s];
        ++m;
        samples[n++] = row_indices[res[s]];
      }
    }
    begin = end;
    end = n;
  }
  *n_edges_out = m;
  return n;
}

// Golden node2vec walk: the reference's rejection loop verbatim
// (src/algo/random_walk.rs:10-75) — unbounded rejection,
// binary-search has_edge on the SORTED neighbor list (graph.rs:80-83).
void tgt_random_walk_golden(
    const int64_t* row_ptrs, const int64_t* col_indices,
    const int64_t* start, int64_t n_starts, int64_t walk_length,
    double p, double q, uint64_t seed, int64_t* walks /* n*(L+1) */) {
  uint64_t st = seed ? seed : 0x9E3779B97F4A7C15ULL;
  const double inv = 1.0 / (double)UINT64_MAX;
  const double inv_p = 1.0 / p, inv_q = 1.0 / q;
  double maxp = inv_p > 1.0 ? inv_p : 1.0;
  if (inv_q > maxp) maxp = inv_q;
  const double prob0 = inv_p / maxp, prob1 = 1.0 / maxp, prob2 = inv_q / maxp;
  auto has_edge = [&](int64_t u, int64_t v) {
    int64_t lo = row_ptrs[u], hi = row_ptrs[u + 1];
    while (lo < hi) {                        // binary search (sorted row)
      const int64_t mid = lo + (hi - lo) / 2;
      if (col_indices[mid] < v) lo = mid + 1; else hi = mid;
    }
    return lo < row_ptrs[u + 1] && col_indices[lo] == v;
  };
  for (int64_t i = 0; i < n_starts; ++i) {
    int64_t prev = -1, cur = start[i];
    walks[i * (walk_length + 1)] = cur;
    for (int64_t l = 0; l < walk_length; ++l) {
      const int64_t lo = row_ptrs[cur], hi = row_ptrs[cur + 1];
      const int64_t deg = hi - lo;
      if (deg == 0) {
        for (int64_t r = l; r < walk_length; ++r)
          walks[i * (walk_length + 1) + r + 1] = -1;
        break;
      }
      int64_t nxt;
      for (;;) {                             // rejection loop (rs:52-66)
        nxt = col_indices[lo + (int64_t)(xs64(&st) % (uint64_t)deg)];
        const double r = (double)xs64(&st) * inv;
        if (prev < 0) break;
        if (nxt == prev) { if (r < prob0) break; }
        else if (has_edge(nxt, prev)) { if (r < prob1) break; }
        else if (r < prob2) break;
      }
      walks[i * (walk_length + 1) + l + 1] = nxt;
      prev = cur;
      cur = nxt;
    }
  }
}

}  // extern "C"
