// Native graph ingest: fast edge-list parser for the reference dataset
// contract (graph.txt: one "src dst" pair per line).
//
// The reference's loader is a C++ istream loop inside its Graph constructor
// [R: graph.h — reconstruction, SURVEY.md Sec. 2.1]; Python-side parsing of
// Twitter/Friendster-scale lists (1.4B+ edges) is the bottleneck, so this
// stays native here too (SURVEY.md Sec. 2.1 native-code checklist item 4).
//
// Exposed via ctypes (no pybind11 in this image): two-pass API — count,
// then fill caller-allocated int64 arrays.
//
// Build: make -C fora/_native   (produces libfora_native.so)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = ::open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (::fstat(m.fd, &st) != 0 || st.st_size == 0) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  ::madvise(p, st.st_size, MADV_SEQUENTIAL);
  m.data = static_cast<const char*>(p);
  m.size = static_cast<size_t>(st.st_size);
  return m;
}

void unmap(Mapped& m) {
  if (m.data) ::munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) ::close(m.fd);
  m.data = nullptr;
  m.fd = -1;
}

// Scan integers; any non-digit run is a separator. '#'-prefixed and '%'-
// prefixed lines (comment conventions of SNAP dumps) are skipped.
template <typename OnPair>
int64_t scan_pairs(const Mapped& m, OnPair&& on_pair) {
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t count = 0;
  while (p < end) {
    // skip comment lines
    if (*p == '#' || *p == '%') {
      while (p < end && *p != '\n') ++p;
      if (p < end) ++p;
      continue;
    }
    // parse up to two integers on this line
    int64_t vals[2];
    int got = 0;
    while (p < end && *p != '\n' && got < 2) {
      while (p < end && *p != '\n' && (*p < '0' || *p > '9') && *p != '-') ++p;
      if (p >= end || *p == '\n') break;
      bool neg = (*p == '-');
      if (neg) ++p;
      int64_t v = 0;
      bool any = false;
      while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        ++p;
        any = true;
      }
      if (any) vals[got++] = neg ? -v : v;
    }
    if (got == 2) {
      on_pair(vals[0], vals[1], count);
      ++count;
    }
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  return count;
}

// Scan "src dst weight" triples (weight: decimal float).  Lines with only
// two numbers get weight 1.0 (mixed files behave like the reference's
// verbatim read); comment lines skipped as in scan_pairs.
template <typename OnTriple>
int64_t scan_triples(const Mapped& m, OnTriple&& on_triple) {
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t count = 0;
  while (p < end) {
    if (*p == '#' || *p == '%') {
      while (p < end && *p != '\n') ++p;
      if (p < end) ++p;
      continue;
    }
    int64_t vals[2];
    double w = 1.0;
    int got = 0;
    while (p < end && *p != '\n' && got < 3) {
      while (p < end && *p != '\n' &&
             (*p < '0' || *p > '9') && *p != '-' && *p != '.') ++p;
      if (p >= end || *p == '\n') break;
      bool neg = (*p == '-');
      if (neg) ++p;
      double v = 0.0;
      bool any = false;
      while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10.0 + (*p - '0');
        ++p;
        any = true;
      }
      if (p < end && *p == '.') {
        ++p;
        double place = 0.1;
        while (p < end && *p >= '0' && *p <= '9') {
          v += (*p - '0') * place;
          place *= 0.1;
          ++p;
          any = true;
        }
      }
      if (p < end && (*p == 'e' || *p == 'E')) {  // exponent
        ++p;
        bool eneg = false;
        if (p < end && (*p == '-' || *p == '+')) eneg = (*p++ == '-');
        int ev = 0;
        while (p < end && *p >= '0' && *p <= '9') ev = ev * 10 + (*p++ - '0');
        double f = 1.0;
        for (int i = 0; i < ev; ++i) f *= 10.0;
        v = eneg ? v / f : v * f;
      }
      if (any) {
        if (got < 2) {
          vals[got] = static_cast<int64_t>(neg ? -v : v);
        } else {
          w = neg ? -v : v;
        }
        ++got;
      }
    }
    if (got >= 2) {
      on_triple(vals[0], vals[1], got >= 3 ? w : 1.0, count);
      ++count;
    }
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  return count;
}

}  // namespace

extern "C" {

// Returns edge count, or -1 on I/O error.
int64_t fora_count_edges(const char* path) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  int64_t c = scan_pairs(m, [](int64_t, int64_t, int64_t) {});
  unmap(m);
  return c;
}

// Fills src/dst (caller-allocated, capacity cap). Returns edges written,
// or -1 on I/O error, or -2 if the file holds more than cap edges.
int64_t fora_parse_edges(const char* path, int64_t* src, int64_t* dst,
                         int64_t cap) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  bool overflow = false;
  int64_t c = scan_pairs(m, [&](int64_t a, int64_t b, int64_t i) {
    if (i >= cap) {
      overflow = true;
      return;
    }
    src[i] = a;
    dst[i] = b;
  });
  unmap(m);
  if (overflow) return -2;
  return c;
}

// Walker/Vose alias-table construction over a CSR row partition: for each
// row [indptr[v], indptr[v+1]) build per-slot (prob, other) such that
// sampling slot j uniformly then taking cols[j] w.p. prob[j] (else
// other[j]) draws cols proportionally to w.  O(m) total, no allocation
// beyond two index stacks reused across rows.  Mirrors the Python
// fora/graph/alias.py build (bit-compatible up to float rounding);
// the hot path for weighted-graph ingest at LiveJournal scale.
int64_t fora_build_alias(const int64_t* indptr, const int32_t* cols,
                         const float* w, int64_t n,
                         float* prob, int32_t* other) {
  int64_t max_deg = 0;
  for (int64_t v = 0; v < n; ++v) {
    int64_t d = indptr[v + 1] - indptr[v];
    if (d > max_deg) max_deg = d;
  }
  int64_t* small = static_cast<int64_t*>(
      malloc(sizeof(int64_t) * static_cast<size_t>(max_deg > 0 ? max_deg : 1)));
  int64_t* large = static_cast<int64_t*>(
      malloc(sizeof(int64_t) * static_cast<size_t>(max_deg > 0 ? max_deg : 1)));
  double* p = static_cast<double*>(
      malloc(sizeof(double) * static_cast<size_t>(max_deg > 0 ? max_deg : 1)));
  if (!small || !large || !p) {
    free(small);
    free(large);
    free(p);
    return -1;
  }
  for (int64_t v = 0; v < n; ++v) {
    int64_t lo = indptr[v], hi = indptr[v + 1];
    int64_t d = hi - lo;
    if (d == 0) continue;
    double sum = 0.0;
    for (int64_t i = 0; i < d; ++i) sum += w[lo + i];
    int64_t ns = 0, nl = 0;
    for (int64_t i = 0; i < d; ++i) {
      p[i] = w[lo + i] / sum * static_cast<double>(d);
      prob[lo + i] = 1.0f;
      other[lo + i] = cols[lo + i];
      if (p[i] < 1.0) small[ns++] = i;
      else large[nl++] = i;
    }
    while (ns > 0 && nl > 0) {
      int64_t s = small[--ns];
      int64_t l = large[--nl];
      prob[lo + s] = static_cast<float>(p[s]);
      other[lo + s] = cols[lo + l];
      p[l] = (p[l] + p[s]) - 1.0;
      if (p[l] < 1.0) small[ns++] = l;
      else large[nl++] = l;
    }
    // leftovers (incl. float-rounding stragglers) keep prob 1 / self
  }
  free(small);
  free(large);
  free(p);
  return 0;
}

// Weighted variant: fills src/dst/w (third column; absent -> 1.0).
int64_t fora_parse_edges_w(const char* path, int64_t* src, int64_t* dst,
                           float* w, int64_t cap) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  bool overflow = false;
  int64_t c = scan_triples(m, [&](int64_t a, int64_t b, double wt,
                                  int64_t i) {
    if (i >= cap) {
      overflow = true;
      return;
    }
    src[i] = a;
    dst[i] = b;
    w[i] = static_cast<float>(wt);
  });
  unmap(m);
  if (overflow) return -2;
  return c;
}

}  // extern "C"
