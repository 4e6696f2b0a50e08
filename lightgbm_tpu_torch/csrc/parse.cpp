// Native dense text parser of lightgbm_tpu_torch.io.parser: a host library,
// not a kernel (built by g++, native.py:load_host).  Port of
// lightgbm_tpu/native/parse.cpp with a second entry point for the streaming
// loader's chunks.
//
// Role analogue: the reference's Parser/DatasetLoader text pipeline
// (`src/io/parser.cpp`, `src/io/dataset_loader.cpp:160-264`), which parses
// CSV/TSV with hand-rolled Atof under OpenMP.  Here: one pass to index line
// starts, then std::thread workers strtod-parse disjoint line ranges into a
// preallocated row-major buffer.
//
// Exported C ABI (ctypes):
//   long lgbt_parse_dense(path, delim, skip_rows, &data, &rows, &cols)
//     delim == ' '  → any run of spaces/tabs separates fields
//     otherwise     → single-char delimiter; empty interior fields = NaN,
//                     trailing delimiters ignored (numpy-fallback parity)
//   void lgbt_free(data)
//   long lgbt_parse_lines(buf, len, delim, rows, cols, out)
//     `rows` lines of buf[0, len) separated by '\n' into the caller's
//     (rows, cols) row-major buffer: missing fields NaN, extra ones dropped
//     (the streaming loader's chunks, whose column count the scan fixed)
//
// Build: native.py:load_host("parse")  (g++ -O3 -std=c++17 -shared -fPIC)

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <thread>
#include <vector>

namespace {

// number of data fields in [p, end) for the given delimiter
long count_fields(const char* p, const char* end, char delim) {
  long n = 0;
  if (delim == ' ') {
    bool in_tok = false;
    for (; p < end; ++p) {
      bool ws = (*p == ' ' || *p == '\t');
      if (!ws && !in_tok) { ++n; in_tok = true; }
      if (ws) in_tok = false;
    }
  } else {
    // trailing delimiters do not open a new field
    const char* last = end;
    while (last > p && (last[-1] == delim)) --last;
    if (last > p) {
      n = 1;
      for (const char* q = p; q < last; ++q)
        if (*q == delim) ++n;
    }
  }
  return n;
}

// parse one line's fields into out[0..cols); missing fields -> NaN
void parse_line(const char* p, const char* end, char delim, double* out,
                long cols) {
  const double kNaN = std::numeric_limits<double>::quiet_NaN();
  long c = 0;
  if (delim == ' ') {
    while (p < end && c < cols) {
      while (p < end && (*p == ' ' || *p == '\t')) ++p;
      if (p >= end) break;
      char* q;
      out[c++] = std::strtod(p, &q);
      if (q == p) {  // unparsable token: NaN, skip it
        out[c - 1] = kNaN;
        while (p < end && !(*p == ' ' || *p == '\t')) ++p;
      } else {
        p = q;
      }
    }
  } else {
    while (c < cols) {
      const char* tok_end = p;
      while (tok_end < end && *tok_end != delim) ++tok_end;
      if (tok_end == p) {
        out[c++] = kNaN;  // empty field
      } else {
        char* q;
        double v = std::strtod(p, &q);
        out[c++] = (q == p) ? kNaN : v;
      }
      if (tok_end >= end) break;
      p = tok_end + 1;
    }
  }
  for (; c < cols; ++c) out[c] = kNaN;
}

// parse lines[lo, hi) into data (row i at data + i * cols), on up to the
// machine's threads when there are many
void parse_all(const std::vector<std::pair<const char*, const char*>>& lines,
               char delim, double* data, long cols) {
  long rows = static_cast<long>(lines.size());
  unsigned nthreads = std::thread::hardware_concurrency();
  if (nthreads == 0) nthreads = 1;
  if (rows < 4096) nthreads = 1;
  std::vector<std::thread> workers;
  long chunk = (rows + nthreads - 1) / nthreads;
  for (unsigned t = 0; t < nthreads; ++t) {
    long lo = t * chunk;
    long hi = std::min(rows, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([&, lo, hi]() {
      for (long i = lo; i < hi; ++i)
        parse_line(lines[static_cast<size_t>(i)].first,
                   lines[static_cast<size_t>(i)].second, delim,
                   data + i * cols, cols);
    });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

long lgbt_parse_dense(const char* path, char delim, int skip_rows,
                      double** out_data, long* out_rows, long* out_cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);

  // index non-empty lines
  std::vector<std::pair<const char*, const char*>> lines;
  const char* p = buf.data();
  const char* end = buf.data() + size;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* le = nl ? nl : end;
    const char* trimmed = le;
    while (trimmed > p && (trimmed[-1] == '\r')) --trimmed;
    bool blank = true;
    for (const char* q = p; q < trimmed; ++q)
      if (!std::isspace(static_cast<unsigned char>(*q))) { blank = false; break; }
    if (!blank) lines.emplace_back(p, trimmed);
    p = nl ? nl + 1 : end;
  }
  if (static_cast<size_t>(skip_rows) >= lines.size()) return -3;
  lines.erase(lines.begin(), lines.begin() + skip_rows);

  long rows = static_cast<long>(lines.size());
  long cols = count_fields(lines[0].first, lines[0].second, delim);
  if (cols <= 0) return -4;

  double* data = static_cast<double*>(
      std::malloc(sizeof(double) * static_cast<size_t>(rows) *
                  static_cast<size_t>(cols)));
  if (!data) return -5;

  parse_all(lines, delim, data, cols);

  *out_data = data;
  *out_rows = rows;
  *out_cols = cols;
  return rows * cols;
}

void lgbt_free(double* pdata) { std::free(pdata); }

long lgbt_parse_lines(const char* buf, long len, char delim, long rows,
                      long cols, double* out) {
  std::vector<std::pair<const char*, const char*>> lines;
  lines.reserve(static_cast<size_t>(rows));
  const char* p = buf;
  const char* end = buf + len;
  while (static_cast<long>(lines.size()) < rows) {
    const char* nl = p < end ? static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p))) : nullptr;
    const char* le = nl ? nl : end;
    lines.emplace_back(p, le);
    if (!nl) break;
    p = nl + 1;
  }
  if (static_cast<long>(lines.size()) != rows) return -1;
  parse_all(lines, delim, out, cols);
  return rows * cols;
}

}  // extern "C"
