// Fast CARMEN log parser (native data-loader component).
//
// The reference preprocesses CARMEN logs with a line-by-line Python script
// (SURVEY.md §3 "Data preprocessor"); for multi-GB Radish logs feeding an
// accelerator pipeline, the host-side parse becomes the bottleneck, so this
// is the framework's native-runtime piece for L0: a single-pass
// mmap-friendly parser exposed over a C ABI and bound via ctypes
// (slam2d_tpu/data/native.py). Python fallback stays available.
//
// Build: make -C native   (produces libcarmen_parser.so)
//
// ABI:
//   carmen_count(path, *n_scans, *n_beams) -> 0 on success
//   carmen_parse(path, odom[n*3], ranges[n*n_beams], n, n_beams,
//                stamps[n] /* double*, nullable */) -> rows
//
// Row grammar (kept TOKEN-equivalent to the Python loader in
// slam2d_tpu/data/carmen.py — tests/test_native_parser.py asserts
// C++ == Python over the real-world variance matrix):
//   FLASER n r1..rn x y theta [odom_x odom_y odom_theta] ts host log_ts
//     - standard rows carry odometry; legacy pre-2000 rows carry only
//       the laser pose (detected: the 3 tokens after the pose fail to
//       parse — `host` lands where odom_theta would be) and fall back
//       to the laser pose.
//   ROBOTLASER1 cfg1..cfg7 n r1..rn n_rem rem.. lx ly lth rx ry rth ...
//     - the ROBOT pose (rx ry rth) is the odometry; config, remission
//       and laser-pose tokens are counted but not numerically validated
//       (token-parity with the Python slicing).
// Numbers are STRICT whitespace-delimited tokens ("1.2.3" fails, as in
// Python float()); a comma decimal separator is accepted ("1,5" ->
// 1.5 — European-locale logs).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Cursor {
  const char* p;
  const char* end;
};

inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\r';
}

inline void skip_spaces(Cursor& c) {
  while (c.p < c.end && is_space(*c.p)) ++c.p;
}

inline void skip_line(Cursor& c) {
  while (c.p < c.end && *c.p != '\n') ++c.p;
  if (c.p < c.end) ++c.p;
}

// Skip one whitespace-delimited token without validating it. Returns
// false at end of line/input (token missing).
inline bool skip_token(Cursor& c) {
  skip_spaces(c);
  if (c.p >= c.end || *c.p == '\n') return false;
  while (c.p < c.end && !is_space(*c.p) && *c.p != '\n') ++c.p;
  return true;
}

// A parsed number must end exactly at a token boundary (Python float()
// semantics: "1.2.3" is NOT a number).
inline bool at_token_end(const Cursor& c) {
  return c.p >= c.end || is_space(*c.p) || *c.p == '\n';
}

// Fast strtod-free float parse (CARMEN floats are plain decimal).
// Accepts ',' as a decimal separator (European-locale logs).
inline bool parse_double(Cursor& c, double* out) {
  skip_spaces(c);
  const char* s = c.p;
  bool neg = false;
  if (c.p < c.end && (*c.p == '-' || *c.p == '+')) {
    neg = (*c.p == '-');
    ++c.p;
  }
  double v = 0.0;
  bool any = false;
  while (c.p < c.end && *c.p >= '0' && *c.p <= '9') {
    v = v * 10.0 + (*c.p - '0');
    ++c.p;
    any = true;
  }
  if (c.p < c.end && (*c.p == '.' || *c.p == ',')) {
    ++c.p;
    double f = 0.1;
    while (c.p < c.end && *c.p >= '0' && *c.p <= '9') {
      v += (*c.p - '0') * f;
      f *= 0.1;
      ++c.p;
      any = true;
    }
  }
  if (any && c.p < c.end && (*c.p == 'e' || *c.p == 'E')) {
    ++c.p;
    bool eneg = false;
    if (c.p < c.end && (*c.p == '-' || *c.p == '+')) {
      eneg = (*c.p == '-');
      ++c.p;
    }
    int ex = 0;
    bool edig = false;
    while (c.p < c.end && *c.p >= '0' && *c.p <= '9') {
      ex = ex * 10 + (*c.p - '0');
      ++c.p;
      edig = true;
    }
    if (!edig) {
      c.p = s;
      return false;
    }
    double scale = 1.0;
    while (ex-- > 0) scale *= 10.0;
    v = eneg ? v / scale : v * scale;
  }
  if (!any || !at_token_end(c)) {
    c.p = s;
    return false;
  }
  *out = neg ? -v : v;
  return true;
}

// Strict integer token (Python int() semantics: "70.5" fails).
inline bool parse_long(Cursor& c, long* out) {
  skip_spaces(c);
  const char* s = c.p;
  bool neg = false;
  if (c.p < c.end && (*c.p == '-' || *c.p == '+')) {
    neg = (*c.p == '-');
    ++c.p;
  }
  long v = 0;
  bool any = false;
  while (c.p < c.end && *c.p >= '0' && *c.p <= '9') {
    v = v * 10 + (*c.p - '0');
    ++c.p;
    any = true;
  }
  if (!any || !at_token_end(c)) {
    c.p = s;
    return false;
  }
  *out = neg ? -v : v;
  return true;
}

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const char*>(p);
  m.size = st.st_size;
  return m;
}

void unmap(Mapped& m) {
  if (m.data) munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) close(m.fd);
}

enum RowKind { kNone, kFlaser, kRobotLaser1 };

inline RowKind row_kind(const Cursor& c) {
  if ((c.end - c.p) >= 7 && std::memcmp(c.p, "FLASER ", 7) == 0)
    return kFlaser;
  if ((c.end - c.p) >= 12 && std::memcmp(c.p, "ROBOTLASER1 ", 12) == 0)
    return kRobotLaser1;
  return kNone;
}

// Parse one scan row positioned AT the keyword. On success fills nb,
// odom[3], the ts field in *stamp (NaN when absent — matches the
// Python loader), and (when rrow != nullptr) the nb ranges.
// want_beams < 0 accepts any positive beam count (the count pass's
// latch probe).
bool parse_row(Cursor t, RowKind kind, long want_beams, long* nb_out,
               double odom[3], float* rrow, double* stamp) {
  long nb;
  const double kNan = __builtin_nan("");
  *stamp = kNan;
  if (kind == kFlaser) {
    t.p += 7;
    if (!parse_long(t, &nb) || nb <= 0) return false;
    if (want_beams >= 0 && nb != want_beams) return false;
    for (long i = 0; i < nb; ++i) {
      double v;
      if (!parse_double(t, &v)) return false;
      if (rrow) rrow[i] = static_cast<float>(v);
    }
    double pose[3];
    for (int i = 0; i < 3; ++i)
      if (!parse_double(t, &pose[i])) return false;
    Cursor probe = t;
    double od[3];
    bool have_odom = parse_double(probe, &od[0]) &&
                     parse_double(probe, &od[1]) &&
                     parse_double(probe, &od[2]);
    for (int i = 0; i < 3; ++i) odom[i] = have_odom ? od[i] : pose[i];
    if (have_odom) {
      double ts;
      if (parse_double(probe, &ts)) *stamp = ts;
    } else {
      // legacy row: the first post-pose token IS the ts (it parsed as
      // od[0] in the probe, or failed)
      Cursor p2 = t;
      double ts;
      if (parse_double(p2, &ts)) *stamp = ts;
    }
    *nb_out = nb;
    return true;
  }
  // ROBOTLASER1: 7 config tokens (not validated), n, ranges, n_rem,
  // remission tokens (not validated), laser pose tokens (not
  // validated), robot pose (validated), 5 velocity/safety tokens, ts
  t.p += 12;
  for (int i = 0; i < 7; ++i)
    if (!skip_token(t)) return false;
  if (!parse_long(t, &nb) || nb <= 0) return false;
  if (want_beams >= 0 && nb != want_beams) return false;
  for (long i = 0; i < nb; ++i) {
    double v;
    if (!parse_double(t, &v)) return false;
    if (rrow) rrow[i] = static_cast<float>(v);
  }
  long n_rem;
  if (!parse_long(t, &n_rem) || n_rem < 0) return false;
  for (long i = 0; i < n_rem + 3; ++i)
    if (!skip_token(t)) return false;
  for (int i = 0; i < 3; ++i)
    if (!parse_double(t, &odom[i])) return false;
  {
    Cursor p2 = t;
    bool ok5 = true;
    for (int i = 0; i < 5 && ok5; ++i) ok5 = skip_token(p2);
    double ts;
    if (ok5 && parse_double(p2, &ts)) *stamp = ts;
  }
  *nb_out = nb;
  return true;
}

}  // namespace

extern "C" {

// First pass: count candidate scan rows (allocation upper bound); latch
// the beam count from the first row that FULLY parses (a truncated or
// corrupt first row must not poison the rest of the file — parity with
// the Python loader).
int carmen_count(const char* path, int64_t* n_scans, int64_t* n_beams) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  Cursor c{m.data, m.data + m.size};
  int64_t rows = 0, beams = 0;
  while (c.p < c.end) {
    RowKind kind = row_kind(c);
    if (kind != kNone) {
      if (beams == 0) {
        long nb;
        double od[3], ts;
        if (parse_row(c, kind, -1, &nb, od, nullptr, &ts)) beams = nb;
      }
      ++rows;
    }
    skip_line(c);
  }
  unmap(m);
  *n_scans = rows;
  *n_beams = beams;
  return 0;
}

// Second pass: fill odom [n*3], ranges [n*n_beams] (row-major float32)
// and stamps [n] (f64 ts field, NaN when absent; pass nullptr to skip).
// Rows whose beam count differs from n_beams, or that fail numeric
// parsing, are skipped. Returns rows written, or -1 on IO error.
int64_t carmen_parse(const char* path, float* odom, float* ranges,
                     int64_t n, int64_t n_beams, double* stamps) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  Cursor c{m.data, m.data + m.size};
  int64_t row = 0;
  while (c.p < c.end && row < n) {
    RowKind kind = row_kind(c);
    if (kind == kNone) {
      skip_line(c);
      continue;
    }
    long nb;
    double od[3], ts;
    float* rrow = ranges + row * n_beams;
    if (parse_row(c, kind, n_beams, &nb, od, rrow, &ts)) {
      odom[row * 3 + 0] = static_cast<float>(od[0]);
      odom[row * 3 + 1] = static_cast<float>(od[1]);
      odom[row * 3 + 2] = static_cast<float>(od[2]);
      if (stamps) stamps[row] = ts;
      ++row;
    }
    skip_line(c);
  }
  unmap(m);
  return row;
}

}  // extern "C"
