// obj_parse — the port's Wavefront OBJ parser: the OBJ part of
// native/rnr_native.cpp, with none of its image decoding, so that it
// builds with g++ alone (no libjpeg, no libpng) on any Linux host.
//
// A memory-mapped two-pass parser behind a plain C ABI, loaded by
// rnr_tpu_torch/data/native.py through ctypes:
//   rnr_obj_count(path, counts)  counts v, vt, vn and the triangles of
//                                the faces' fan triangulation
//   rnr_obj_parse(path, v, vt, vn, fv, fvt, fvn)
//                                fills caller-allocated arrays sized by
//                                rnr_obj_count
// Both return 0, or -1 where the file cannot be mapped.
//
// Build: g++ -O3 -fPIC -std=c++17 -shared -o libobj_parse.so obj_parse.cpp

#include <cctype>
#include <cstdint>
#include <cstdlib>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>


extern "C" {

// ---------------------------------------------------------------------------
// OBJ parsing
// ---------------------------------------------------------------------------

struct ObjCounts {
  int64_t nv;
  int64_t nvt;
  int64_t nvn;
  int64_t nf;  // triangles after fan triangulation
};

namespace {

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

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// fast float parse (OBJ floats are simple decimal, optional exponent)
inline const char* parse_float(const char* p, const char* end, float* out) {
  char* q = nullptr;
  *out = strtof(p, &q);
  return q && q <= end ? q : p;
}

inline const char* parse_int(const char* p, const char* end, long* out) {
  char* q = nullptr;
  *out = strtol(p, &q, 10);
  return q && q <= end ? q : p;
}

// parse one face corner "v[/vt[/vn]]"; returns updated pointer
inline const char* parse_corner(const char* p, const char* end, long* vi,
                                long* ti, long* ni, bool* has_t,
                                bool* has_n) {
  *has_t = *has_n = false;
  p = parse_int(p, end, vi);
  if (p < end && *p == '/') {
    ++p;
    if (p < end && *p != '/') {
      p = parse_int(p, end, ti);
      *has_t = true;
    }
    if (p < end && *p == '/') {
      ++p;
      p = parse_int(p, end, ni);
      *has_n = true;
    }
  }
  return p;
}

inline int64_t resolve_idx(long i, int64_t count) {
  return i > 0 ? i - 1 : count + i;
}

}  // namespace

int rnr_obj_count(const char* path, ObjCounts* c) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  c->nv = c->nvt = c->nvn = c->nf = 0;
  const char* p = m.data;
  const char* end = m.data + m.size;
  while (p < end) {
    p = skip_ws(p, end);
    if (p + 1 < end && p[0] == 'v') {
      if (p[1] == ' ' || p[1] == '\t')
        ++c->nv;
      else if (p[1] == 't')
        ++c->nvt;
      else if (p[1] == 'n')
        ++c->nvn;
    } else if (p < end && p[0] == 'f') {
      // count corners on this face line
      int corners = 0;
      const char* q = p + 1;
      while (q < end && *q != '\n') {
        q = skip_ws(q, end);
        if (q < end && (isdigit(*q) || *q == '-')) {
          ++corners;
          while (q < end && *q != ' ' && *q != '\t' && *q != '\n' &&
                 *q != '\r')
            ++q;
        } else {
          ++q;
        }
      }
      if (corners >= 3) c->nf += corners - 2;
    }
    p = next_line(p, end);
  }
  unmap(m);
  return 0;
}

// Fills caller-allocated arrays sized from rnr_obj_count:
//   v [nv*3], vt [nvt*2], vn [nvn*3], fv/fvt/fvn [nf*3] (int32, -1 if absent)
int rnr_obj_parse(const char* path, float* v, float* vt, float* vn,
                  int32_t* fv, int32_t* fvt, int32_t* fvn) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t iv = 0, it = 0, in_ = 0, itri = 0;
  long c_v[64], c_t[64], c_n[64];
  bool c_ht[64], c_hn[64];
  while (p < end) {
    p = skip_ws(p, end);
    if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      const char* q = p + 2;
      for (int k = 0; k < 3; ++k) {
        q = skip_ws(q, end);
        q = parse_float(q, end, &v[iv * 3 + k]);
      }
      ++iv;
    } else if (p + 1 < end && p[0] == 'v' && p[1] == 't') {
      const char* q = p + 2;
      for (int k = 0; k < 2; ++k) {
        q = skip_ws(q, end);
        q = parse_float(q, end, &vt[it * 2 + k]);
      }
      ++it;
    } else if (p + 1 < end && p[0] == 'v' && p[1] == 'n') {
      const char* q = p + 2;
      for (int k = 0; k < 3; ++k) {
        q = skip_ws(q, end);
        q = parse_float(q, end, &vn[in_ * 3 + k]);
      }
      ++in_;
    } else if (p < end && p[0] == 'f') {
      const char* q = p + 1;
      int corners = 0;
      while (q < end && *q != '\n' && corners < 64) {
        q = skip_ws(q, end);
        if (q < end && (isdigit(*q) || *q == '-')) {
          q = parse_corner(q, end, &c_v[corners], &c_t[corners],
                           &c_n[corners], &c_ht[corners], &c_hn[corners]);
          ++corners;
        } else if (q < end && *q != '\n') {
          ++q;
        }
      }
      for (int k = 1; k + 1 < corners; ++k) {
        int tri[3] = {0, k, k + 1};
        for (int j = 0; j < 3; ++j) {
          int ci = tri[j];
          fv[itri * 3 + j] =
              static_cast<int32_t>(resolve_idx(c_v[ci], iv));
          fvt[itri * 3 + j] =
              c_ht[ci] ? static_cast<int32_t>(resolve_idx(c_t[ci], it)) : -1;
          fvn[itri * 3 + j] =
              c_hn[ci] ? static_cast<int32_t>(resolve_idx(c_n[ci], in_)) : -1;
        }
        ++itri;
      }
    }
    p = next_line(p, end);
  }
  unmap(m);
  return 0;
}

}  // extern "C"
