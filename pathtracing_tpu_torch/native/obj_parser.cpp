// Fast Wavefront OBJ geometry parser (native analog of the reference's
// Assimp import path, Model.cpp:39-83).
//
// The Python line loop in io/obj.py is the wall for San-Miguel-scale
// imports (minutes for a ~250MB OBJ); this parser reads the whole file
// and scans it with inline strtof/strtoll at >100MB/s.  Geometry only:
// v/vn/vt/f/usemtl/mtllib — MTL files and material inference stay in
// Python (they are tiny).
//
// Plain C ABI, loaded with ctypes (native/loader.py):
//   obj_open(path)            -> handle (NULL on failure)
//   obj_counts(h, ...)        -> fills element counts + name blob sizes
//   obj_fill(h, ...)          -> copies parsed arrays into caller buffers
//   obj_free(h)
//
// Faces are fan-triangulated (matching io/obj.py and Assimp's
// aiProcess_Triangulate for convex polygons) and indices are resolved to
// 0-based (negative OBJ indices are relative to the count seen so far,
// exactly the sequential semantics).  Absent t/n indices become -1.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> v, vn, vt;
  std::vector<long long> tri;    // [n_tri * 9]: (vi,ti,ni) x 3 corners
  std::vector<int> tri_mat;      // usemtl index per tri (-1 none)
  std::string usemtl_blob;       // '\0'-joined usemtl names, in order
  std::string mtllib_blob;       // '\0'-joined mtllib args, in order
  long long n_usemtl = 0;
  long long n_mtllib = 0;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* line_end(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p;
}

inline float parse_f(const char*& p) {
  char* q;
  float x = strtof(p, &q);
  p = q;
  return x;
}

}  // namespace

extern "C" {

void* obj_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize((size_t)size);
  if (size && fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  auto* d = new ObjData();
  // heuristic reserves keep reallocation off the hot path
  d->v.reserve((size_t)(size / 40) * 3);
  d->tri.reserve((size_t)(size / 30) * 9);

  const char* p = buf.data();
  const char* end = p + buf.size();
  int cur_mat = -1;
  std::vector<long long> corners;  // vi,ti,ni per corner of current face
  while (p < end) {
    p = skip_ws(p, end);
    const char* eol = line_end(p, end);
    if (p >= eol) { p = eol + 1; continue; }
    char c0 = p[0];
    char c1 = (p + 1 < eol) ? p[1] : '\0';
    if (c0 == 'v' && (c1 == ' ' || c1 == '\t')) {
      p += 1;
      float x = parse_f(p), y = parse_f(p), z = parse_f(p);
      d->v.push_back(x); d->v.push_back(y); d->v.push_back(z);
    } else if (c0 == 'v' && c1 == 'n') {
      p += 2;
      float x = parse_f(p), y = parse_f(p), z = parse_f(p);
      d->vn.push_back(x); d->vn.push_back(y); d->vn.push_back(z);
    } else if (c0 == 'v' && c1 == 't') {
      p += 2;
      float u = parse_f(p);
      const char* q = skip_ws(p, eol);
      float w = (q < eol && (*q == '-' || *q == '.' ||
                             (*q >= '0' && *q <= '9'))) ? parse_f(p) : 0.0f;
      d->vt.push_back(u); d->vt.push_back(w);
    } else if (c0 == 'f' && (c1 == ' ' || c1 == '\t')) {
      p += 1;
      corners.clear();
      long long nv = (long long)d->v.size() / 3;
      long long nt = (long long)d->vt.size() / 2;
      long long nn = (long long)d->vn.size() / 3;
      while (true) {
        p = skip_ws(p, eol);
        if (p >= eol) break;
        char* q;
        long long vi = strtoll(p, &q, 10);
        if (q == p) break;
        p = q;
        long long ti = 0, ni = 0;
        if (p < eol && *p == '/') {
          ++p;
          if (p < eol && *p != '/') { ti = strtoll(p, &q, 10); p = q; }
          if (p < eol && *p == '/') { ++p; ni = strtoll(p, &q, 10); p = q; }
        }
        // 0-based fix-up; 0 (absent) -> -1; negative -> relative
        vi = vi > 0 ? vi - 1 : (vi < 0 ? nv + vi : -1);
        ti = ti > 0 ? ti - 1 : (ti < 0 ? nt + ti : -1);
        ni = ni > 0 ? ni - 1 : (ni < 0 ? nn + ni : -1);
        corners.push_back(vi);
        corners.push_back(ti);
        corners.push_back(ni);
      }
      size_t ncorn = corners.size() / 3;
      for (size_t k = 1; k + 1 < ncorn; ++k) {
        const size_t a = 0, b = k, cc = k + 1;
        for (size_t corner : {a, b, cc}) {
          d->tri.push_back(corners[corner * 3 + 0]);
          d->tri.push_back(corners[corner * 3 + 1]);
          d->tri.push_back(corners[corner * 3 + 2]);
        }
        d->tri_mat.push_back(cur_mat);
      }
    } else if (!strncmp(p, "usemtl", 6)) {
      const char* q = skip_ws(p + 6, eol);
      d->usemtl_blob.append(q, (size_t)(eol - q));
      while (!d->usemtl_blob.empty() &&
             (d->usemtl_blob.back() == '\r' ||
              d->usemtl_blob.back() == ' '))
        d->usemtl_blob.pop_back();
      d->usemtl_blob.push_back('\0');
      cur_mat = (int)d->n_usemtl++;
    } else if (!strncmp(p, "mtllib", 6)) {
      const char* q = skip_ws(p + 6, eol);
      d->mtllib_blob.append(q, (size_t)(eol - q));
      while (!d->mtllib_blob.empty() &&
             (d->mtllib_blob.back() == '\r' ||
              d->mtllib_blob.back() == ' '))
        d->mtllib_blob.pop_back();
      d->mtllib_blob.push_back('\0');
      ++d->n_mtllib;
    }
    p = eol + 1;
  }
  return d;
}

void obj_counts(void* h, long long* nv, long long* nvn, long long* nvt,
                long long* ntri, long long* n_usemtl,
                long long* usemtl_bytes, long long* n_mtllib,
                long long* mtllib_bytes) {
  auto* d = (ObjData*)h;
  *nv = (long long)d->v.size() / 3;
  *nvn = (long long)d->vn.size() / 3;
  *nvt = (long long)d->vt.size() / 2;
  *ntri = (long long)d->tri_mat.size();
  *n_usemtl = d->n_usemtl;
  *usemtl_bytes = (long long)d->usemtl_blob.size();
  *n_mtllib = d->n_mtllib;
  *mtllib_bytes = (long long)d->mtllib_blob.size();
}

void obj_fill(void* h, float* v, float* vn, float* vt, long long* tri,
              int* tri_mat, char* usemtl, char* mtllib) {
  auto* d = (ObjData*)h;
  memcpy(v, d->v.data(), d->v.size() * sizeof(float));
  memcpy(vn, d->vn.data(), d->vn.size() * sizeof(float));
  memcpy(vt, d->vt.data(), d->vt.size() * sizeof(float));
  memcpy(tri, d->tri.data(), d->tri.size() * sizeof(long long));
  memcpy(tri_mat, d->tri_mat.data(), d->tri_mat.size() * sizeof(int));
  memcpy(usemtl, d->usemtl_blob.data(), d->usemtl_blob.size());
  memcpy(mtllib, d->mtllib_blob.data(), d->mtllib_blob.size());
}

void obj_free(void* h) { delete (ObjData*)h; }

}  // extern "C"
