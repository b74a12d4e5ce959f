// Fast Wavefront OBJ tokenizer.
//
// Native counterpart of the reference's Python OBJ parsing
// (gendr/functional/load_obj.py:109-142): the reference splits every line in
// Python, which dominates load time for large meshes.  This single-pass C++
// scanner feeds gendr_jax.geometry.obj_io.parse_obj through ctypes; the
// Python parser remains as a fallback.
//
// Semantics matched: 'v x y z [r g b]' vertices (+ optional colors),
// 'vt u v', polygon 'f' statements triangulated as a fan with optional
// /texture indices ('//' means no texture index), usemtl/mtllib tracking.

#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <string>
#include <vector>

namespace {

struct Parsed {
  std::vector<float> vertices;       // 3 per vertex
  std::vector<float> colors;         // 3 per vertex (optional, all-or-none)
  std::vector<float> vt;             // 2 per texcoord
  std::vector<int32_t> faces;        // 3 per face (0-based)
  std::vector<int32_t> tex_faces;    // 3 per face (0-based, -1 if absent)
  std::vector<int32_t> face_material;  // material table index per face
  std::string mtllib;
  std::string materials;             // '\n'-joined material name table
  bool has_colors = true;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') p++;
  return p < end ? p + 1 : end;
}

inline const char* parse_float(const char* p, const char* end, float* out) {
  char* q;
  *out = strtof(p, &q);
  return q > p && q <= end ? q : nullptr;
}

}  // namespace

extern "C" {

struct ObjResult {
  const float* vertices;
  int64_t num_vertices;
  const float* colors;       // null when not every vertex carried a color
  const float* vt;
  int64_t num_vt;
  const int32_t* faces;
  const int32_t* tex_faces;
  const int32_t* face_material;
  int64_t num_faces;
  const char* mtllib;        // empty string if absent
  const char* materials;     // '\n'-joined material-name table
  void* handle;
};

ObjResult* obj_parse(const char* text, int64_t len) {
  auto* d = new Parsed();
  const char* p = text;
  const char* end = text + len;
  std::vector<std::string> mat_table;
  int32_t current_mat = -1;

  while (p < end) {
    p = skip_ws(p, end);
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') line_end++;

    if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      const char* q = p + 2;
      float xyz[6];
      int n = 0;
      for (; n < 6; n++) {
        q = skip_ws(q, line_end);
        if (q >= line_end) break;
        const char* r = parse_float(q, line_end, &xyz[n]);
        if (!r) break;
        q = r;
      }
      if (n >= 3) {
        d->vertices.insert(d->vertices.end(), xyz, xyz + 3);
        if (n >= 6) {
          d->colors.insert(d->colors.end(), xyz + 3, xyz + 6);
        } else {
          d->has_colors = false;
        }
      }
    } else if (p + 2 < end && p[0] == 'v' && p[1] == 't' &&
               (p[2] == ' ' || p[2] == '\t')) {
      const char* q = p + 3;
      float uv[2] = {0, 0};
      for (int n = 0; n < 2; n++) {
        q = skip_ws(q, line_end);
        const char* r = parse_float(q, line_end, &uv[n]);
        if (!r) break;
        q = r;
      }
      d->vt.insert(d->vt.end(), uv, uv + 2);
    } else if (p + 1 < end && p[0] == 'f' &&
               (p[1] == ' ' || p[1] == '\t')) {
      // collect polygon corners (vertex_idx, tex_idx)
      std::vector<std::pair<int32_t, int32_t>> corners;
      const char* q = p + 2;
      while (true) {
        q = skip_ws(q, line_end);
        if (q >= line_end) break;
        char* r;
        long v = strtol(q, &r, 10);
        if (r == q) break;
        q = r;
        long t = 0;  // reference: texture index 0 when absent
        if (q < line_end && *q == '/') {
          q++;
          if (q < line_end && *q != '/') {
            t = strtol(q, &r, 10);
            q = r;
          }
          if (q < line_end && *q == '/') {  // normal index: skip
            q++;
            strtol(q, &r, 10);
            q = r;
          }
        }
        corners.emplace_back((int32_t)v, (int32_t)t);
      }
      // triangle fan (load_obj.py:131-136)
      for (size_t i = 0; i + 2 < corners.size(); i++) {
        d->faces.push_back(corners[0].first - 1);
        d->faces.push_back(corners[i + 1].first - 1);
        d->faces.push_back(corners[i + 2].first - 1);
        d->tex_faces.push_back(corners[0].second - 1);
        d->tex_faces.push_back(corners[i + 1].second - 1);
        d->tex_faces.push_back(corners[i + 2].second - 1);
        d->face_material.push_back(current_mat);
      }
    } else if (line_end - p > 7 && strncmp(p, "usemtl", 6) == 0) {
      const char* q = skip_ws(p + 6, line_end);
      std::string name(q, line_end - q);
      while (!name.empty() &&
             (name.back() == '\r' || name.back() == ' ')) name.pop_back();
      current_mat = -1;
      for (size_t i = 0; i < mat_table.size(); i++)
        if (mat_table[i] == name) current_mat = (int32_t)i;
      if (current_mat < 0) {
        mat_table.push_back(name);
        current_mat = (int32_t)mat_table.size() - 1;
      }
    } else if (line_end - p > 7 && strncmp(p, "mtllib", 6) == 0) {
      const char* q = skip_ws(p + 6, line_end);
      d->mtllib.assign(q, line_end - q);
      while (!d->mtllib.empty() && (d->mtllib.back() == '\r' ||
                                    d->mtllib.back() == ' '))
        d->mtllib.pop_back();
    }
    p = next_line(line_end, end);
  }

  for (size_t i = 0; i < mat_table.size(); i++) {
    if (i) d->materials += '\n';
    d->materials += mat_table[i];
  }

  auto* res = new ObjResult();
  res->vertices = d->vertices.data();
  res->num_vertices = (int64_t)(d->vertices.size() / 3);
  res->colors = (d->has_colors && !d->colors.empty() &&
                 d->colors.size() == d->vertices.size())
                    ? d->colors.data() : nullptr;
  res->vt = d->vt.data();
  res->num_vt = (int64_t)(d->vt.size() / 2);
  res->faces = d->faces.data();
  res->tex_faces = d->tex_faces.data();
  res->face_material = d->face_material.data();
  res->num_faces = (int64_t)(d->faces.size() / 3);
  res->mtllib = d->mtllib.c_str();
  res->materials = d->materials.c_str();
  res->handle = d;
  return res;
}

void obj_free(ObjResult* res) {
  delete static_cast<Parsed*>(res->handle);
  delete res;
}

}  // extern "C"
