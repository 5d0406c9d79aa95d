// zenith_native: host-side native runtime of the PyTorch port
// (raytracer_project_tpu_torch), a copy of the reference package's
// csrc/zenith_native.cpp kept with the port so that it builds without the
// reference package: the binned-SAH BVH build (the reference engine's
// bvh.hpp:9-44 role), OBJ parsing (model.hpp + TinyObjLoader) and PNG
// export (stb_image_write, camera.hpp:779). The device path is PyTorch and
// CUDA; this library does the host-side work where Python is slow.
//
// C ABI only (consumed via ctypes from raytracer_project_tpu_torch/native).
// Build: g++ -O3 -std=c++20 -shared -fPIC zenith_native.cpp -o libzenith_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BVH builder: binned SAH, flat threaded (escape-link) output — the same
// contract as the Python builder in ops/bvh.py (_flatten): DFS order, left
// child at i+1, escape(-1)-terminated traversal.
// ---------------------------------------------------------------------------

struct zn_bvh {
  float* node_min;     // [n_nodes * 3]
  float* node_max;     // [n_nodes * 3]
  int32_t* escape;     // [n_nodes]
  int32_t* first;      // [n_nodes] leaf: offset into leaf_order; internal: -1
  int32_t* count;      // [n_nodes] leaf: prim count; internal: 0
  int32_t* level;      // [n_nodes]
  int64_t* leaf_order; // [n_prims] original primitive ids, leaf-contiguous
  int32_t n_nodes;
  int64_t n_prims;
  int32_t n_levels;
  int32_t max_leaf;    // largest emitted leaf (gather width for traversal)
};

namespace {

struct V3 { float x, y, z; };

inline V3 vmin(V3 a, V3 b) { return {std::min(a.x,b.x), std::min(a.y,b.y), std::min(a.z,b.z)}; }
inline V3 vmax(V3 a, V3 b) { return {std::max(a.x,b.x), std::max(a.y,b.y), std::max(a.z,b.z)}; }

inline float half_area(V3 mn, V3 mx) {
  float dx = std::max(mx.x - mn.x, 0.f), dy = std::max(mx.y - mn.y, 0.f),
        dz = std::max(mx.z - mn.z, 0.f);
  return dx * dy + dy * dz + dz * dx;
}

struct BuildNode {
  V3 mn, mx;
  int32_t left = -1, right = -1;   // indices into node pool
  int64_t first = -1, count = 0;   // leaf range in the id array
  int32_t size = 1;                // subtree node count (for escape links)
};

struct Builder {
  const float* pmin;
  const float* pmax;
  std::vector<V3> cent;
  std::vector<int64_t> ids;
  std::vector<BuildNode> pool;
  int leaf_size;
  int bins;

  V3 get(const float* a, int64_t i) const { return {a[3*i], a[3*i+1], a[3*i+2]}; }

  // Build over ids[lo, hi); returns pool index. Iterative via explicit
  // recursion on ranges (depth is fine: SAH splits are balanced enough, and
  // we guard with a median fallback).
  int32_t build(int64_t lo, int64_t hi) {
    V3 mn = {INFINITY, INFINITY, INFINITY}, mx = {-INFINITY, -INFINITY, -INFINITY};
    V3 cmn = mn, cmx = mx;
    for (int64_t i = lo; i < hi; ++i) {
      mn = vmin(mn, get(pmin, ids[i]));
      mx = vmax(mx, get(pmax, ids[i]));
      cmn = vmin(cmn, cent[ids[i]]);
      cmx = vmax(cmx, cent[ids[i]]);
    }
    int32_t me = (int32_t)pool.size();
    pool.push_back({mn, mx});
    int64_t n = hi - lo;
    if (n <= leaf_size) {
      pool[me].first = lo;
      pool[me].count = n;
      return me;
    }

    // Binned SAH on the largest centroid-extent axis.
    float ext[3] = {cmx.x - cmn.x, cmx.y - cmn.y, cmx.z - cmn.z};
    int axis = ext[1] > ext[0] ? (ext[2] > ext[1] ? 2 : 1) : (ext[2] > ext[0] ? 2 : 0);
    int64_t mid = -1;
    if (ext[axis] > 1e-12f) {
      float lo_c = axis == 0 ? cmn.x : axis == 1 ? cmn.y : cmn.z;
      float scale = bins * (1.0f - 1e-6f) / ext[axis];
      std::vector<int64_t> bcount(bins, 0);
      std::vector<V3> bmn(bins, {INFINITY, INFINITY, INFINITY});
      std::vector<V3> bmx(bins, {-INFINITY, -INFINITY, -INFINITY});
      auto bin_of = [&](int64_t id) {
        float c = axis == 0 ? cent[id].x : axis == 1 ? cent[id].y : cent[id].z;
        int b = (int)((c - lo_c) * scale);
        return std::min(std::max(b, 0), bins - 1);
      };
      for (int64_t i = lo; i < hi; ++i) {
        int b = bin_of(ids[i]);
        bcount[b]++;
        bmn[b] = vmin(bmn[b], get(pmin, ids[i]));
        bmx[b] = vmax(bmx[b], get(pmax, ids[i]));
      }
      // Sweep costs.
      std::vector<float> rarea(bins, 0.f);
      std::vector<int64_t> rcnt(bins, 0);
      {
        V3 rmn = {INFINITY, INFINITY, INFINITY}, rmx = {-INFINITY, -INFINITY, -INFINITY};
        int64_t c = 0;
        for (int b = bins - 1; b >= 1; --b) {
          rmn = vmin(rmn, bmn[b]); rmx = vmax(rmx, bmx[b]); c += bcount[b];
          rarea[b] = half_area(rmn, rmx); rcnt[b] = c;
        }
      }
      float best_cost = INFINITY;
      int best_b = -1;
      {
        V3 lmn = {INFINITY, INFINITY, INFINITY}, lmx = {-INFINITY, -INFINITY, -INFINITY};
        int64_t c = 0;
        for (int b = 0; b < bins - 1; ++b) {
          lmn = vmin(lmn, bmn[b]); lmx = vmax(lmx, bmx[b]); c += bcount[b];
          if (c == 0 || rcnt[b + 1] == 0) continue;
          float cost = half_area(lmn, lmx) * c + rarea[b + 1] * rcnt[b + 1];
          if (cost < best_cost) { best_cost = cost; best_b = b; }
        }
      }
      if (best_b >= 0) {
        // Leaf-vs-split test mirrors the Python builder (_sah_split):
        // only allow "don't split" for modest ranges.
        float whole = half_area(mn, mx);
        if (!(best_cost >= whole * n && n <= 2 * (int64_t)leaf_size)) {
          auto it = std::partition(ids.begin() + lo, ids.begin() + hi,
                                   [&](int64_t id) { return bin_of(id) <= best_b; });
          mid = it - ids.begin();
          if (mid == lo || mid == hi) mid = -1;  // degenerate partition
        } else {
          pool[me].first = lo;
          pool[me].count = n;
          return me;
        }
      }
    }
    if (mid < 0) {  // median fallback on the largest axis
      mid = lo + n / 2;
      std::nth_element(ids.begin() + lo, ids.begin() + mid, ids.begin() + hi,
                       [&](int64_t a, int64_t b) {
                         float ca = axis == 0 ? cent[a].x : axis == 1 ? cent[a].y : cent[a].z;
                         float cb = axis == 0 ? cent[b].x : axis == 1 ? cent[b].y : cent[b].z;
                         return ca < cb;
                       });
    }
    int32_t l = build(lo, mid);
    int32_t r = build(mid, hi);
    pool[me].left = l;
    pool[me].right = r;
    pool[me].size = 1 + pool[l].size + pool[r].size;
    return me;
  }
};

}  // namespace

zn_bvh* zn_bvh_build(int64_t n, const float* pmin, const float* pmax,
                     int32_t leaf_size, int32_t bins) {
  if (n <= 0 || leaf_size <= 0) return nullptr;
  Builder b;
  b.pmin = pmin;
  b.pmax = pmax;
  b.leaf_size = leaf_size;
  b.bins = bins > 1 ? bins : 16;
  b.cent.resize(n);
  b.ids.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    b.cent[i] = {(pmin[3*i] + pmax[3*i]) * 0.5f,
                 (pmin[3*i+1] + pmax[3*i+1]) * 0.5f,
                 (pmin[3*i+2] + pmax[3*i+2]) * 0.5f};
    b.ids[i] = i;
  }
  b.pool.reserve(2 * n);
  int32_t root = b.build(0, n);

  // Flatten DFS with escape links (same emission order as ops/bvh.py
  // _flatten: node, then left subtree, then right subtree).
  int32_t n_nodes = b.pool[root].size;
  auto* out = (zn_bvh*)std::malloc(sizeof(zn_bvh));
  out->node_min = (float*)std::malloc(sizeof(float) * 3 * n_nodes);
  out->node_max = (float*)std::malloc(sizeof(float) * 3 * n_nodes);
  out->escape = (int32_t*)std::malloc(sizeof(int32_t) * n_nodes);
  out->first = (int32_t*)std::malloc(sizeof(int32_t) * n_nodes);
  out->count = (int32_t*)std::malloc(sizeof(int32_t) * n_nodes);
  out->level = (int32_t*)std::malloc(sizeof(int32_t) * n_nodes);
  out->leaf_order = (int64_t*)std::malloc(sizeof(int64_t) * n);
  out->n_nodes = n_nodes;
  out->n_prims = n;
  out->n_levels = 1;
  out->max_leaf = 1;

  struct Frame { int32_t node; int32_t escape; int32_t level; };
  std::vector<Frame> stack;
  stack.push_back({root, -1, 0});
  int32_t cursor = 0;
  int64_t leaf_cursor = 0;
  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    const BuildNode& node = b.pool[f.node];
    int32_t i = cursor++;
    out->node_min[3*i] = node.mn.x; out->node_min[3*i+1] = node.mn.y; out->node_min[3*i+2] = node.mn.z;
    out->node_max[3*i] = node.mx.x; out->node_max[3*i+1] = node.mx.y; out->node_max[3*i+2] = node.mx.z;
    out->escape[i] = f.escape;
    out->level[i] = f.level;
    if (f.level + 1 > out->n_levels) out->n_levels = f.level + 1;
    if (node.left < 0) {  // leaf
      out->first[i] = (int32_t)leaf_cursor;
      out->count[i] = (int32_t)node.count;
      if ((int32_t)node.count > out->max_leaf) out->max_leaf = (int32_t)node.count;
      std::memcpy(out->leaf_order + leaf_cursor, b.ids.data() + node.first,
                  sizeof(int64_t) * node.count);
      leaf_cursor += node.count;
    } else {
      out->first[i] = -1;
      out->count[i] = 0;
      int32_t right_at = i + 1 + b.pool[node.left].size;
      stack.push_back({node.right, f.escape, f.level + 1});
      stack.push_back({node.left, right_at, f.level + 1});
    }
  }
  return out;
}

void zn_bvh_free(zn_bvh* p) {
  if (!p) return;
  std::free(p->node_min); std::free(p->node_max); std::free(p->escape);
  std::free(p->first); std::free(p->count); std::free(p->level);
  std::free(p->leaf_order); std::free(p);
}

// ---------------------------------------------------------------------------
// OBJ parser: v / vn / f with fan triangulation and negative indices —
// byte-compatible output with models/obj.py parse_obj (the Python oracle).
// ---------------------------------------------------------------------------

struct zn_mesh {
  double* v0; double* v1; double* v2;   // [count * 3]
  double* n0; double* n1; double* n2;   // [count * 3] (valid if has_normals)
  int64_t count;
  int32_t has_normals;
};

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

}  // namespace

zn_mesh* zn_obj_parse(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string data(sz, '\0');
  if (sz > 0 && std::fread(data.data(), 1, sz, f) != (size_t)sz) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  std::vector<double> verts;     // xyz triples
  std::vector<double> normals;   // xyz triples
  struct Corner { int64_t v, n; };
  std::vector<Corner> tri;       // 3 corners per triangle

  const char* p = data.data();
  const char* end = p + data.size();
  std::vector<Corner> corners;
  while (p < end) {
    const char* eol = (const char*)memchr(p, '\n', end - p);
    if (!eol) eol = end;
    const char* q = skip_ws(p, eol);
    if (eol - q >= 2 && q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
      char* r = const_cast<char*>(q + 1);
      for (int k = 0; k < 3; ++k) verts.push_back(std::strtod(r, &r));
    } else if (eol - q >= 3 && q[0] == 'v' && q[1] == 'n' &&
               (q[2] == ' ' || q[2] == '\t')) {
      char* r = const_cast<char*>(q + 2);
      for (int k = 0; k < 3; ++k) normals.push_back(std::strtod(r, &r));
    } else if (eol - q >= 2 && q[0] == 'f' && (q[1] == ' ' || q[1] == '\t')) {
      corners.clear();
      const char* r = q + 1;
      while (r < eol) {
        r = skip_ws(r, eol);
        if (r >= eol) break;
        char* after = nullptr;
        long vi = std::strtol(r, &after, 10);
        if (after == r) break;
        r = after;
        int64_t v = vi > 0 ? vi - 1 : (int64_t)(verts.size() / 3) + vi;
        int64_t nidx = -1;
        if (r < eol && *r == '/') {
          ++r;                                   // skip to vt field
          while (r < eol && *r != '/' && *r != ' ' && *r != '\t') ++r;
          if (r < eol && *r == '/') {
            ++r;
            long ni = std::strtol(r, &after, 10);
            if (after != r) {
              r = after;
              nidx = ni > 0 ? ni - 1 : (int64_t)(normals.size() / 3) + ni;
            }
          }
        }
        corners.push_back({v, nidx});
      }
      for (size_t k = 1; k + 1 < corners.size(); ++k) {
        tri.push_back(corners[0]);
        tri.push_back(corners[k]);
        tri.push_back(corners[k + 1]);
      }
    }
    p = eol + 1;
  }

  int64_t count = (int64_t)tri.size() / 3;
  auto* out = (zn_mesh*)std::malloc(sizeof(zn_mesh));
  out->count = count;
  size_t bytes = sizeof(double) * 3 * std::max<int64_t>(count, 1);
  out->v0 = (double*)std::malloc(bytes);
  out->v1 = (double*)std::malloc(bytes);
  out->v2 = (double*)std::malloc(bytes);
  out->n0 = (double*)std::malloc(bytes);
  out->n1 = (double*)std::malloc(bytes);
  out->n2 = (double*)std::malloc(bytes);
  // has_normals mirrors the Python parser: normals exist AND every
  // triangle's FIRST corner carries a normal index (models/obj.py:74).
  bool has_n = !normals.empty();
  for (int64_t t = 0; t < count && has_n; ++t)
    if (tri[3 * t].n < 0) has_n = false;
  out->has_normals = has_n ? 1 : 0;

  auto fetch = [&](std::vector<double>& table, int64_t idx, double* dst) {
    int64_t rows = (int64_t)table.size() / 3;
    if (idx < 0) idx += rows;  // Python negative-index wrap (nn[-1])
    if (idx < 0 || idx >= rows) { dst[0] = dst[1] = dst[2] = 0.0; return; }
    dst[0] = table[3*idx]; dst[1] = table[3*idx+1]; dst[2] = table[3*idx+2];
  };
  for (int64_t t = 0; t < count; ++t) {
    fetch(verts, tri[3*t].v, out->v0 + 3*t);
    fetch(verts, tri[3*t+1].v, out->v1 + 3*t);
    fetch(verts, tri[3*t+2].v, out->v2 + 3*t);
    if (has_n) {
      fetch(normals, tri[3*t].n, out->n0 + 3*t);
      fetch(normals, tri[3*t+1].n, out->n1 + 3*t);
      fetch(normals, tri[3*t+2].n, out->n2 + 3*t);
    }
  }
  return out;
}

void zn_mesh_free(zn_mesh* m) {
  if (!m) return;
  std::free(m->v0); std::free(m->v1); std::free(m->v2);
  std::free(m->n0); std::free(m->n1); std::free(m->n2);
  std::free(m);
}

// ---------------------------------------------------------------------------
// PNG writer: filter-0 scanlines, zlib stream with *stored* deflate blocks
// (valid everywhere, zero dependencies; stb_image_write replacement for
// camera.hpp:779). Returns 0 on success.
// ---------------------------------------------------------------------------

namespace {

uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24); v.push_back(x >> 16); v.push_back(x >> 8); v.push_back(x);
}

uint32_t crc32_raw(uint32_t state, const uint8_t* buf, size_t len) {
  // Unfinalized CRC update (state carries the inverted register).
  if (!crc_init_done) crc_init();
  for (size_t i = 0; i < len; ++i)
    state = crc_table[(state ^ buf[i]) & 0xFF] ^ (state >> 8);
  return state;
}

void write_chunk(FILE* f, const char* tag, const uint8_t* data, size_t len) {
  uint8_t hdr[8];
  hdr[0] = (uint8_t)(len >> 24); hdr[1] = (uint8_t)(len >> 16);
  hdr[2] = (uint8_t)(len >> 8); hdr[3] = (uint8_t)len;
  std::memcpy(hdr + 4, tag, 4);
  std::fwrite(hdr, 1, 8, f);
  if (len) std::fwrite(data, 1, len, f);
  uint32_t crc = crc32_raw(0xFFFFFFFFu, hdr + 4, 4);
  if (len) crc = crc32_raw(crc, data, len);
  crc ^= 0xFFFFFFFFu;
  uint8_t cb[4] = {(uint8_t)(crc >> 24), (uint8_t)(crc >> 16), (uint8_t)(crc >> 8), (uint8_t)crc};
  std::fwrite(cb, 1, 4, f);
}

}  // namespace

int32_t zn_png_write(const char* path, int32_t w, int32_t h,
                     const uint8_t* rgb) {
  if (w <= 0 || h <= 0 || !rgb) return -1;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -2;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  std::fwrite(sig, 1, 8, f);

  uint8_t ihdr[13];
  ihdr[0] = (uint8_t)(w >> 24); ihdr[1] = (uint8_t)(w >> 16); ihdr[2] = (uint8_t)(w >> 8); ihdr[3] = (uint8_t)w;
  ihdr[4] = (uint8_t)(h >> 24); ihdr[5] = (uint8_t)(h >> 16); ihdr[6] = (uint8_t)(h >> 8); ihdr[7] = (uint8_t)h;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  write_chunk(f, "IHDR", ihdr, 13);

  // Raw scanlines with filter byte 0.
  size_t stride = (size_t)w * 3;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int32_t y = 0; y < h; ++y) {
    raw[(stride + 1) * y] = 0;
    std::memcpy(raw.data() + (stride + 1) * y + 1, rgb + stride * y, stride);
  }

  // zlib stream: 0x78 0x01 + stored deflate blocks + adler32.
  std::vector<uint8_t> z;
  z.reserve(raw.size() + raw.size() / 65535 * 5 + 16);
  z.push_back(0x78); z.push_back(0x01);
  size_t pos = 0;
  while (pos < raw.size()) {
    size_t n = std::min<size_t>(65535, raw.size() - pos);
    bool final = pos + n == raw.size();
    z.push_back(final ? 1 : 0);
    z.push_back((uint8_t)(n & 0xFF)); z.push_back((uint8_t)(n >> 8));
    z.push_back((uint8_t)(~n & 0xFF)); z.push_back((uint8_t)((~n >> 8) & 0xFF));
    z.insert(z.end(), raw.begin() + pos, raw.begin() + pos + n);
    pos += n;
  }
  uint32_t a = 1, b2 = 0;
  for (uint8_t byte : raw) {
    a = (a + byte) % 65521;
    b2 = (b2 + a) % 65521;
  }
  put_be32(z, (b2 << 16) | a);

  write_chunk(f, "IDAT", z.data(), z.size());
  write_chunk(f, "IEND", nullptr, 0);
  std::fclose(f);
  return 0;
}

const char* zn_version() { return "zenith_native 0.1.0"; }

}  // extern "C"
