// Native marching-tetrahedra iso-surface extraction.
//
// The port's copy of native/marching.cpp: the C++ twin of
// shine_mapping_tpu_torch/ops/marching.py's plain numpy version (same 6-tet
// cube decomposition and first-principles case table), used for large
// meshing jobs where the numpy version is memory- or time-bound.  The
// Python wrapper (ops/marching.py) compiles this at first use with g++
// (ops/native_build.py) and raises when it cannot: it does not fall back.
//
// Replaces the role of skimage.measure.marching_cubes in the reference
// (utils/mesher.py:216): cell-masked iso-surfacing of a dense SDF grid.
//
// Protocol (ctypes): mt_run returns an opaque handle; mt_counts/mt_copy
// read back sizes and data; mt_free releases.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

// cube corners, bit order (x<<2 | y<<1 | z)
const int CUBE[8][3] = {
    {0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
    {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1},
};

// 6 tetrahedra around the 0-7 diagonal (must match ops/marching.py _TETS)
const int TETS[6][4] = {
    {0, 4, 5, 7}, {0, 5, 1, 7}, {0, 1, 3, 7},
    {0, 3, 2, 7}, {0, 2, 6, 7}, {0, 6, 4, 7},
};

const int TET_EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

int edge_id(int a, int b) {
  int lo = a < b ? a : b, hi = a < b ? b : a;
  for (int i = 0; i < 6; ++i)
    if (TET_EDGES[i][0] == lo && TET_EDGES[i][1] == hi) return i;
  return -1;
}

struct CaseTable {
  int tri[16][2][3];
  CaseTable() {
    for (auto& m : tri)
      for (auto& t : m)
        for (auto& e : t) e = -1;
    for (int mask = 1; mask < 15; ++mask) {
      int inside[4], outside[4], ni = 0, no = 0;
      for (int i = 0; i < 4; ++i)
        (mask >> i & 1) ? inside[ni++] = i : outside[no++] = i;
      if (ni == 1) {
        for (int k = 0; k < 3; ++k)
          tri[mask][0][k] = edge_id(inside[0], outside[k]);
      } else if (ni == 3) {
        for (int k = 0; k < 3; ++k)
          tri[mask][0][k] = edge_id(outside[0], inside[k]);
      } else {  // two inside: cyclic quad i0-o0, i1-o0, i1-o1, i0-o1
        int e0 = edge_id(inside[0], outside[0]);
        int e1 = edge_id(inside[1], outside[0]);
        int e2 = edge_id(inside[1], outside[1]);
        int e3 = edge_id(inside[0], outside[1]);
        tri[mask][0][0] = e0; tri[mask][0][1] = e1; tri[mask][0][2] = e2;
        tri[mask][1][0] = e0; tri[mask][1][1] = e2; tri[mask][1][2] = e3;
      }
    }
  }
};

const CaseTable CASES;

struct Result {
  std::vector<double> verts;   // 3 per vertex
  std::vector<int64_t> faces;  // 3 per triangle
};

}  // namespace

extern "C" {

void* mt_run(const float* sdf, const uint8_t* mask, int64_t X, int64_t Y,
             int64_t Z, float level, double spacing, const double* origin) {
  auto* res = new Result();
  if (X < 2 || Y < 2 || Z < 2) return res;

  auto gid = [&](int64_t x, int64_t y, int64_t z) {
    return (x * Y + y) * Z + z;
  };
  auto val = [&](int64_t g) { return (double)sdf[g]; };

  // edge (lo,hi global corner ids) -> vertex index
  std::unordered_map<uint64_t, int64_t> edge_to_vert;
  edge_to_vert.reserve(1 << 16);
  const int64_t NC = X * Y * Z;

  auto vert_on_edge = [&](int64_t ga, int64_t gb) -> int64_t {
    int64_t lo = ga < gb ? ga : gb, hi = ga < gb ? gb : ga;
    uint64_t key = (uint64_t)lo * (uint64_t)NC + (uint64_t)hi;
    auto it = edge_to_vert.find(key);
    if (it != edge_to_vert.end()) return it->second;
    double va = val(lo), vb = val(hi);
    double denom = vb - va;
    double t = std::fabs(denom) > 1e-12 ? (level - va) / denom : 0.5;
    t = t < 0 ? 0 : (t > 1 ? 1 : t);
    double pa[3] = {(double)(lo / (Y * Z)), (double)((lo / Z) % Y),
                    (double)(lo % Z)};
    double pb[3] = {(double)(hi / (Y * Z)), (double)((hi / Z) % Y),
                    (double)(hi % Z)};
    int64_t id = (int64_t)(res->verts.size() / 3);
    for (int k = 0; k < 3; ++k) {
      double p = pa[k] + t * (pb[k] - pa[k]);
      res->verts.push_back(p * spacing + (origin ? origin[k] : 0.0));
    }
    edge_to_vert.emplace(key, id);
    return id;
  };

  double vals8[8];
  int64_t gids8[8];
  for (int64_t cx = 0; cx < X - 1; ++cx) {
    for (int64_t cy = 0; cy < Y - 1; ++cy) {
      for (int64_t cz = 0; cz < Z - 1; ++cz) {
        bool ok = true;
        int in_count = 0;
        for (int k = 0; k < 8; ++k) {
          int64_t g = gid(cx + CUBE[k][0], cy + CUBE[k][1], cz + CUBE[k][2]);
          gids8[k] = g;
          vals8[k] = val(g);
          if (mask && !mask[g]) ok = false;
          if (vals8[k] < level) ++in_count;
        }
        if (!ok || in_count == 0 || in_count == 8) continue;

        for (int t = 0; t < 6; ++t) {
          int m = 0;
          for (int k = 0; k < 4; ++k)
            if (vals8[TETS[t][k]] < level) m |= 1 << k;
          for (int tri = 0; tri < 2; ++tri) {
            if (CASES.tri[m][tri][0] < 0) continue;
            int64_t vid[3];
            for (int c = 0; c < 3; ++c) {
              int e = CASES.tri[m][tri][c];
              int a = TETS[t][TET_EDGES[e][0]];
              int b = TETS[t][TET_EDGES[e][1]];
              vid[c] = vert_on_edge(gids8[a], gids8[b]);
            }
            if (vid[0] == vid[1] || vid[1] == vid[2] || vid[0] == vid[2])
              continue;  // degenerate
            // orient toward +field: normal dot field-gradient estimate
            // (central differences at the triangle centroid handled on the
            // Python side for numpy parity; here use the tet's inside
            // centroid so the normal points away from negative values)
            double ci[3] = {0, 0, 0};
            int ni = 0;
            double co[3] = {0, 0, 0};
            int no = 0;
            for (int k = 0; k < 4; ++k) {
              int corner = TETS[t][k];
              double p[3] = {(double)(cx + CUBE[corner][0]),
                             (double)(cy + CUBE[corner][1]),
                             (double)(cz + CUBE[corner][2])};
              if (vals8[corner] < level) {
                for (int d = 0; d < 3; ++d) ci[d] += p[d];
                ++ni;
              } else {
                for (int d = 0; d < 3; ++d) co[d] += p[d];
                ++no;
              }
            }
            for (int d = 0; d < 3; ++d) {
              ci[d] = ni ? ci[d] / ni : 0;
              co[d] = no ? co[d] / no : 0;
            }
            // direction inside -> outside (grid units)
            double dir[3] = {co[0] - ci[0], co[1] - ci[1], co[2] - ci[2]};
            const double* v0 = &res->verts[vid[0] * 3];
            const double* v1 = &res->verts[vid[1] * 3];
            const double* v2 = &res->verts[vid[2] * 3];
            double e1[3] = {v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2]};
            double e2[3] = {v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2]};
            double n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                           e1[2] * e2[0] - e1[0] * e2[2],
                           e1[0] * e2[1] - e1[1] * e2[0]};
            double dot = n[0] * dir[0] + n[1] * dir[1] + n[2] * dir[2];
            if (dot >= 0) {
              res->faces.push_back(vid[0]);
              res->faces.push_back(vid[1]);
              res->faces.push_back(vid[2]);
            } else {
              res->faces.push_back(vid[0]);
              res->faces.push_back(vid[2]);
              res->faces.push_back(vid[1]);
            }
          }
        }
      }
    }
  }
  return res;
}

void mt_counts(void* handle, int64_t* n_verts, int64_t* n_faces) {
  auto* res = (Result*)handle;
  *n_verts = (int64_t)(res->verts.size() / 3);
  *n_faces = (int64_t)(res->faces.size() / 3);
}

void mt_copy(void* handle, double* verts, int64_t* faces) {
  auto* res = (Result*)handle;
  std::memcpy(verts, res->verts.data(), res->verts.size() * sizeof(double));
  std::memcpy(faces, res->faces.data(), res->faces.size() * sizeof(int64_t));
}

void mt_free(void* handle) { delete (Result*)handle; }

}  // extern "C"
