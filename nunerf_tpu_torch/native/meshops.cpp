// meshops: native mesh utilities for nunerf_tpu_torch.
//
// The port's own copy of nunerf_tpu/native/meshops.cpp, the same algorithms
// line for line, so that the two packages extract, remesh and measure
// curvature identically on one machine.  Host-side C++ over a C ABI for
// ctypes; it replaces the reference's native mesh stack (PyMCubes marching
// cubes, pymesh curvature, the CUDA BVH construction in raytracing/src/bvh.cu).
//
// Components:
//   * extract_isosurface: marching-tetrahedra isosurface extraction (table
//     free, watertight, deduplicated vertices) — stands in for marching
//     cubes at extract_mesh_stage1.py:31-50 scale (1024^3 grids, processed
//     in z-slabs by the Python wrapper).
//   * vertex_normals_angle_weighted + gaussian_curvature (angle defect):
//     replaces DiffRender.py:342-360 (trimesh/pymesh).
//   * cluster_remesh: grid vertex clustering decimation standing in for the
//     pymeshlab isotropic remesh of the extracted mesh.
//   * bvh_build: a 4-wide BVH over the triangles by median splits.
//
// Build: g++ -O3 -march=native -shared -fPIC meshops.cpp -o libmeshops.so
// (nunerf_tpu_torch/native/build.py does this at first use).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Marching tetrahedra
// ---------------------------------------------------------------------------

// Each cube is split into the 6 "path" tetrahedra around the main diagonal
// v0-v7 (one per permutation of +x,+y,+z), vertex-ordered to positive signed
// volume.  This decomposition is face-consistent across neighboring cubes
// (shared-face diagonals agree), so the extracted surface is watertight.
// Corner numbering: bit0 = x, bit1 = y, bit2 = z.
static const int TETS[6][4] = {
    {0, 1, 3, 7}, {0, 5, 1, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 6, 4, 7},
};

struct VKey {
    uint64_t a, b;
    bool operator==(const VKey& o) const { return a == o.a && b == o.b; }
};
struct VKeyHash {
    size_t operator()(const VKey& k) const {
        uint64_t h = k.a * 0x9E3779B97F4A7C15ull ^ (k.b + 0x7F4A7C15ull);
        h ^= h >> 29; h *= 0xBF58476D1CE4E5B9ull; h ^= h >> 32;
        return (size_t)h;
    }
};

// grid: [nx, ny, nz] C-order (z fastest). Emits vertices in *index space*
// (x, y, z in [0, nx-1] etc.); caller rescales to world bounds.
int extract_isosurface(const float* grid, int nx, int ny, int nz, float iso,
                       float** out_verts, int64_t* out_nverts,
                       int32_t** out_tris, int64_t* out_ntris) {
    auto gid = [&](int x, int y, int z) -> uint64_t {
        return ((uint64_t)x * ny + y) * nz + z;
    };
    auto val = [&](uint64_t id) -> float { return grid[id]; };

    std::unordered_map<VKey, int32_t, VKeyHash> edge_map;
    std::vector<float> verts;
    std::vector<int32_t> tris;
    verts.reserve(1 << 16);
    tris.reserve(1 << 16);

    // corner offsets by bit pattern
    const int CX[8] = {0, 1, 0, 1, 0, 1, 0, 1};
    const int CY[8] = {0, 0, 1, 1, 0, 0, 1, 1};
    const int CZ[8] = {0, 0, 0, 0, 1, 1, 1, 1};

    auto edge_vertex = [&](uint64_t ia, uint64_t ib, float va, float vb,
                           const float* pa, const float* pb) -> int32_t {
        VKey key = ia < ib ? VKey{ia, ib} : VKey{ib, ia};
        auto it = edge_map.find(key);
        if (it != edge_map.end()) return it->second;
        float t = (iso - va) / (vb - va);
        if (!(t >= 0.f)) t = 0.f;
        if (!(t <= 1.f)) t = 1.f;
        int32_t idx = (int32_t)(verts.size() / 3);
        verts.push_back(pa[0] + t * (pb[0] - pa[0]));
        verts.push_back(pa[1] + t * (pb[1] - pa[1]));
        verts.push_back(pa[2] + t * (pb[2] - pa[2]));
        edge_map.emplace(key, idx);
        return idx;
    };

    for (int x = 0; x < nx - 1; x++) {
        for (int y = 0; y < ny - 1; y++) {
            for (int z = 0; z < nz - 1; z++) {
                uint64_t cid[8];
                float cv[8];
                float cp[8][3];
                bool all_pos = true, all_neg = true;
                for (int c = 0; c < 8; c++) {
                    int cx = x + CX[c], cy = y + CY[c], cz = z + CZ[c];
                    cid[c] = gid(cx, cy, cz);
                    cv[c] = val(cid[c]);
                    cp[c][0] = (float)cx; cp[c][1] = (float)cy; cp[c][2] = (float)cz;
                    if (cv[c] < iso) all_pos = false; else all_neg = false;
                }
                if (all_pos || all_neg) continue;

                for (int t = 0; t < 6; t++) {
                    const int* T = TETS[t];
                    int inside[4], outside[4];
                    int ni = 0, no = 0;
                    for (int k = 0; k < 4; k++) {
                        if (cv[T[k]] < iso) inside[ni++] = k;
                        else outside[no++] = k;
                    }
                    if (ni == 0 || ni == 4) continue;

                    auto EV = [&](int a, int b) {
                        return edge_vertex(cid[T[a]], cid[T[b]], cv[T[a]],
                                           cv[T[b]], cp[T[a]], cp[T[b]]);
                    };
                    // orientation reference: inside-corner centroid ->
                    // outside-corner centroid (points to the positive side)
                    float ci_[3] = {0, 0, 0}, co_[3] = {0, 0, 0};
                    for (int k = 0; k < ni; k++)
                        for (int d = 0; d < 3; d++) ci_[d] += cp[T[inside[k]]][d] / ni;
                    for (int k = 0; k < no; k++)
                        for (int d = 0; d < 3; d++) co_[d] += cp[T[outside[k]]][d] / no;
                    float ref[3] = {co_[0] - ci_[0], co_[1] - ci_[1], co_[2] - ci_[2]};

                    auto emit = [&](int32_t a, int32_t b, int32_t c) {
                        const float* pa = verts.data() + 3 * a;
                        const float* pb = verts.data() + 3 * b;
                        const float* pc = verts.data() + 3 * c;
                        float u[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
                        float v[3] = {pc[0] - pa[0], pc[1] - pa[1], pc[2] - pa[2]};
                        float n[3] = {u[1] * v[2] - u[2] * v[1],
                                      u[2] * v[0] - u[0] * v[2],
                                      u[0] * v[1] - u[1] * v[0]};
                        float d = n[0] * ref[0] + n[1] * ref[1] + n[2] * ref[2];
                        if (d < 0.f) { int32_t tmp = b; b = c; c = tmp; }
                        tris.insert(tris.end(), {a, b, c});
                    };

                    if (ni == 1) {
                        emit(EV(inside[0], outside[0]),
                             EV(inside[0], outside[1]),
                             EV(inside[0], outside[2]));
                    } else if (ni == 3) {
                        emit(EV(inside[0], outside[0]),
                             EV(inside[1], outside[0]),
                             EV(inside[2], outside[0]));
                    } else {  // 2-2: quad split into two triangles
                        int32_t q0 = EV(inside[0], outside[0]);
                        int32_t q1 = EV(inside[0], outside[1]);
                        int32_t q2 = EV(inside[1], outside[1]);
                        int32_t q3 = EV(inside[1], outside[0]);
                        emit(q0, q1, q2);
                        emit(q0, q2, q3);
                    }
                }
            }
        }
    }

    *out_nverts = (int64_t)(verts.size() / 3);
    *out_ntris = (int64_t)(tris.size() / 3);
    *out_verts = (float*)malloc(verts.size() * sizeof(float));
    *out_tris = (int32_t*)malloc(tris.size() * sizeof(int32_t));
    memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
    memcpy(*out_tris, tris.data(), tris.size() * sizeof(int32_t));
    return 0;
}

void meshops_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Vertex normals (angle-weighted) + Gaussian curvature (angle defect)
// ---------------------------------------------------------------------------

static inline void vsub(const float* a, const float* b, float* o) {
    o[0] = a[0] - b[0]; o[1] = a[1] - b[1]; o[2] = a[2] - b[2];
}
static inline void vcross(const float* a, const float* b, float* o) {
    o[0] = a[1] * b[2] - a[2] * b[1];
    o[1] = a[2] * b[0] - a[0] * b[2];
    o[2] = a[0] * b[1] - a[1] * b[0];
}
static inline float vdot(const float* a, const float* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
static inline float vnorm(const float* a) { return sqrtf(vdot(a, a)); }

// normals: [nv,3] out; curvature: [nv] out (angle defect / mixed area)
int vertex_normals_curvature(const float* verts, int64_t nv,
                             const int32_t* tris, int64_t nt,
                             float* normals, float* curvature) {
    std::vector<float> angle_sum(nv, 0.f);
    std::vector<float> area_sum(nv, 0.f);
    memset(normals, 0, sizeof(float) * 3 * nv);

    for (int64_t f = 0; f < nt; f++) {
        int32_t i0 = tris[3 * f], i1 = tris[3 * f + 1], i2 = tris[3 * f + 2];
        const float *p0 = verts + 3 * i0, *p1 = verts + 3 * i1, *p2 = verts + 3 * i2;
        float e01[3], e02[3], e12[3], n[3];
        vsub(p1, p0, e01); vsub(p2, p0, e02); vsub(p2, p1, e12);
        vcross(e01, e02, n);
        float nlen = vnorm(n);
        if (nlen < 1e-20f) continue;
        float area = 0.5f * nlen;
        float inv = 1.f / nlen;
        float nn[3] = {n[0] * inv, n[1] * inv, n[2] * inv};

        float l01 = vnorm(e01), l02 = vnorm(e02), l12 = vnorm(e12);
        // corner angles
        float a0 = acosf(fminf(1.f, fmaxf(-1.f, vdot(e01, e02) / (l01 * l02))));
        float me01[3] = {-e01[0], -e01[1], -e01[2]};
        float a1 = acosf(fminf(1.f, fmaxf(-1.f, vdot(me01, e12) / (l01 * l12))));
        float a2 = 3.14159265358979f - a0 - a1;

        const int32_t idx[3] = {i0, i1, i2};
        const float ang[3] = {a0, a1, a2};
        for (int k = 0; k < 3; k++) {
            normals[3 * idx[k]] += nn[0] * ang[k];
            normals[3 * idx[k] + 1] += nn[1] * ang[k];
            normals[3 * idx[k] + 2] += nn[2] * ang[k];
            angle_sum[idx[k]] += ang[k];
            area_sum[idx[k]] += area / 3.f;
        }
    }
    for (int64_t v = 0; v < nv; v++) {
        float* n = normals + 3 * v;
        float l = vnorm(n);
        if (l > 1e-20f) { n[0] /= l; n[1] /= l; n[2] /= l; }
        float defect = 2.f * 3.14159265358979f - angle_sum[v];
        curvature[v] = area_sum[v] > 1e-12f ? defect / area_sum[v] : 0.f;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Vertex-clustering remesh (decimation to a uniform grid)
// ---------------------------------------------------------------------------

int cluster_remesh(const float* verts, int64_t nv, const int32_t* tris,
                   int64_t nt, float cell_size,
                   float** out_verts, int64_t* out_nverts,
                   int32_t** out_tris, int64_t* out_ntris) {
    std::unordered_map<uint64_t, int32_t> cell_map;
    std::vector<float> cverts;   // accumulated positions
    std::vector<int32_t> counts;
    std::vector<int32_t> vmap(nv);

    float origin[3] = {1e30f, 1e30f, 1e30f};
    for (int64_t v = 0; v < nv; v++)
        for (int k = 0; k < 3; k++)
            origin[k] = fminf(origin[k], verts[3 * v + k]);

    for (int64_t v = 0; v < nv; v++) {
        uint64_t cx = (uint64_t)((verts[3 * v] - origin[0]) / cell_size);
        uint64_t cy = (uint64_t)((verts[3 * v + 1] - origin[1]) / cell_size);
        uint64_t cz = (uint64_t)((verts[3 * v + 2] - origin[2]) / cell_size);
        uint64_t key = (cx << 42) | (cy << 21) | cz;
        auto it = cell_map.find(key);
        int32_t idx;
        if (it == cell_map.end()) {
            idx = (int32_t)(cverts.size() / 3);
            cell_map.emplace(key, idx);
            cverts.insert(cverts.end(), {0.f, 0.f, 0.f});
            counts.push_back(0);
        } else idx = it->second;
        vmap[v] = idx;
        for (int k = 0; k < 3; k++) cverts[3 * idx + k] += verts[3 * v + k];
        counts[idx]++;
    }
    for (size_t c = 0; c < counts.size(); c++)
        for (int k = 0; k < 3; k++) cverts[3 * c + k] /= (float)counts[c];

    std::vector<int32_t> ctris;
    ctris.reserve(nt * 3);
    for (int64_t f = 0; f < nt; f++) {
        int32_t a = vmap[tris[3 * f]], b = vmap[tris[3 * f + 1]],
                c = vmap[tris[3 * f + 2]];
        if (a == b || b == c || a == c) continue;  // degenerate
        ctris.insert(ctris.end(), {a, b, c});
    }

    *out_nverts = (int64_t)(cverts.size() / 3);
    *out_ntris = (int64_t)(ctris.size() / 3);
    *out_verts = (float*)malloc(cverts.size() * sizeof(float));
    *out_tris = (int32_t*)malloc(ctris.size() * sizeof(int32_t));
    memcpy(*out_verts, cverts.data(), cverts.size() * sizeof(float));
    memcpy(*out_tris, ctris.data(), ctris.size() * sizeof(int32_t));
    return 0;
}

// ---------------------------------------------------------------------------
// 4-wide BVH build (max-variance-axis median split) -> flat arrays
// ---------------------------------------------------------------------------
// Node layout (per node, 4 children):
//   child_bbox: [n_nodes, 4, 6]  (min xyz, max xyz; empty child = inf box)
//   child_idx:  [n_nodes, 4]     (>=0: node index; <0: -(leaf_start+1) with
//                                 leaf_count in child_leaf_count)
//   tri_order:  [nt]             triangle permutation (leaves are ranges)

struct BuildTri { float c[3]; float bmin[3]; float bmax[3]; int32_t idx; };

static void build_recursive(std::vector<BuildTri>& tris, int lo, int hi,
                            int leaf_size, std::vector<float>& bboxes,
                            std::vector<int32_t>& children,
                            std::vector<int32_t>& leaf_counts,
                            int& node_counter, int my_slot,
                            std::vector<int32_t>& order) {
    // split [lo,hi) into 4 ranges by two median splits
    int ranges[5] = {lo, 0, 0, 0, hi};
    auto split = [&](int a, int b) -> int {
        if (b - a <= 1) return a;
        // max-variance axis
        double mean[3] = {0, 0, 0}, var[3] = {0, 0, 0};
        for (int i = a; i < b; i++)
            for (int k = 0; k < 3; k++) mean[k] += tris[i].c[k];
        for (int k = 0; k < 3; k++) mean[k] /= (b - a);
        for (int i = a; i < b; i++)
            for (int k = 0; k < 3; k++) {
                double d = tris[i].c[k] - mean[k];
                var[k] += d * d;
            }
        int axis = 0;
        if (var[1] > var[axis]) axis = 1;
        if (var[2] > var[axis]) axis = 2;
        int mid = (a + b) / 2;
        std::nth_element(tris.begin() + a, tris.begin() + mid, tris.begin() + b,
                         [axis](const BuildTri& x, const BuildTri& y) {
                             return x.c[axis] < y.c[axis];
                         });
        return mid;
    };
    ranges[2] = split(lo, hi);
    ranges[1] = split(lo, ranges[2]);
    ranges[3] = split(ranges[2], hi);

    int my_node = node_counter++;
    bboxes.resize((size_t)node_counter * 24, 0.f);
    children.resize((size_t)node_counter * 4, 0);
    leaf_counts.resize((size_t)node_counter * 4, 0);
    if (my_slot >= 0) children[my_slot] = my_node;

    for (int c = 0; c < 4; c++) {
        int a = ranges[c], b = ranges[c + 1];
        float* bb = bboxes.data() + (size_t)my_node * 24 + c * 6;
        if (a >= b) {
            for (int k = 0; k < 3; k++) { bb[k] = 1e30f; bb[3 + k] = -1e30f; }
            children[(size_t)my_node * 4 + c] = INT32_MIN;  // empty
            continue;
        }
        float bmin[3] = {1e30f, 1e30f, 1e30f}, bmax[3] = {-1e30f, -1e30f, -1e30f};
        for (int i = a; i < b; i++)
            for (int k = 0; k < 3; k++) {
                bmin[k] = fminf(bmin[k], tris[i].bmin[k]);
                bmax[k] = fmaxf(bmax[k], tris[i].bmax[k]);
            }
        for (int k = 0; k < 3; k++) { bb[k] = bmin[k]; bb[3 + k] = bmax[k]; }

        if (b - a <= leaf_size) {
            children[(size_t)my_node * 4 + c] = -(a + 1);
            leaf_counts[(size_t)my_node * 4 + c] = b - a;
        } else {
            build_recursive(tris, a, b, leaf_size, bboxes, children,
                            leaf_counts, node_counter,
                            (int)((size_t)my_node * 4 + c), order);
        }
    }
    (void)order;
}

int bvh_build(const float* verts, int64_t nv, const int32_t* tris_in,
              int64_t nt, int leaf_size,
              float** out_bboxes, int32_t** out_children,
              int32_t** out_leaf_counts, int64_t* out_nnodes,
              int32_t** out_order) {
    (void)nv;
    std::vector<BuildTri> bt(nt);
    for (int64_t f = 0; f < nt; f++) {
        BuildTri& t = bt[f];
        t.idx = (int32_t)f;
        for (int k = 0; k < 3; k++) { t.bmin[k] = 1e30f; t.bmax[k] = -1e30f; t.c[k] = 0; }
        for (int v = 0; v < 3; v++) {
            const float* p = verts + 3 * tris_in[3 * f + v];
            for (int k = 0; k < 3; k++) {
                t.bmin[k] = fminf(t.bmin[k], p[k]);
                t.bmax[k] = fmaxf(t.bmax[k], p[k]);
                t.c[k] += p[k] / 3.f;
            }
        }
    }
    std::vector<float> bboxes;
    std::vector<int32_t> children, leaf_counts, order;
    int counter = 0;
    build_recursive(bt, 0, (int)nt, leaf_size, bboxes, children, leaf_counts,
                    counter, -1, order);

    *out_nnodes = counter;
    *out_bboxes = (float*)malloc(bboxes.size() * sizeof(float));
    memcpy(*out_bboxes, bboxes.data(), bboxes.size() * sizeof(float));
    *out_children = (int32_t*)malloc(children.size() * sizeof(int32_t));
    memcpy(*out_children, children.data(), children.size() * sizeof(int32_t));
    *out_leaf_counts = (int32_t*)malloc(leaf_counts.size() * sizeof(int32_t));
    memcpy(*out_leaf_counts, leaf_counts.data(), leaf_counts.size() * sizeof(int32_t));
    *out_order = (int32_t*)malloc(nt * sizeof(int32_t));
    for (int64_t f = 0; f < nt; f++) (*out_order)[f] = bt[f].idx;
    return 0;
}

}  // extern "C"
