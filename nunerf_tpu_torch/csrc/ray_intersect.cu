// Ray / triangle-soup closest hit for Hopper (sm_90a): K3, a warp a ray over
// a two-level box index.
//
// Replaces the Pallas TPU kernel of nunerf_tpu/ops/pallas_intersect.py:
//   K3  _mt_kernel   (reached through pallas_ray_mesh_intersect)
//
// What it computes.  For every ray the closest Möller–Trumbore hit over all
// triangles (given as v0, e1 = v1 - v0, e2 = v2 - v0): det eps 1e-9,
// inv_det = 0 where |det| <= eps, a hit needs u >= lo, v >= lo, u + v <= hi
// and t > 1e-5, else t = MISS_T (1e7).  (lo, hi) is the mode: (0, 1) is the
// exact mode of the Pallas kernel, which has no barycentric tolerance;
// (-1e-6, 1 + 1e-6), as f32 (-9.99999997e-7, 1.00000095), is the tolerance of
// the port's brute sweep and of the JAX package's default closest hit
// (nunerf_tpu/tracing/intersect.py), which keeps a ray through a shared edge
// or vertex from missing every adjacent triangle.  The wrapper forms both
// constants as the plain version rounds them (bary_bounds).  Ties on t
// go to the lowest triangle index, an all-miss ray keeps index 0, and
// hit = best_t < MISS_T / 2.  No backface culling: glass needs both sides.
//
// Bound on the H100: operations.  A ray-triangle pair costs 46 f32
// operations, a ray-box slab test 16.  The brute sweep (every ray against
// every triangle) is 5.5 GFLOP at 1024 rays x 117k triangles, 0.08 ms at the
// 67 TFLOP/s f32 peak.  Over the index the work is the box tests of every
// (ray, group) pair, the tile boxes of the groups that pass, and the
// triangles of the tiles that pass: at 65,536 rays x 1.1 M triangles about a
// tenth of the flat box work (every ray against every tile's box).
//
// The index (CullIndex in ops/ray_intersect.py), built once per mesh (the
// mesh is frozen for the whole of stage 2 and for a tool's run): triangles
// Morton-sorted by centroid into tiles of T (1-128, 64 by default), each
// tile's box inflated by a margin, the triangles' v0/e1/e2 gathered into tile
// order with their f32 bits, and each slot's original index; then groups of
// G (1-32, 32 by default) consecutive tiles, each group's box the least and
// largest corner of its tiles' inflated boxes.
//
// Design: one kernel a call, one warp a ray, nothing but the answer written.
//   * The lanes take 32 group boxes at a time and run the slab test;
//     __ballot_sync gives the groups that pass.  For each of them, in order,
//     lane i tests the group's tile i; for each tile that passes, each lane
//     tests every 32nd of its T triangles and keeps its own best (t,
//     original index).  All branching is on ballots, so it is the same for
//     the warp's lanes.
//   * A lane's best is the packed key bits(t) << 32 | original index: t of a
//     hit is positive, so its bit pattern orders as the float does, and the
//     low word breaks ties towards the lowest index.  One butterfly of
//     minima over the warp gives the ray's answer, which lane 0 writes.  A
//     minimum does not depend on the order of its operands and no atomic
//     decides it: the answer is the same from run to run.
//   * No scratch: a call is one launch whatever the number of rays and
//     tiles, and reads nothing back on the host.
//   * The two levels find exactly the tiles of the flat test.  A group's box
//     holds each of its tiles' boxes (the least and largest of f32 values,
//     exact), and the slab test is monotone in the box: (lo - o) rounds to a
//     value no larger for a lower lo, multiplying by the same inv keeps or
//     reverses the order as inv's sign says, so the group's [tn, tf] holds
//     the tile's, and a tile that passes lies in a group that passes.
//   * Culling never drops a hit.  The slab test multiplies and subtracts in
//     f32 with a relative rounding of a few 2^-24 of the coordinates; the
//     boxes are inflated by CULL_MARGIN (1e-3) of the mesh's size, some 10^4
//     times that, which also covers the spatial error of a Möller–Trumbore
//     acceptance for a ray that grazes a triangle (|det| just above eps),
//     and the tolerant mode's widening of a triangle by 1e-6 of its edges.  A
//     direction component |d| < 1e-20 takes no reciprocal (which could
//     overflow, and (lo - o) * inf is NaN on the slab plane): the ray then
//     passes the slab if lo <= o <= hi and misses it otherwise, since
//     reaching a box the margin away takes t > 1e-3 / 1e-20 > MISS_T, and no
//     such t is a hit.  Padding slots (v0 = 1e8, e1 = e2 = 0) have det = 0 and
//     are never hit.  tests/test_torch_port_k3_cull.py and
//     tests/test_torch_port_k3_tol.py hold the candidates to a superset of
//     every pair the brute plain version accepts, in each mode, and the
//     two-level candidates to the flat ones.
//   * Products and sums are written with __fmul_rn / __fadd_rn / __fsub_rn,
//     which the compiler never contracts into FMAs: t then carries the same
//     roundings as the plain PyTorch version (one rounding an operation), and
//     t and the index can be held to it exactly.  A contracted FMA changes t
//     in its last bits, enough to pick the neighbour across a shared edge.
//   * Given stats[2] (64-bit), a warp adds the (ray, tile) pairs whose box
//     test passed and the ray-triangle pairs swept, for the bound of the
//     culled work: one atomicAdd each a warp.

#include <cuda_runtime.h>
#include <stdint.h>

#define MISS_T 1e7f
#define DET_EPS 1e-9f
#define T_MIN 1e-5f
#define SMALL_D 1e-20f
#define WARPS 4           // rays a block of the closest hit
#define MAX_TILE 128      // triangles a tile, at most
#define MAX_GROUP 32      // tiles a group, at most: one lane each
#define FULL 0xffffffffu

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ unsigned long long pack(float t, int idx) {
  return ((unsigned long long)__float_as_uint(t) << 32) | (unsigned int)idx;
}

struct Ray {
  float o[3], d[3], inv[3];  // inv = 1 / d, or 0 where |d| < SMALL_D
  bool small[3];
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays_o,
                                        const float* __restrict__ rays_d, int r) {
  Ray ray;
  const size_t g = (size_t)r * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ray.o[k] = rays_o[g + k];
    ray.d[k] = rays_d[g + k];
    ray.small[k] = fabsf(ray.d[k]) < SMALL_D;
    ray.inv[k] = ray.small[k] ? 0.f : __fdiv_rn(1.0f, ray.d[k]);
  }
  return ray;
}

// one axis of the slab test: narrows [tn, tf], false when the ray misses;
// a small component passes only where lo <= o <= hi
__device__ __forceinline__ bool slab(float o, float inv, bool small, float lo,
                                     float hi, float& tn, float& tf) {
  if (small) return lo <= o && o <= hi;
  const float t0 = mul(sub(lo, o), inv), t1 = mul(sub(hi, o), inv);
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  return true;
}

// the slab test of the ray against the box bx = lo (x, y, z), hi (x, y, z),
// read as three 8-byte loads (a row of 6 floats is 8-byte aligned)
__device__ __forceinline__ bool box_test(const Ray& ray, const float* __restrict__ bx) {
  const float2 a = __ldg(reinterpret_cast<const float2*>(bx));
  const float2 b = __ldg(reinterpret_cast<const float2*>(bx) + 1);
  const float2 c = __ldg(reinterpret_cast<const float2*>(bx) + 2);
  const float lo[3] = {a.x, a.y, b.x}, hi[3] = {b.y, c.x, c.y};
  float tn = 0.f, tf = __int_as_float(0x7f800000);  // [0, inf)
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    ok = ok && slab(ray.o[k], ray.inv[k], ray.small[k], lo[k], hi[k], tn, tf);
  return ok && tn <= tf;
}

// Calls f(tile) for every tile whose box test passes, in increasing order,
// on every lane of the warp (the ray is the warp's): groups 32 at a time,
// then the tiles of each group that passes, one a lane.
template <class F>
__device__ __forceinline__ void for_each_tile(const Ray& ray, const float* __restrict__ box,
                                              int n_tiles, const float* __restrict__ gbox,
                                              int G, int lane, F&& f) {
  const int n_groups = (n_tiles + G - 1) / G;
  for (int g0 = 0; g0 < n_groups; g0 += 32) {
    const int g = g0 + lane;
    unsigned int gm = __ballot_sync(FULL, g < n_groups && box_test(ray, gbox + (size_t)g * 6));
    while (gm) {
      const int t0 = (g0 + __ffs(gm) - 1) * G;
      gm &= gm - 1;
      const int tile = t0 + lane;
      unsigned int tm = __ballot_sync(
          FULL, lane < G && tile < n_tiles && box_test(ray, box + (size_t)tile * 6));
      while (tm) {
        f(t0 + __ffs(tm) - 1);
        tm &= tm - 1;
      }
    }
  }
}

// Möller–Trumbore of the ray against the triangle at slot s, in the plain
// version's order of operations; true with t where it is a hit
__device__ __forceinline__ bool mt(const Ray& ray, const float* __restrict__ tv0,
                                   const float* __restrict__ te1,
                                   const float* __restrict__ te2, size_t s, float lo,
                                   float hi, float& t) {
  const float ox = ray.o[0], oy = ray.o[1], oz = ray.o[2];
  const float dx = ray.d[0], dy = ray.d[1], dz = ray.d[2];
  const float v0x = tv0[3 * s], v0y = tv0[3 * s + 1], v0z = tv0[3 * s + 2];
  const float e1x = te1[3 * s], e1y = te1[3 * s + 1], e1z = te1[3 * s + 2];
  const float e2x = te2[3 * s], e2y = te2[3 * s + 1], e2z = te2[3 * s + 2];
  // pvec = d x e2
  const float pvx = sub(mul(dy, e2z), mul(dz, e2y));
  const float pvy = sub(mul(dz, e2x), mul(dx, e2z));
  const float pvz = sub(mul(dx, e2y), mul(dy, e2x));
  const float det = add(add(mul(pvx, e1x), mul(pvy, e1y)), mul(pvz, e1z));
  const bool ok = fabsf(det) > DET_EPS;
  const float inv_det = ok ? __fdiv_rn(1.0f, det) : 0.0f;
  // tvec = o - v0
  const float tvx = sub(ox, v0x), tvy = sub(oy, v0y), tvz = sub(oz, v0z);
  const float u = mul(add(add(mul(tvx, pvx), mul(tvy, pvy)), mul(tvz, pvz)), inv_det);
  // qvec = tvec x e1
  const float qvx = sub(mul(tvy, e1z), mul(tvz, e1y));
  const float qvy = sub(mul(tvz, e1x), mul(tvx, e1z));
  const float qvz = sub(mul(tvx, e1y), mul(tvy, e1x));
  const float v = mul(add(add(mul(qvx, dx), mul(qvy, dy)), mul(qvz, dz)), inv_det);
  t = mul(add(add(mul(qvx, e2x), mul(qvy, e2y)), mul(qvz, e2z)), inv_det);
  return ok && (u >= lo) && (v >= lo) && (add(u, v) <= hi) && (t > T_MIN);
}

// a warp a ray; tv0/te1/te2 [n_tiles * T][3] in tile order, orig [n_tiles *
// T], box [n_tiles][6], gbox [ceil(n_tiles / G)][6]; stats may be null
__global__ void __launch_bounds__(32 * WARPS)
k3_closest_hit(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
               int n_rays, const float* __restrict__ tv0, const float* __restrict__ te1,
               const float* __restrict__ te2, const int* __restrict__ orig, int T,
               const float* __restrict__ box, const float* __restrict__ gbox,
               int n_tiles, int G, float lo, float hi, float* __restrict__ t_out,
               int* __restrict__ idx_out, unsigned char* __restrict__ hit_out,
               unsigned long long* __restrict__ stats) {
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // warp-uniform: the ray is the warp's
  const int lane = threadIdx.x & 31;
  const Ray ray = load_ray(rays_o, rays_d, r);
  unsigned long long best = pack(MISS_T, 0);
  unsigned int tiles = 0;
  for_each_tile(ray, box, n_tiles, gbox, G, lane, [&](int tile) {
    ++tiles;
    const size_t s0 = (size_t)tile * T;
    for (int j = lane; j < T; j += 32) {
      float t;
      if (mt(ray, tv0, te1, te2, s0 + j, lo, hi, t)) {
        const unsigned long long key = pack(t, orig[s0 + j]);
        best = key < best ? key : best;
      }
    }
  });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(FULL, best, off);
    best = other < best ? other : best;
  }
  if (lane == 0) {
    const float t = __uint_as_float((unsigned int)(best >> 32));
    t_out[r] = t;
    idx_out[r] = (int)(unsigned int)(best & 0xffffffffull);
    hit_out[r] = t < MISS_T * 0.5f ? 1 : 0;
    if (stats && tiles) {
      atomicAdd(stats, (unsigned long long)tiles);
      atomicAdd(stats + 1, (unsigned long long)tiles * T);
    }
  }
}

// the candidates alone: cand [n_rays][n_tiles] (zeroed before) gets 1 where
// the ray's box test passes the tile, by the closest hit's own walk
__global__ void __launch_bounds__(32 * WARPS)
k3_candidates(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
              int n_rays, const float* __restrict__ box, const float* __restrict__ gbox,
              int n_tiles, int G, unsigned char* __restrict__ cand) {
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n_rays) return;
  const int lane = threadIdx.x & 31;
  const Ray ray = load_ray(rays_o, rays_d, r);
  unsigned char* row = cand + (size_t)r * n_tiles;
  for_each_tile(ray, box, n_tiles, gbox, G, lane, [&](int tile) {
    if (lane == 0) row[tile] = 1;
  });
}

static bool bad_shape(int n_rays, int n_tiles, int G) {
  return n_rays < 0 || n_tiles < 0 || G < 1 || G > MAX_GROUP;
}

// ---------------------------------------------------------------- C interface
// rays_o, rays_d [n_rays,3] f32; the index: tv0, te1, te2 [n_tiles * T, 3]
// f32, orig [n_tiles * T] i32, box [n_tiles, 6] f32, gbox [ceil(n_tiles / G),
// 6] f32 (8-byte aligned); stats [2] 64-bit, added to, or null; t_out
// [n_rays] f32, idx_out [n_rays] i32, hit_out [n_rays] bytes (0/1); lo, hi
// the barycentric bounds of the mode.  One launch on the stream, nothing
// read back.  Returns a cudaError_t.
extern "C" int nunerf_ray_closest_hit(
    const float* rays_o, const float* rays_d, const float* tv0, const float* te1,
    const float* te2, const int* orig, const float* box, const float* gbox,
    int n_tiles, int T, int G, unsigned long long* stats, float* t_out,
    int* idx_out, unsigned char* hit_out, int n_rays, float lo, float hi,
    void* stream) {
  if (bad_shape(n_rays, n_tiles, G) || T < 1 || T > MAX_TILE)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int blocks = (n_rays + WARPS - 1) / WARPS;
  k3_closest_hit<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      rays_o, rays_d, n_rays, tv0, te1, te2, orig, T, box, gbox, n_tiles, G, lo, hi,
      t_out, idx_out, hit_out, stats);
  return (int)cudaGetLastError();
}

// The candidates of the same walk: cand [n_rays, n_tiles] bytes, zeroed by
// the caller, for reading the kernel's culling back.
extern "C" int nunerf_ray_cull_candidates(const float* rays_o, const float* rays_d,
                                          const float* box, const float* gbox,
                                          int n_tiles, int G, unsigned char* cand,
                                          int n_rays, void* stream) {
  if (bad_shape(n_rays, n_tiles, G)) return (int)cudaErrorInvalidValue;
  if (n_rays == 0 || n_tiles == 0) return 0;
  const int blocks = (n_rays + WARPS - 1) / WARPS;
  k3_candidates<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      rays_o, rays_d, n_rays, box, gbox, n_tiles, G, cand);
  return (int)cudaGetLastError();
}

extern "C" const char* nunerf_ray_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
