// Ray / triangle-soup closest hit for Hopper (sm_90a): K3, tile-culled.
//
// Replaces the Pallas TPU kernel of nunerf_tpu/ops/pallas_intersect.py:
//   K3  _mt_kernel   (reached through pallas_ray_mesh_intersect)
//
// What it computes.  For every ray the closest Möller–Trumbore hit over all
// triangles (given as v0, e1 = v1 - v0, e2 = v2 - v0): det eps 1e-9,
// inv_det = 0 where |det| <= eps, a hit needs u >= 0, v >= 0, u + v <= 1
// (no barycentric tolerance) and t > 1e-5, else t = MISS_T (1e7).  Ties on t
// go to the lowest triangle index, an all-miss ray keeps index 0, and
// hit = best_t < MISS_T / 2.  No backface culling: glass needs both sides.
//
// Bound on the H100: operations.  A ray-triangle pair costs 46 f32
// operations, a ray-box slab test 16.  The brute sweep (every ray against
// every triangle) is 5.5 GFLOP at 1024 rays x 117k triangles, 0.08 ms at the
// 67 TFLOP/s f32 peak; culled, the work is the box tests of every (ray, tile)
// pair plus the triangles of the tiles a ray's box test passes, a few
// hundredths of that.
//
// Design: bin, then sweep, over an index built once per mesh (the mesh is
// frozen for the whole of stage 2; CullIndex in ops/ray_intersect.py):
// triangles Morton-sorted by centroid into tiles of T (32-128), each tile's
// box inflated by a margin, the triangles' v0/e1/e2 gathered into tile order
// with their f32 bits, and each slot's original index.
//   * k3_bin: one thread a ray (its reciprocal direction formed once), a
//     block's rays against a range of tiles whose boxes it stages in shared
//     memory.  A ray whose slab test passes a tile
//     appends its index to the tile's list: the lanes of a warp that pass
//     the same tile take their slots with one atomicAdd (ballot + popc).
//     The lists are allocated for the worst case of a chunk of rays (every
//     ray in every list), so nothing is read back on the host.
//   * k3_sweep: a block a tile and a part of its list (up to 32 parts, so
//     that the tiles many rays cross, near the mesh's middle, do not hold
//     the launch back).  The tile's triangles go into shared memory and the
//     block's threads take rays of its list, each testing all T triangles
//     (read as broadcasts) and keeping its best (t, original index), ties to
//     the lower index.
//   * A ray's best over the tiles is merged by one 64-bit atomicMin a (ray,
//     tile) pair on the packed key (bits of t << 32 | original index): t is
//     positive, so its bit pattern orders as the float does, and the low word
//     breaks ties towards the lowest index.  A minimum does not depend on the
//     order of its operands, so the result is the same from run to run,
//     whatever order the lists fill in.
//   * Culling never drops a hit.  The slab test multiplies and subtracts in
//     f32 with a relative rounding of a few 2^-24 of the coordinates; the
//     boxes are inflated by CULL_MARGIN (1e-3) of the mesh's size, some 10^4
//     times that, which also covers the spatial error of a Möller–Trumbore
//     acceptance for a ray that grazes a triangle (|det| just above eps).  A
//     direction component |d| < 1e-20 takes no reciprocal (which could
//     overflow, and (lo - o) * inf is NaN on the slab plane): the ray then
//     passes the slab if lo <= o <= hi and misses it otherwise, since
//     reaching a box the margin away takes t > 1e-3 / 1e-20 > MISS_T, and no
//     such t is a hit.  Padding slots (v0 = 1e8, e1 = e2 = 0) have det = 0 and
//     are never hit.  tests/test_torch_port_k3_cull.py holds the candidate
//     lists to a superset of every pair the brute plain version accepts.
//   * Products and sums are written with __fmul_rn / __fadd_rn / __fsub_rn,
//     which the compiler never contracts into FMAs: t then carries the same
//     roundings as the plain PyTorch version (one rounding an operation), and
//     t and the index can be held to it exactly.  A contracted FMA changes t
//     in its last bits, enough to pick the neighbour across a shared edge.
//   * The kernels count, in stats[2] (64-bit), the (ray, tile) pairs whose
//     box test passes and the ray-triangle pairs swept, for the bound of the
//     culled work.

#include <cuda_runtime.h>
#include <stdint.h>

#define MISS_T 1e7f
#define DET_EPS 1e-9f
#define T_MIN 1e-5f
#define SMALL_D 1e-20f
#define RAYS_PER_BLOCK 128
#define TILES_PER_BIN 64  // tiles a bin block tests its rays against
#define MAX_TILE 128      // triangles a tile, at most
#define SWEEP_THREADS 128
#define MAX_PARTS 32      // blocks that may share a tile's list

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ unsigned long long pack(float t, int idx) {
  return ((unsigned long long)__float_as_uint(t) << 32) | (unsigned int)idx;
}

__global__ void k3_init(unsigned long long* __restrict__ best, int n_rays) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < n_rays) best[r] = pack(MISS_T, 0);
}

// one axis of the slab test: narrows [tn, tf], false when the ray misses;
// inv = 1 / d, or 0 where |d| < SMALL_D (then only lo <= o <= hi counts)
__device__ __forceinline__ bool slab(float o, float inv, bool small, float lo,
                                     float hi, float& tn, float& tf) {
  if (small) return lo <= o && o <= hi;
  const float t0 = mul(sub(lo, o), inv), t1 = mul(sub(hi, o), inv);
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  return true;
}

// grid (ray blocks, tile ranges of TILES_PER_BIN); box [n_tiles][6] = lo, hi;
// count [n_tiles] zeroed before; list [n_tiles][cap] of ray indices (0-based
// in the chunk)
__global__ void __launch_bounds__(RAYS_PER_BLOCK)
k3_bin(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
       int r0, int n_rays, const float* __restrict__ box, int n_tiles,
       int* __restrict__ count, int* __restrict__ list, int cap,
       unsigned long long* __restrict__ stats) {
  __shared__ float s_box[TILES_PER_BIN * 6];
  const int tb = blockIdx.y * TILES_PER_BIN;
  const int nb = min(TILES_PER_BIN, n_tiles - tb);
  for (int i = threadIdx.x; i < nb * 6; i += RAYS_PER_BLOCK)
    s_box[i] = box[(size_t)tb * 6 + i];
  __syncthreads();
  const int r = blockIdx.x * RAYS_PER_BLOCK + threadIdx.x;  // in the chunk
  const bool live = r < n_rays;
  float o[3] = {0.f, 0.f, 0.f}, inv[3] = {1.f, 1.f, 1.f};
  bool small[3] = {false, false, false};
  if (live) {
    const size_t g = (size_t)(r0 + r) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = rays_o[g + k];
      const float d = rays_d[g + k];
      small[k] = fabsf(d) < SMALL_D;
      inv[k] = small[k] ? 0.f : __fdiv_rn(1.0f, d);
    }
  }
  const int lane = threadIdx.x & 31;
  unsigned int passed = 0;
  for (int j = 0; j < nb; ++j) {
    const float* bx = s_box + 6 * j;
    float tn = 0.f, tf = __int_as_float(0x7f800000);  // [0, inf)
    bool ok = live;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      ok = ok && slab(o[k], inv[k], small[k], bx[k], bx[3 + k], tn, tf);
    ok = ok && tn <= tf;
    const unsigned int m = __ballot_sync(0xffffffffu, ok);
    if (!m) continue;
    const int leader = __ffs(m) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(count + tb + j, __popc(m));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (ok) list[(size_t)(tb + j) * cap + base + __popc(m & ((1u << lane) - 1u))] = r;
    if (lane == leader) passed += __popc(m);
  }
  if (passed) atomicAdd(stats, (unsigned long long)passed);
}

// grid (n_tiles, parts): block (tile, y) takes the entries y * SWEEP_THREADS
// + threadIdx.x + k * parts * SWEEP_THREADS of the tile's list, so that a
// tile many rays cross is shared by up to MAX_PARTS blocks; tv0/te1/te2
// [n_tiles * T][3] in tile order, orig [n_tiles * T]
__global__ void __launch_bounds__(SWEEP_THREADS)
k3_sweep(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
         int r0, const float* __restrict__ tv0, const float* __restrict__ te1,
         const float* __restrict__ te2, const int* __restrict__ orig, int T,
         const int* __restrict__ count, const int* __restrict__ list, int cap,
         unsigned long long* __restrict__ best,
         unsigned long long* __restrict__ stats) {
  __shared__ float s_v0[MAX_TILE * 3];
  __shared__ float s_e1[MAX_TILE * 3];
  __shared__ float s_e2[MAX_TILE * 3];
  __shared__ int s_id[MAX_TILE];
  const int tile = blockIdx.x, part = blockIdx.y, stride = gridDim.y * SWEEP_THREADS;
  const int cnt = count[tile];
  if (cnt <= part * SWEEP_THREADS) return;  // block-uniform: nothing for this part
  const size_t s0 = (size_t)tile * T;
  for (int i = threadIdx.x; i < T * 3; i += SWEEP_THREADS) {
    s_v0[i] = tv0[s0 * 3 + i];
    s_e1[i] = te1[s0 * 3 + i];
    s_e2[i] = te2[s0 * 3 + i];
  }
  for (int i = threadIdx.x; i < T; i += SWEEP_THREADS) s_id[i] = orig[s0 + i];
  if (threadIdx.x == 0 && part == 0)
    atomicAdd(stats + 1, (unsigned long long)cnt * T);
  __syncthreads();
  const int* lst = list + (size_t)tile * cap;
  for (int i = part * SWEEP_THREADS + threadIdx.x; i < cnt; i += stride) {
    const size_t g = (size_t)(r0 + lst[i]);
    const float ox = rays_o[3 * g], oy = rays_o[3 * g + 1], oz = rays_o[3 * g + 2];
    const float dx = rays_d[3 * g], dy = rays_d[3 * g + 1], dz = rays_d[3 * g + 2];
    float best_t = MISS_T;
    int best_i = 0;
    for (int j = 0; j < T; ++j) {
      const float v0x = s_v0[3 * j], v0y = s_v0[3 * j + 1], v0z = s_v0[3 * j + 2];
      const float e1x = s_e1[3 * j], e1y = s_e1[3 * j + 1], e1z = s_e1[3 * j + 2];
      const float e2x = s_e2[3 * j], e2y = s_e2[3 * j + 1], e2z = s_e2[3 * j + 2];
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
      const float t = mul(add(add(mul(qvx, e2x), mul(qvy, e2y)), mul(qvz, e2z)), inv_det);
      const bool valid = ok && (u >= 0.0f) && (v >= 0.0f) && (add(u, v) <= 1.0f)
                         && (t > T_MIN);
      // tile order is not index order: an equal t goes to the lower index
      if (valid && (t < best_t || (t == best_t && s_id[j] < best_i))) {
        best_t = t;
        best_i = s_id[j];
      }
    }
    if (best_t < MISS_T) atomicMin(best + g, pack(best_t, best_i));
  }
}

__global__ void k3_finish(const unsigned long long* __restrict__ best,
                          float* __restrict__ t_out, int* __restrict__ idx_out,
                          unsigned char* __restrict__ hit_out, int n_rays) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const unsigned long long b = best[r];
  const float t = __uint_as_float((unsigned int)(b >> 32));
  t_out[r] = t;
  idx_out[r] = (int)(unsigned int)(b & 0xffffffffull);
  hit_out[r] = t < MISS_T * 0.5f ? 1 : 0;
}

// ---------------------------------------------------------------- C interface
// rays_o, rays_d [n_rays,3] f32; the index: tv0, te1, te2 [n_tiles * T, 3]
// f32, orig [n_tiles * T] i32, box [n_tiles, 6] f32; count [n_tiles] i32 and
// list [n_tiles * cap] i32 scratch (cap >= 1: rays a chunk); best [n_rays]
// 64-bit scratch; stats [2] 64-bit, added to; t_out [n_rays] f32, idx_out
// [n_rays] i32, hit_out [n_rays] bytes (0/1).  Rays go through in chunks of
// cap, every launch on the stream, nothing read back.  Returns a cudaError_t.
extern "C" int nunerf_ray_closest_hit(
    const float* rays_o, const float* rays_d, const float* tv0,
    const float* te1, const float* te2, const int* orig, const float* box,
    int n_tiles, int T, int* count, int* list, int cap,
    unsigned long long* best, unsigned long long* stats, float* t_out,
    int* idx_out, unsigned char* hit_out, int n_rays, void* stream) {
  if (n_rays < 0 || n_tiles < 0 || T < 1 || T > MAX_TILE || cap < 1 ||
      n_tiles > 65535 * TILES_PER_BIN)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int fb = (n_rays + 255) / 256;
  k3_init<<<fb, 256, 0, s>>>(best, n_rays);
  if (n_tiles > 0) {
    for (int r0 = 0; r0 < n_rays; r0 += cap) {
      const int nr = n_rays - r0 < cap ? n_rays - r0 : cap;
      cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int) * n_tiles, s);
      if (e != cudaSuccess) return (int)e;
      const dim3 bins((nr + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK,
                      (n_tiles + TILES_PER_BIN - 1) / TILES_PER_BIN);
      k3_bin<<<bins, RAYS_PER_BLOCK, 0, s>>>(rays_o, rays_d, r0, nr, box,
                                              n_tiles, count, list, cap, stats);
      int parts = (nr + SWEEP_THREADS - 1) / SWEEP_THREADS;
      if (parts > MAX_PARTS) parts = MAX_PARTS;
      k3_sweep<<<dim3(n_tiles, parts), SWEEP_THREADS, 0, s>>>(
          rays_o, rays_d, r0, tv0, te1, te2, orig, T, count, list, cap, best,
          stats);
    }
  }
  k3_finish<<<fb, 256, 0, s>>>(best, t_out, idx_out, hit_out, n_rays);
  return (int)cudaGetLastError();
}

// The bin pass alone, over all rays as one chunk (cap = n_rays): count and
// list as above, for reading the kernel's candidate lists back.
extern "C" int nunerf_ray_cull_bin(const float* rays_o, const float* rays_d,
                                   const float* box, int n_tiles, int* count,
                                   int* list, unsigned long long* stats,
                                   int n_rays, void* stream) {
  if (n_rays < 0 || n_tiles < 0 || n_tiles > 65535 * TILES_PER_BIN)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0 || n_tiles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int) * n_tiles, s);
  if (e != cudaSuccess) return (int)e;
  const dim3 bins((n_rays + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK,
                  (n_tiles + TILES_PER_BIN - 1) / TILES_PER_BIN);
  k3_bin<<<bins, RAYS_PER_BLOCK, 0, s>>>(rays_o, rays_d, 0, n_rays, box,
                                          n_tiles, count, list, n_rays, stats);
  return (int)cudaGetLastError();
}

extern "C" const char* nunerf_ray_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
