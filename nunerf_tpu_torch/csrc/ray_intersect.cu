// Ray / triangle-soup closest hit for Hopper (sm_90a): K3.
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
// Bound on the H100: operations.  A pair costs 46 f32 operations and the
// triangles are 36 bytes each, read once: at 1024 rays x 117k triangles that
// is 5.5 GFLOP against 4 MB, 0.08 ms at the 67 TFLOP/s f32 peak and 0.001 ms
// at the HBM rate.  No tensor-core formulation applies (cross products and
// comparisons, not a matrix product).
//
// Design.  The TPU kernel holds [1024 rays x 256 triangles] planes in VMEM
// and revisits one output block along a sequential triangle axis.  Here:
//   * one thread per ray keeps the ray and its best (t, index) in registers
//     and walks triangles in index order with a strict '<', so the lowest
//     index wins a tie within its range;
//   * a training bounce has only 1024 rays, which alone would fill 8 blocks
//     of the card's 132 SMs, so the triangle list is also split across
//     blockIdx.y into chunks; a block stages its chunk through shared
//     memory in tiles of 256 triangles (9 KB) that every thread reads as
//     broadcasts;
//   * nothing carries across blocks, so chunks are merged with one 64-bit
//     atomicMin per ray on the packed key (bits of t << 32 | index): t is
//     positive, so its bit pattern orders as the float does, and the low
//     word breaks ties towards the lowest index.  A minimum does not depend
//     on the order of its operands, so the result is the same in every run
//     and for every chunk size;
//   * products and sums are written with __fmul_rn / __fadd_rn / __fsub_rn,
//     which the compiler never contracts into FMAs: t then carries the same
//     roundings as the plain PyTorch version (one rounding an operation), and
//     t and the index can be held to it exactly.  A contracted FMA changes t
//     in its last bits, enough to pick the neighbour across a shared edge.
// A bounding-volume hierarchy or a tile-culled sweep is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define MISS_T 1e7f
#define DET_EPS 1e-9f
#define T_MIN 1e-5f
#define RAYS_PER_BLOCK 128
#define TRI_TILE 256

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

// grid (ray blocks, triangle chunks); block RAYS_PER_BLOCK threads
__global__ void __launch_bounds__(RAYS_PER_BLOCK)
k3_closest_hit(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
               const float* __restrict__ v0, const float* __restrict__ e1,
               const float* __restrict__ e2, unsigned long long* __restrict__ best,
               int n_rays, int n_tris, int chunk) {
  __shared__ float s_v0[TRI_TILE * 3];
  __shared__ float s_e1[TRI_TILE * 3];
  __shared__ float s_e2[TRI_TILE * 3];

  const int r = blockIdx.x * RAYS_PER_BLOCK + threadIdx.x;
  const bool live = r < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  if (live) {
    ox = rays_o[3 * r + 0]; oy = rays_o[3 * r + 1]; oz = rays_o[3 * r + 2];
    dx = rays_d[3 * r + 0]; dy = rays_d[3 * r + 1]; dz = rays_d[3 * r + 2];
  }
  float best_t = MISS_T;
  int best_i = 0;

  const int c0 = blockIdx.y * chunk;
  const int c1 = min(c0 + chunk, n_tris);
  for (int base = c0; base < c1; base += TRI_TILE) {
    const int cnt = min(TRI_TILE, c1 - base);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt * 3; i += RAYS_PER_BLOCK) {
      s_v0[i] = v0[(size_t)base * 3 + i];
      s_e1[i] = e1[(size_t)base * 3 + i];
      s_e2[i] = e2[(size_t)base * 3 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
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
      if (valid && t < best_t) {
        best_t = t;
        best_i = base + j;
      }
    }
  }
  if (live && best_t < MISS_T) atomicMin(&best[r], pack(best_t, best_i));
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
// rays_o, rays_d [n_rays,3] f32; v0, e1, e2 [>= n_tris,3] f32; scratch
// [n_rays] 64-bit; t_out [n_rays] f32, idx_out [n_rays] i32, hit_out [n_rays]
// bytes (0/1).  Returns a cudaError_t.
extern "C" int nunerf_ray_closest_hit(const float* rays_o, const float* rays_d,
                                      const float* v0, const float* e1,
                                      const float* e2, unsigned long long* scratch,
                                      float* t_out, int* idx_out,
                                      unsigned char* hit_out, int n_rays,
                                      int n_tris, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ray_blocks = (n_rays + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK;
  // enough blocks for about eight a multiprocessor, chunks a tile multiple
  int n_chunks = (n_tris + TRI_TILE - 1) / TRI_TILE;
  const int want = (1056 + ray_blocks - 1) / ray_blocks;
  if (n_chunks > want) n_chunks = want;
  if (n_chunks < 1) n_chunks = 1;
  if (n_chunks > 65535) n_chunks = 65535;
  int chunk = (n_tris + n_chunks - 1) / n_chunks;
  chunk = (chunk + TRI_TILE - 1) / TRI_TILE * TRI_TILE;
  if (chunk < TRI_TILE) chunk = TRI_TILE;
  n_chunks = n_tris > 0 ? (n_tris + chunk - 1) / chunk : 1;

  const int fb = (n_rays + 255) / 256;
  k3_init<<<fb, 256, 0, s>>>(scratch, n_rays);
  k3_closest_hit<<<dim3(ray_blocks, n_chunks), RAYS_PER_BLOCK, 0, s>>>(
      rays_o, rays_d, v0, e1, e2, scratch, n_rays, n_tris, chunk);
  k3_finish<<<fb, 256, 0, s>>>(scratch, t_out, idx_out, hit_out, n_rays);
  return (int)cudaGetLastError();
}

extern "C" const char* nunerf_ray_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
