// Fused chain-MLP kernels for Hopper (sm_90a): forward (K1) and backward (K2).
//
// Replaces the Pallas TPU kernels of nunerf_tpu/ops/fused_mlp.py:
//   K1  _fwd_kernel        (reached through _fwd_call / fused_chain_mlp)
//   K2  _make_bwd_kernel   (reached through _bwd_call, the custom VJP)
//
// Layer model, per layer l:   z = (h @ W_h + x0 @ W_x) * scale + b,  h = act(z)
// with act in {none, relu, softplus(beta=100)}.  Matmul operands are in the
// compute dtype (f32, or bf16 values held in f32 registers: a product of two
// bf16 values is exact in f32, so f32 FMAs give the same products as a bf16
// tensor-core MMA with f32 accumulation).  Hidden activations are rounded to
// the compute dtype after each layer, the last layer stays f32, rows >= n are
// masked - as the TPU kernel's _forward_tile does.
//
// Bound on the H100: operations.  The value-only SDF chain does 459,008 MACs
// a point and reads 39 floats and writes 1, so at 131,072 points it is ~120
// GFLOP against ~21 MB of I/O: ~0.12 ms at the bf16 tensor-core peak, ~1.8 ms
// at the 67 TFLOP/s f32 peak that these FMA loops can at best reach.
//
// Design.  The TPU kernel keeps whole activation stashes in 100 MiB of VMEM
// and walks a sequential grid.  A Hopper block has at most 227 KB of shared
// memory and blocks run in no order, so:
//   * K1: one block per 64-row tile; the current activation tile [64, <=256]
//     and x0 (for the skip) live in shared memory; weights stream from L2
//     (a 256x256 f32 layer is 256 KB, the whole chain < 3 MB, L2 is 50 MB).
//     Each thread owns a 16-row x 4-column register tile of the layer output
//     and runs a plain FMA loop: the weight value it loads is reused across
//     16 rows, the activation value is a shared-memory broadcast.
//   * K2: a 9-layer f32 stash is ~9 KB a row - too large for shared memory at
//     useful tile sizes - so the wrapper allocates a global scratch stash.
//     Pass 1 (the K1 loop) recomputes the forward into it; pass 2 walks the
//     layers downwards per tile (gz = g * act'(a), db per-tile partials, dx,
//     and the rounded gz into a second stash); pass 3 computes every dW as
//     per-split partials of H^T @ GZ over row ranges.  Nothing carries across
//     blocks: the partials are summed afterwards (the TPU 'partial' mode, not
//     its 'accum' mode).
// mma.sync / wgmma tensor-core tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAXL 16
#define TR 64    // rows per block (K1 and K2 pass 2)
#define NT 256   // threads per block
#define RPT 16   // output rows per thread   (TR / 4 thread rows)
#define CPT 4    // output columns per thread (64 thread columns)
#define MAXW 256 // widest hidden layer and input: a thread tile covers 64 * CPT
#define MAXOUT 512 // widest last layer

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SP100 = 2 };

struct Layer {
  int in, out;    // input and output widths
  int wh, wx;     // offsets of W_h [in,out] and W_x [E,out] in W (wx < 0: no skip)
  int wht, wxt;   // offsets of their transposes in WT
  int b;          // offset of the bias in the bias buffer
  int act;
  int stash;      // sum of the output widths of the layers before this one
  float scale;
};

struct Chain {
  int L, E, hw, gw, bsum, round_bf16;
  Layer l[MAXL];
};

__device__ __forceinline__ float round_c(float v, int rb) {
  return rb ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float act_f(int a, float z) {
  if (a == ACT_RELU) return fmaxf(z, 0.f);
  if (a == ACT_SP100) {
    // softplus(100 z) / 100 in the stable form max(t,0) + log1p(exp(-|t|))
    float t = 100.f * z;
    return (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)))) / 100.f;
  }
  return z;
}

// act'(z) recovered from the stored activation a = act(z)
__device__ __forceinline__ float dact_from_a(int a_kind, float a) {
  if (a_kind == ACT_RELU) return a > 0.f ? 1.f : 0.f;
  if (a_kind == ACT_SP100) return 1.f - expf(-100.f * a);
  return 1.f;
}

// acc[i][j] += sum_k A[r_i][k] * B[k][c_j],  r_i = ty + 4 i,  c_j = tx + 64 j,
// for the columns c_j < ncols.  A lives in shared memory (row stride lda), B
// in global memory (row stride ldb).  A warp shares ty, so its A reads are
// broadcasts; its B reads are 32 consecutive floats.
__device__ __forceinline__ void mm_tile(float (&acc)[RPT][CPT],
                                        const float* A, int lda,
                                        const float* __restrict__ B, int ldb,
                                        int K, int ncols, int tx, int ty) {
  const bool cv[CPT] = {tx < ncols, tx + 64 < ncols, tx + 128 < ncols,
                        tx + 192 < ncols};
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float* brow = B + (size_t)k * ldb + tx;
    float bv[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) bv[j] = cv[j] ? __ldg(brow + 64 * j) : 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = A[(ty + 4 * i) * lda + k];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[RPT][CPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
}

// K1.  out [n, d_L] f32; stash (optional) gets every layer's activation.
__global__ void __launch_bounds__(NT, 2)
chain_fwd_kernel(const float* __restrict__ x, const float* __restrict__ W,
                 const float* __restrict__ Bs, float* __restrict__ out,
                 float* __restrict__ stash, int n, Chain ch) {
  extern __shared__ float smem[];
  const int E = ch.E, HW = ch.hw, rb = ch.round_bf16;
  float* h = smem;             // [TR][HW]
  float* x0 = smem + TR * HW;  // [TR][E]
  const int t = threadIdx.x, tx = t & 63, ty = t >> 6;
  const long row0 = (long)blockIdx.x * TR;

  for (int idx = t; idx < TR * E; idx += NT) {
    const int r = idx / E, c = idx - r * E;
    const long g = row0 + r;
    x0[idx] = g < n ? round_c(x[g * E + c], rb) : 0.f;
  }
  __syncthreads();

  const float* hin = x0;
  int lda = E;
  float acc[RPT][CPT];
  for (int l = 0; l < ch.L - 1; ++l) {
    const Layer& Ly = ch.l[l];
    zero_acc(acc);
    mm_tile(acc, hin, lda, W + Ly.wh, Ly.out, Ly.in, Ly.out, tx, ty);
    if (Ly.wx >= 0) mm_tile(acc, x0, E, W + Ly.wx, Ly.out, E, Ly.out, tx, ty);
    __syncthreads();  // every read of h precedes its overwrite
    float* st = stash ? stash + (size_t)n * Ly.stash : nullptr;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 4 * i;
      const long g = row0 + r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 64 * j;
        if (c >= Ly.out) continue;
        float z = acc[i][j];
        if (Ly.scale != 1.f) z *= Ly.scale;
        const float a = round_c(act_f(Ly.act, z + Bs[Ly.b + c]), rb);
        h[r * HW + c] = a;
        if (st && g < n) st[g * Ly.out + c] = a;
      }
    }
    __syncthreads();
    hin = h;
    lda = HW;
  }
  // last layer: f32 output, MAXW columns at a time (it may be wider)
  const Layer& Ly = ch.l[ch.L - 1];
  float* st = stash ? stash + (size_t)n * Ly.stash : nullptr;
  for (int cb = 0; cb < Ly.out; cb += MAXW) {
    zero_acc(acc);
    mm_tile(acc, hin, lda, W + Ly.wh + cb, Ly.out, Ly.in, Ly.out - cb, tx, ty);
    if (Ly.wx >= 0)
      mm_tile(acc, x0, E, W + Ly.wx + cb, Ly.out, E, Ly.out - cb, tx, ty);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const long g = row0 + ty + 4 * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cb + tx + 64 * j;
        if (c >= Ly.out || g >= n) continue;
        float z = acc[i][j];
        if (Ly.scale != 1.f) z *= Ly.scale;
        const float a = act_f(Ly.act, z + Bs[Ly.b + c]);
        out[g * Ly.out + c] = a;
        if (st) st[g * Ly.out + c] = a;
      }
    }
  }
}

// K2 pass 2.  Per 64-row tile, from the last layer down:
//   gz = g * act'(a_l);  db partial = column sums of gz;
//   gz = round(gz * scale) -> gzs stash;  dx += gz @ W_x^T (skip);
//   g = gz @ W_h^T (f32), or dx += it at layer 0.
// The transposed weights are the f32 originals, as the TPU kernel's are.
__global__ void __launch_bounds__(NT, 2)
chain_bwd_data_kernel(const float* __restrict__ stash,
                      const float* __restrict__ WT,
                      const float* __restrict__ gin, float* __restrict__ dx,
                      float* __restrict__ gzs, float* __restrict__ dbp, int n,
                      Chain ch) {
  extern __shared__ float smem[];
  const int E = ch.E, GW = ch.gw, rb = ch.round_bf16;
  float* gb = smem;             // [TR][GW]
  float* dxs = smem + TR * GW;  // [TR][E]
  const int t = threadIdx.x, tx = t & 63, ty = t >> 6;
  const long row0 = (long)blockIdx.x * TR;

  {
    const int wl = ch.l[ch.L - 1].out;
    for (int idx = t; idx < TR * wl; idx += NT) {
      const int r = idx / wl, c = idx - r * wl;
      const long g = row0 + r;
      gb[r * GW + c] = g < n ? gin[g * wl + c] : 0.f;
    }
    for (int idx = t; idx < TR * E; idx += NT) dxs[idx] = 0.f;
  }
  __syncthreads();

  float acc[RPT][CPT];
  for (int l = ch.L - 1; l >= 0; --l) {
    const Layer& Ly = ch.l[l];
    const int w = Ly.out;
    const float* a = stash + (size_t)n * Ly.stash;
    float* gz = gzs + (size_t)n * Ly.stash;
    for (int idx = t; idx < TR * w; idx += NT) {
      const int r = idx / w, c = idx - r * w;
      const long g = row0 + r;
      const float av = g < n ? a[g * w + c] : 0.f;
      gb[r * GW + c] *= dact_from_a(Ly.act, av);
    }
    __syncthreads();
    for (int c = t; c < w; c += NT) {
      float s = 0.f;
      for (int r = 0; r < TR; ++r) s += gb[r * GW + c];
      dbp[(size_t)blockIdx.x * ch.bsum + Ly.b + c] = s;
    }
    __syncthreads();
    for (int idx = t; idx < TR * w; idx += NT) {
      const int r = idx / w, c = idx - r * w;
      const long g = row0 + r;
      float v = gb[r * GW + c];
      if (Ly.scale != 1.f) v *= Ly.scale;
      v = round_c(v, rb);
      gb[r * GW + c] = v;
      if (g < n) gz[g * w + c] = v;
    }
    __syncthreads();
    if (Ly.wx >= 0) {
      zero_acc(acc);
      mm_tile(acc, gb, GW, WT + Ly.wxt, E, w, E, tx, ty);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = tx + 64 * j;
          if (c < E) dxs[(ty + 4 * i) * E + c] += acc[i][j];
        }
    }
    zero_acc(acc);
    mm_tile(acc, gb, GW, WT + Ly.wht, Ly.in, w, Ly.in, tx, ty);
    __syncthreads();  // every read of gb precedes its overwrite
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = ty + 4 * i, c = tx + 64 * j;
        if (c >= Ly.in) continue;
        if (l > 0) gb[r * GW + c] = acc[i][j];
        else dxs[r * E + c] += acc[i][j];
      }
    __syncthreads();
  }
  for (int idx = t; idx < TR * E; idx += NT) {
    const int r = idx / E, c = idx - r * E;
    const long g = row0 + r;
    if (g < n) dx[g * E + c] = dxs[idx];
  }
}

// K2 pass 3.  part[s][i][c] = sum over rows of split s of H[row][i] * GZ[row][c]
// for a 64x64 (i, c) tile per block; each thread owns 4x4 outputs.
__global__ void __launch_bounds__(NT)
chain_dw_kernel(const float* __restrict__ H, const float* __restrict__ GZ,
                float* __restrict__ part, int n, int in, int w,
                int rows_per_split) {
  __shared__ float hs[32][64];
  __shared__ float gs[32][64];
  const int t = threadIdx.x, ti = t >> 4, tc = t & 15;
  const int i0 = blockIdx.x * 64, c0 = blockIdx.y * 64;
  const long r_begin = (long)blockIdx.z * rows_per_split;
  long r_end = r_begin + rows_per_split;
  if (r_end > n) r_end = n;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (long r0 = r_begin; r0 < r_end; r0 += 32) {
    for (int idx = t; idx < 32 * 64; idx += NT) {
      const int rr = idx >> 6, cc = idx & 63;
      const long r = r0 + rr;
      const bool rv = r < r_end;
      hs[rr][cc] = (rv && i0 + cc < in) ? H[r * in + i0 + cc] : 0.f;
      gs[rr][cc] = (rv && c0 + cc < w) ? GZ[r * w + c0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < 32; ++rr) {
      float hv[4], gv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) hv[a] = hs[rr][ti + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) gv[b] = gs[rr][tc + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(hv[a], gv[b], acc[a][b]);
    }
    __syncthreads();
  }
  float* p = part + (size_t)blockIdx.z * in * w;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + ti + 16 * a, c = c0 + tc + 16 * b;
      if (i < in && c < w) p[(size_t)i * w + c] = acc[a][b];
    }
}

// ---------------------------------------------------------------- C interface
// meta: 9 ints per layer (in, out, wh, wx, wht, wxt, b, act, stash);
// scales: one float per layer.  Every function returns a cudaError_t.

static int build_chain(Chain* ch, const int* meta, const float* scales, int L,
                       int E, int round_bf16) {
  if (L < 1 || L > MAXL || E < 1 || E > MAXW) return (int)cudaErrorInvalidValue;
  ch->L = L;
  ch->E = E;
  ch->round_bf16 = round_bf16;
  ch->hw = 1;
  ch->gw = 1;
  ch->bsum = 0;
  for (int l = 0; l < L; ++l) {
    const int* m = meta + 9 * l;
    Layer& y = ch->l[l];
    y.in = m[0]; y.out = m[1]; y.wh = m[2]; y.wx = m[3]; y.wht = m[4];
    y.wxt = m[5]; y.b = m[6]; y.act = m[7]; y.stash = m[8];
    y.scale = scales[l];
    if (y.in < 1 || y.in > MAXW || y.out < 1 ||
        y.out > (l == L - 1 ? MAXOUT : MAXW))
      return (int)cudaErrorInvalidValue;
    if (l < L - 1 && y.out > ch->hw) ch->hw = y.out;
    if (y.out > ch->gw) ch->gw = y.out;
    ch->bsum += y.out;
  }
  return 0;
}

static int launch_check() { return (int)cudaGetLastError(); }

extern "C" int nunerf_chain_fwd(const float* x, const float* W,
                                const float* B, float* out, float* stash,
                                int n, const int* meta, const float* scales,
                                int L, int E, int round_bf16, void* stream) {
  Chain ch;
  int err = build_chain(&ch, meta, scales, L, E, round_bf16);
  if (err) return err;
  const size_t smem = (size_t)TR * (ch.hw + E) * sizeof(float);
  err = (int)cudaFuncSetAttribute(chain_fwd_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  const unsigned grid = (unsigned)((n + TR - 1) / TR);
  chain_fwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(x, W, B, out,
                                                             stash, n, ch);
  return launch_check();
}

extern "C" int nunerf_chain_bwd_data(const float* stash, const float* WT,
                                     const float* g, float* dx, float* gzs,
                                     float* dbp, int n, const int* meta,
                                     const float* scales, int L, int E,
                                     int round_bf16, void* stream) {
  Chain ch;
  int err = build_chain(&ch, meta, scales, L, E, round_bf16);
  if (err) return err;
  const size_t smem = (size_t)TR * (ch.gw + E) * sizeof(float);
  err = (int)cudaFuncSetAttribute(chain_bwd_data_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  const unsigned grid = (unsigned)((n + TR - 1) / TR);
  chain_bwd_data_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      stash, WT, g, dx, gzs, dbp, n, ch);
  return launch_check();
}

extern "C" int nunerf_chain_dw(const float* H, const float* GZ, float* part,
                               int n, int in, int w, int splits,
                               void* stream) {
  if (splits < 1 || in < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const int rps = (n + splits - 1) / splits;
  dim3 grid((in + 63) / 64, (w + 63) / 64, splits);
  chain_dw_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(H, GZ, part, n, in,
                                                          w, rps);
  return launch_check();
}

extern "C" const char* nunerf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
