// Fused chain-MLP kernels for Hopper (sm_90a): forward (K1), backward (K2),
// and the value+Jacobian pair (K4 forward, K5 backward).
//
// Replaces the Pallas TPU kernels of nunerf_tpu/ops/fused_mlp.py:
//   K1  _fwd_kernel           (reached through _fwd_call / fused_chain_mlp)
//   K2  _make_bwd_kernel      (reached through _bwd_call, the custom VJP)
//   K4  _jac_fwd_kernel       (_jac_fwd_call / chain_mlp_with_grad0)
//   K5  _make_jac_bwd_kernel  (_jac_bwd_call, its custom VJP)
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
//   * K4: y = chain(x) and j = d y[:,0] / dx.  Pass 1 is the K1 loop into the
//     scratch stash (it also writes y); pass 2 (chain_jac_down_kernel) walks
//     the layers down per tile with the channel-0 cotangent q in shared
//     memory: p = round(q * act'(a)), q <- s p W_h^T, j += s p W_x^T.
//   * K5: from (gy, gj), the reverse of both sweeps.  Passes 1 and 2 as K4,
//     pass 2 also storing every q.  Pass 3 (chain_jac_up_kernel) reverses the
//     J-pass upwards per tile: pbar = s qbar W_h (+ s gj W_x), dbar = pbar q,
//     qbar <- pbar act'; it overwrites the q stash with p and stores dbar and
//     the rounded qbar.  Pass 4 is K2's pass 2 with
//     zbar = hbar act' + dbar act'' (act'' of softplus100 = 100 d (1 - d)),
//     writing the rounded zs over dbar.  Every dW is then an A^T B over row
//     splits (chain_dw_kernel): h_prev^T zs and s qbar^T p.
//     Bound: operations, 2x (K4) and 6x (K5) the forward's MACs.
// mma.sync / wgmma tensor-core tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAXL 16
#define TR 64    // rows per block (K1 and K2 pass 2)
#define NT 256   // threads per block
#define RPT 16   // output rows per thread   (TR / 4 thread rows)
#define CPT 4    // output columns per thread (64 thread columns)
#define MAXW 256 // widest hidden layer: a thread tile covers 64 * CPT columns
#define MAXE 512 // widest input (only layer 0's depth, and dx in column passes)
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
  int x0_alias;   // no layer past the first reads x0: K1 keeps it in h's storage
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

// act''(z) from d = act'(z): softplus100 has 100 d (1 - d), relu and none 0
__device__ __forceinline__ float d2act_from_d(int a_kind, float d) {
  return a_kind == ACT_SP100 ? 100.f * d * (1.f - d) : 0.f;
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
// Shared memory: TR * (HW + E) floats, or TR * max(HW, E) when x0 is read by
// the first layer only (x0_alias: every read of x0 precedes the first write
// of h).  A 259-wide input of a skip-free head then takes 66 KB a block and
// two blocks still share an SM; a chain with both a later skip and an input
// wider than about 190 runs one block an SM (__launch_bounds__ only caps the
// registers at what two blocks would need).
__global__ void __launch_bounds__(NT, 2)
chain_fwd_kernel(const float* __restrict__ x, const float* __restrict__ W,
                 const float* __restrict__ Bs, float* __restrict__ out,
                 float* __restrict__ stash, int n, Chain ch) {
  extern __shared__ float smem[];
  const int E = ch.E, HW = ch.hw, rb = ch.round_bf16;
  float* h = smem;                                  // [TR][HW]
  float* x0 = ch.x0_alias ? smem : smem + TR * HW;  // [TR][E]
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
// For K2 the transposed weights are the f32 originals, as the TPU kernel's
// are.  For K5 (dbar given: it may be the same buffer as gzs, each element is
// read and later written by one thread) they are rounded, and
//   gz = g * act'(a_l) + dbar_l * act''(a_l).
// dx is accumulated MAXW columns at a time (the input may be wider).
__global__ void __launch_bounds__(NT, 2)
chain_bwd_data_kernel(const float* __restrict__ stash,
                      const float* __restrict__ WT,
                      const float* __restrict__ gin, float* __restrict__ dx,
                      float* gzs, const float* dbar, float* __restrict__ dbp,
                      int n, Chain ch) {
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
    const float* db2 =
        (dbar && Ly.act == ACT_SP100) ? dbar + (size_t)n * Ly.stash : nullptr;
    for (int idx = t; idx < TR * w; idx += NT) {
      const int r = idx / w, c = idx - r * w;
      const long g = row0 + r;
      const float av = g < n ? a[g * w + c] : 0.f;
      const float d = dact_from_a(Ly.act, av);
      float v = gb[r * GW + c] * d;
      if (db2 && g < n) v += db2[g * w + c] * d2act_from_d(Ly.act, d);
      gb[r * GW + c] = v;
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
    // dx += gz @ W_x^T (skip) and, at layer 0, gz @ W_h^T: both [w, E]
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 0 ? Ly.wx < 0 : l > 0) continue;
      const float* wt = WT + (pass == 0 ? Ly.wxt : Ly.wht);
      for (int cb = 0; cb < E; cb += MAXW) {
        zero_acc(acc);
        mm_tile(acc, gb, GW, wt + cb, E, w, E - cb, tx, ty);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const int c = cb + tx + 64 * j;
            if (c < E) dxs[(ty + 4 * i) * E + c] += acc[i][j];
          }
      }
    }
    if (l == 0) break;
    zero_acc(acc);
    mm_tile(acc, gb, GW, WT + Ly.wht, Ly.in, w, Ly.in, tx, ty);
    __syncthreads();  // every read of gb precedes its overwrite
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = ty + 4 * i, c = tx + 64 * j;
        if (c < Ly.in) gb[r * GW + c] = acc[i][j];
      }
    __syncthreads();
  }
  __syncthreads();
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

// K4 pass 2 (also K5 pass 2): the J-pass, the reverse sweep for output
// channel 0, from the last (linear) layer down.  q starts as the f32 column 0
// of the last W_h times its scale (wl_h, the unrounded last W_h [in, out]; on
// a last-layer skip column 0 of wl_x seeds j).  Below it, per layer:
//   p = round(q * act'(a_l));  j += s p W_x^T (skip);
//   q = s p W_h^T, which at layer 0 lands in j.
// WT holds the transposes of the rounded weights.  qst (optional, K5) gets
// every layer's q before it is turned into p.
__global__ void __launch_bounds__(NT, 2)
chain_jac_down_kernel(const float* __restrict__ stash,
                      const float* __restrict__ WT,
                      const float* __restrict__ wl_h,
                      const float* __restrict__ wl_x, float* __restrict__ jout,
                      float* __restrict__ qst, int n, Chain ch) {
  extern __shared__ float smem[];
  const int E = ch.E, HW = ch.hw, rb = ch.round_bf16;
  float* qb = smem;            // [TR][HW]
  float* js = smem + TR * HW;  // [TR][E]
  const int t = threadIdx.x, tx = t & 63, ty = t >> 6;
  const long row0 = (long)blockIdx.x * TR;

  {
    const Layer& Ll = ch.l[ch.L - 1];
    for (int idx = t; idx < TR * Ll.in; idx += NT) {
      const int r = idx / Ll.in, c = idx - r * Ll.in;
      qb[r * HW + c] = Ll.scale * wl_h[(size_t)c * Ll.out];
    }
    for (int idx = t; idx < TR * E; idx += NT) {
      const int c = idx % E;
      js[idx] = wl_x ? Ll.scale * wl_x[(size_t)c * Ll.out] : 0.f;
    }
  }
  __syncthreads();

  float acc[RPT][CPT];
  for (int l = ch.L - 2; l >= 0; --l) {
    const Layer& Ly = ch.l[l];
    const int w = Ly.out;
    const float* a = stash + (size_t)n * Ly.stash;
    float* qs = qst ? qst + (size_t)n * Ly.stash : nullptr;
    for (int idx = t; idx < TR * w; idx += NT) {
      const int r = idx / w, c = idx - r * w;
      const long g = row0 + r;
      const float q = qb[r * HW + c];
      const float av = g < n ? a[g * w + c] : 0.f;
      if (qs && g < n) qs[g * w + c] = q;
      qb[r * HW + c] = round_c(q * dact_from_a(Ly.act, av), rb);
    }
    __syncthreads();
    if (Ly.wx >= 0) {
      zero_acc(acc);
      mm_tile(acc, qb, HW, WT + Ly.wxt, E, w, E, tx, ty);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = tx + 64 * j;
          if (c < E) js[(ty + 4 * i) * E + c] += Ly.scale * acc[i][j];
        }
    }
    zero_acc(acc);
    mm_tile(acc, qb, HW, WT + Ly.wht, Ly.in, w, Ly.in, tx, ty);
    __syncthreads();  // every read of qb precedes its overwrite
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = ty + 4 * i, c = tx + 64 * j;
        if (c >= Ly.in) continue;
        if (l > 0) qb[r * HW + c] = acc[i][j] * Ly.scale;
        else js[r * E + c] += acc[i][j] * Ly.scale;
      }
    __syncthreads();
  }
  for (int idx = t; idx < TR * E; idx += NT) {
    const int r = idx / E, c = idx - r * E;
    const long g = row0 + r;
    if (g < n) jout[g * E + c] = js[idx];
  }
}

// K5 pass 3: the reverse of the J-pass, from layer 0 up to the last hidden
// layer.  qbar starts as gj (the cotangent of what layer 0's transposed
// product put into j).  Per layer, with q_l from the q stash:
//   pbar = s (round(qbar) W_h + round(gj) W_x);
//   dbar_l = pbar q_l  -> dbar stash;   p_l = round(q_l act') -> over q_l;
//   qbar = pbar act'(a_l), rounded      -> qbar stash (the next layer's dW
//                                          operand), unrounded at the top.
// The top qbar's column sums (and gj's, for a last-layer skip) go out as
// per-block partials colp [blocks, w_top + E]: times the last scale they are
// the J-pass's share of column 0 of the last dW.  W holds the rounded weights.
__global__ void __launch_bounds__(NT, 2)
chain_jac_up_kernel(const float* __restrict__ stash, float* __restrict__ qst,
                    const float* __restrict__ W, const float* __restrict__ gj,
                    float* __restrict__ dbar, float* __restrict__ qbs,
                    float* __restrict__ colp, int n, Chain ch) {
  extern __shared__ float smem[];
  const int E = ch.E, rb = ch.round_bf16;
  const int QW = ch.hw > E ? ch.hw : E;
  float* qb = smem;             // [TR][QW]
  float* gjs = smem + TR * QW;  // [TR][E]
  const int t = threadIdx.x, tx = t & 63, ty = t >> 6;
  const long row0 = (long)blockIdx.x * TR;
  const int wtop = ch.l[ch.L - 2].out;
  float* cp = colp + (size_t)blockIdx.x * (wtop + E);

  for (int idx = t; idx < TR * E; idx += NT) {
    const int r = idx / E, c = idx - r * E;
    const long g = row0 + r;
    const float v = g < n ? round_c(gj[g * E + c], rb) : 0.f;
    qb[r * QW + c] = v;
    gjs[idx] = v;
  }
  for (int c = t; c < E; c += NT) {
    float s = 0.f;
    for (int r = 0; r < TR; ++r)
      if (row0 + r < n) s += gj[(row0 + r) * E + c];
    cp[wtop + c] = s;
  }
  __syncthreads();

  float acc[RPT][CPT];
  for (int l = 0; l < ch.L - 1; ++l) {
    const Layer& Ly = ch.l[l];
    const int w = Ly.out;
    const bool top = l == ch.L - 2;
    const float* a = stash + (size_t)n * Ly.stash;
    float* qs = qst + (size_t)n * Ly.stash;
    float* dbl = dbar + (size_t)n * Ly.stash;
    float* qbl = qbs + (size_t)n * Ly.stash;
    zero_acc(acc);
    mm_tile(acc, qb, QW, W + Ly.wh, w, Ly.in, w, tx, ty);
    if (Ly.wx >= 0) mm_tile(acc, gjs, E, W + Ly.wx, w, E, w, tx, ty);
    __syncthreads();  // every read of qb precedes its overwrite
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 4 * i;
      const long g = row0 + r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 64 * j;
        if (c >= w) continue;
        const float pbar = Ly.scale * acc[i][j];
        float q = 0.f, av = 0.f;
        if (g < n) {
          q = qs[g * w + c];
          av = a[g * w + c];
        }
        const float d = dact_from_a(Ly.act, av);
        float qn = pbar * d;
        if (!top) qn = round_c(qn, rb);
        qb[r * QW + c] = qn;
        if (g < n) {
          qs[g * w + c] = round_c(q * d, rb);
          dbl[g * w + c] = pbar * q;
          if (!top) qbl[g * w + c] = qn;
        }
      }
    }
    __syncthreads();
  }
  for (int c = t; c < wtop; c += NT) {
    float s = 0.f;
    for (int r = 0; r < TR; ++r) s += qb[r * QW + c];
    cp[c] = s;
  }
}

// ---------------------------------------------------------------- C interface
// meta: 9 ints per layer (in, out, wh, wx, wht, wxt, b, act, stash);
// scales: one float per layer.  Every function returns a cudaError_t.

static int build_chain(Chain* ch, const int* meta, const float* scales, int L,
                       int E, int round_bf16) {
  if (L < 1 || L > MAXL || E < 1 || E > MAXE) return (int)cudaErrorInvalidValue;
  ch->L = L;
  ch->E = E;
  ch->round_bf16 = round_bf16;
  ch->hw = 1;
  ch->gw = 1;
  ch->bsum = 0;
  ch->x0_alias = 1;
  for (int l = 0; l < L; ++l) {
    const int* m = meta + 9 * l;
    Layer& y = ch->l[l];
    y.in = m[0]; y.out = m[1]; y.wh = m[2]; y.wx = m[3]; y.wht = m[4];
    y.wxt = m[5]; y.b = m[6]; y.act = m[7]; y.stash = m[8];
    y.scale = scales[l];
    if (y.in < 1 || y.in > (l == 0 ? MAXE : MAXW) || y.out < 1 ||
        y.out > (l == L - 1 ? MAXOUT : MAXW))
      return (int)cudaErrorInvalidValue;
    if (l > 0 && y.wx >= 0) ch->x0_alias = 0;
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
  const size_t smem = sizeof(float) * TR *
      (size_t)(ch.x0_alias ? (ch.hw > E ? ch.hw : E) : ch.hw + E);
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
                                     const float* dbar, float* dbp, int n,
                                     const int* meta,
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
      stash, WT, g, dx, gzs, dbar, dbp, n, ch);
  return launch_check();
}

// The value+Jacobian kernels take a chain of at least two layers whose last
// layer is linear and whose input is at most MAXW wide.
static int build_jac_chain(Chain* ch, const int* meta, const float* scales,
                           int L, int E, int round_bf16) {
  int err = build_chain(ch, meta, scales, L, E, round_bf16);
  if (err) return err;
  if (L < 2 || E > MAXW || ch->l[L - 1].act != ACT_NONE)
    return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" int nunerf_chain_jac_down(const float* stash, const float* WT,
                                     const float* wl_h, const float* wl_x,
                                     float* j, float* qst, int n,
                                     const int* meta, const float* scales,
                                     int L, int E, int round_bf16,
                                     void* stream) {
  Chain ch;
  int err = build_jac_chain(&ch, meta, scales, L, E, round_bf16);
  if (err) return err;
  if ((ch.l[L - 1].wx >= 0) != (wl_x != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)TR * (ch.hw + E) * sizeof(float);
  err = (int)cudaFuncSetAttribute(chain_jac_down_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  const unsigned grid = (unsigned)((n + TR - 1) / TR);
  chain_jac_down_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      stash, WT, wl_h, wl_x, j, qst, n, ch);
  return launch_check();
}

extern "C" int nunerf_chain_jac_up(const float* stash, float* qst,
                                   const float* W, const float* gj,
                                   float* dbar, float* qbs, float* colp, int n,
                                   const int* meta, const float* scales, int L,
                                   int E, int round_bf16, void* stream) {
  Chain ch;
  int err = build_jac_chain(&ch, meta, scales, L, E, round_bf16);
  if (err) return err;
  const size_t smem =
      (size_t)TR * ((ch.hw > E ? ch.hw : E) + E) * sizeof(float);
  err = (int)cudaFuncSetAttribute(chain_jac_up_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  const unsigned grid = (unsigned)((n + TR - 1) / TR);
  chain_jac_up_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      stash, qst, W, gj, dbar, qbs, colp, n, ch);
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
