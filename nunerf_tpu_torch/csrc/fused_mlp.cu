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
// compute dtype (f32, or bf16: a product of two bf16 values is exact in f32,
// so f32 FMAs on bf16 values and a bf16 tensor-core MMA with f32 accumulation
// form the same products).  Hidden activations are rounded to
// the compute dtype after each layer, the last layer stays f32, rows >= n are
// masked - as the TPU kernel's _forward_tile does.
//
// Two routes, chosen by round_bf16 (the wrapper's compute_dtype) and by
// nothing else; a chain a route cannot take is refused, never sent to the
// other one.
//
// The f32 route (round_bf16 == 0): plain FMA loops on f32 registers
// (mm_tile), f32 weights streamed from L2, f32 scratch stashes.  It is bound
// by the card's f32 rate outside the tensor cores and reaches about a
// quarter of it; it is the exact route (no TF32 anywhere), the one that
// small steps on the card are held against the CPU with.
//   * K1: one block per 64-row tile; the activation tile [64, <=256] and x0
//     (for the skip) live in shared memory; each thread owns a 16-row x
//     4-column register tile of the layer output.
//   * K2: pass 1 (the K1 loop) recomputes the forward into a global scratch
//     stash; pass 2 walks the layers downwards per tile (gz = g * act'(a), db
//     per-tile partials, dx, and the rounded gz into a second stash); pass 3
//     computes every dW as per-split partials of H^T @ GZ over row ranges.
//     Nothing carries across blocks: the partials are summed afterwards (the
//     TPU 'partial' mode, not its 'accum' mode).
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
//     splits (chain_dw_kernel): h_prev^T zs and s qbar^T p, a launch each.
//
// The bf16 route (round_bf16 == 1): the same passes on the tensor cores.
// Every matrix operand is a bf16 value there (the weights rounded once by
// the wrapper, x0, h, p, zs, qbar and gj rounded where the TPU kernel rounds
// them), so a tensor-core product with f32 accumulation forms the same
// products and only the order of the sums changes.  The matrix work itself
// is small for this card (the value-only SDF chain at 131,072 points: 120
// GFLOP, 0.12 ms at the bf16 peak), so each pass is bound by what surrounds
// it, and the design goes after that:
//   * K1's forward, on its own and as pass 1 of K2, K4 and K5, is
//     chain_fwd_wgmma_kernel: persistent, wgmma from shared memory, the
//     weights streamed once a 128-row tile pair by bulk copies through an
//     mbarrier ring (its own note says how and why).
//   * The other passes (K2's and K5's data pass, the J-pass of K4 and K5 and
//     its reverse) are chain_bwd_wgmma_kernel, the forward's skeleton with a
//     walk and an epilogue a pass, and every dW of a chunk is one wgmma GEMM
//     fed by TMA, chain_dw_wgmma_kernel (chain_bwd_wgmma.cuh, whose note says
//     how and why).
//   * K4/K5 are bound by the scratch stashes that carry a layer's values
//     from pass to pass through device memory.  They are stored in the
//     narrowest exact type, in the padded layout of MmaLayout
//     (ops/fused_mlp.py: every width a multiple of 16, zero pad columns, so
//     that the dW GEMM reads them as they lie): h, p, zs and the stored qbar
//     are bf16-exact and go as bf16; q and dbar are unrounded and stay f32,
//     which is why p and zs get stashes of their own instead of overwriting
//     them.
//   * K2's data pass multiplies by the UNROUNDED f32 W^T, as the TPU kernel
//     does, through an exact three-piece bf16 split of each weight
//     (chain_bwd_wgmma.cuh says why that gives the f32 products).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

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
  // the bf16 route's padded layout (every width and depth a multiple of 16)
  int inp, outp;  // padded input and output widths
  int pwh, pwx;   // offsets of W_h [inp,outp] and W_x [Ep,outp] in the bf16 pack
                  // (their transposes sit at the same offsets in the other pack)
  int pstash;     // sum of the padded output widths of the layers before this one
  float scale;
};

struct Chain {
  int L, E, hw, gw, bsum, round_bf16;
  int x0_alias;   // no layer past the first reads x0: K1 keeps it in h's storage
  Layer l[MAXL];
};

typedef __nv_bfloat16 bf16;

__device__ __host__ __forceinline__ int pad16(int v) { return (v + 15) & ~15; }

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

// K1 on the f32 route (nothing is rounded: the bf16 route has kernels of its
// own below).  out [n, d_L] f32; stash (optional) gets every layer's
// activation.
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
  const int E = ch.E, HW = ch.hw;
  float* h = smem;                                  // [TR][HW]
  float* x0 = ch.x0_alias ? smem : smem + TR * HW;  // [TR][E]
  const int t = threadIdx.x, tx = t & 63, ty = t >> 6;
  const long row0 = (long)blockIdx.x * TR;

  for (int idx = t; idx < TR * E; idx += NT) {
    const int r = idx / E, c = idx - r * E;
    const long g = row0 + r;
    x0[idx] = g < n ? x[g * E + c] : 0.f;
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
        const float a = act_f(Ly.act, z + Bs[Ly.b + c]);
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

// K2 pass 2 on the f32 route (K5's pass 4 there too).  Per 64-row tile, from
// the last layer down:
//   gz = g * act'(a_l);  db partial = column sums of gz;
//   gz = gz * scale -> gzs stash;  dx += gz @ W_x^T (skip);
//   g = gz @ W_h^T, or dx += it at layer 0.
// For K5 (dbar given: it may be the same buffer as gzs, each element is
// read and later written by one thread)
//   gz = g * act'(a_l) + dbar_l * act''(a_l).
// dx is accumulated MAXW columns at a time (the input may be wider).
__global__ void __launch_bounds__(NT, 2)
chain_bwd_data_kernel(const float* __restrict__ stash,
                      const float* __restrict__ WT,
                      const float* __restrict__ gin, float* __restrict__ dx,
                      float* gzs, const float* dbar, float* __restrict__ dbp,
                      int n, Chain ch) {
  extern __shared__ float smem[];
  const int E = ch.E, GW = ch.gw;
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
    const size_t sbase = (size_t)n * Ly.stash;
    const float* a = stash + sbase;
    const float* db2 =
        (dbar && Ly.act == ACT_SP100) ? dbar + sbase : nullptr;
    for (int idx = t; idx < TR * w; idx += NT) {
      const int r = idx / w, c = idx - r * w;
      const long g = row0 + r;
      const float d = dact_from_a(Ly.act, g < n ? a[g * w + c] : 0.f);
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
      gb[r * GW + c] = v;
      if (g < n) gzs[sbase + g * w + c] = v;
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

// K4 pass 2 (also K5 pass 2) on the f32 route, where round() below is the
// identity: the J-pass, the reverse sweep for output
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
  const int E = ch.E, HW = ch.hw;
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
      qb[r * HW + c] = q * dact_from_a(Ly.act, av);
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

// K5 pass 3 on the f32 route (round() is the identity): the reverse of the
// J-pass, from layer 0 up to the last hidden
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
  const int E = ch.E;
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
    const float v = g < n ? gj[g * E + c] : 0.f;
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
        const float qn = pbar * d;
        qb[r * QW + c] = qn;
        if (g < n) {
          qs[g * w + c] = q * d;
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

// ===================================================================
// The bf16 route: wgmma on the tensor cores
// ===================================================================
//
// Every operand is a bf16 value, so the products are the ones the f32 FMA
// loops above would form; only the order of the f32 sums differs.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The epilogues' activation math.  Every value they produce is rounded to
// bf16 (relative 4e-3) or multiplied into a sum that is, so they evaluate the
// same functions as act_f and dact_from_a through the hardware's ex2/lg2
// units, to about 1e-6 relative, at a tenth of the instructions: with
// expf + log1pf the softplus of a layer's 16,384 outputs costs more than the
// layer's matrix product.  e = exp(-|t|) is in (0, 1]; log1p(e) is e - e^2/2
// + e^3/3 below 2^-6 (where 1 + e would lose e's low bits) and log(1 + e)
// above.  A last layer (f32 output) keeps act_f.
__device__ __forceinline__ float act_mma(int a, float z) {
#ifdef PROF_NO_ACT
  return z;
#endif
  if (a == ACT_RELU) return fmaxf(z, 0.f);
  if (a == ACT_SP100) {
    // in base 2: u = 100 z log2(e), softplus = ln2 (max(u, 0) + log2(1 + 2^-|u|))
    const float u = 144.26950408889634f * z;
    const float e = exp2f(-fabsf(u));
    const float l = e < 0.015625f
                        ? e * (1.4426950408889634f -
                               e * (0.7213475204444817f - e * 0.4808983469629878f))
                        : __log2f(1.f + e);
    return (fmaxf(u, 0.f) + l) * 0.006931471805599453f;
  }
  return z;
}

__device__ __forceinline__ float dact_mma(int a_kind, float a) {
  if (a_kind == ACT_RELU) return a > 0.f ? 1.f : 0.f;
  if (a_kind == ACT_SP100) return 1.f - exp2f(-144.26950408889634f * a);
  return 1.f;
}

// ===================================================================
// K1 on the bf16 route: wgmma, bulk copies through an mbarrier ring
// ===================================================================
//
// Replaces the Pallas kernel _fwd_kernel (nunerf_tpu/ops/fused_mlp.py) on the
// bf16 route; pass 1 of K2, K4 and K5 is this kernel too.  The matrix work of
// the value-only SDF chain at 131,072 rows is 0.12 ms at the bf16 peak, its
// input and output 20 MB and 0.5 MB: what bounds it is neither but the
// weights (0.97 MB of bf16 in this pack), which every tile needs whole, and
// the epilogue (scale, bias, the softplus, rounding) of every hidden output.
// The design goes after both:
//   * Persistent: one CTA an SM (the grid is the wrapper's, ``wgmma_grid``)
//     walking 128-row tile pairs on a static stride, so every row's sums are
//     formed in the same order from run to run.  Four warpgroups: two for
//     each 64-row tile (wgmma's M), each taking half of every layer's
//     columns (m64n128 at a width of 256: 64 f32 accumulators a thread).
//   * No ping-pong: the tiles' warpgroups interleave their products and
//     epilogues on their own.  Turns between the tiles (named barriers
//     ordering their products, so that one tile's epilogue runs under the
//     other's products) were built and measured slower.
//   * The weights are streamed once a tile pair, not once a 64-row tile:
//     ``pack_wgmma`` lays every padded W_h and W_x as slices [width][64] in
//     the canonical K-major, 128-byte-swizzled layout that a wgmma
//     descriptor reads, in the order the products take them, so the CTA
//     walks one contiguous buffer with 1-D bulk copies (cp.async.bulk, no
//     tensor map) into a ring of 32 KB stages, whose full barriers count the
//     bytes in.  All four warpgroups read every slice, each its half of the
//     rows.  No producer warp: the last warpgroup to be done with a stage (a
//     counter a stage) starts the copy of the slice that follows into it, so
//     no thread ever waits for a free stage.
//   * Every product is a wgmma with both operands in shared memory, into f32
//     accumulators that the epilogue works in registers; it writes the
//     rounded activations into the tile's own operand tile, in the same
//     swizzled K-major layout, for the next layer (conflict-free 4-byte
//     stores from 8 swizzled row bases a thread and immediate offsets), and
//     to the stash.  x0 (layer 0's input and the skips', rounded
//     to bf16) has a tile of the same layout; with no skip past layer 0 the
//     activations' tile takes its place.  A slice is always 4 steps of 16:
//     the pack's slices are zero past the weights' depth, and the tiles are
//     written to the end of their 64-wide slab (zeros past the width), so no
//     branch sits between the wgmmas.
//   * Why not the usual Hopper shape (PERF.md has the measurements): a
//     producer warpgroup with setmaxnreg did not raise what ptxas allocates
//     to the consumers (it kept them within the launch's 168 registers a
//     thread, spilled and serialised every wgmma), and a producer warp makes
//     9 warps, 3 on one of the SM's four register files, 168 again.  The
//     activations kept in registers as wgmma's A fragments need 64 registers
//     beside 128 accumulators at a width of 256: they spilled.  With two
//     warpgroups of 128 accumulators, two warps a scheduler could not hide
//     the softplus's latency; the epilogue is what bounds the kernel, so it
//     gets four warpgroups.  A cluster of two CTAs sharing each slice by
//     multicast was no faster: the weights' L2 traffic is not the bound.
// The widths of the products are the wgmma widths ``pack_wgmma`` rounds each
// layer to (16, 32, 64, 128, 256, halved between the warpgroups; a last
// layer wider than 256 in blocks of 256): the columns past a layer's width
// are zero weights, written as zeros to the operand tile and neither
// stashed nor stored.
//
// Switches for timing alone, set with -D by tools/prof_chain_kernels.py
// --variants and by nothing else (such a build computes nothing right):
// PROF_NO_WGMMA leaves the products out, PROF_NO_BULK the weight copies (a
// stage's full barrier is arrived on without them), PROF_NO_ACT the
// epilogue's activation math; WG_MAXST caps the ring's depth.
#define WG_ROWS 64        // rows of a tile (wgmma's M)
#define WG_PAIR 128       // rows a CTA takes a turn: two tiles
#define WG_THREADS 512    // four warpgroups, two a tile
#define WG_STAGE 32768    // bytes of a ring stage: the widest slice, 256 x 128
#define WG_SLAB 8192      // bytes of 64 rows x 64 bf16 of an operand tile
#ifndef WG_MAXST
#define WG_MAXST 8        // deepest ring
#endif
#define WG_MAXSL 256      // slices of one pass over a chain
#define WG_SMEM_MAX 232448

struct WgPlan {
  int pairs;                // 128-row tile pairs, ceil(n / 128)
  int stages;               // ring depth
  int xslabs, hslabs;       // 64-wide slabs of the x0 and activation tiles
  int alias;                // the activations' tile is x0's
  int bwsum;                // the biases' columns: every block's width
  int nsl;                  // slices of one pass over the chain
  short bw[MAXL][2];        // wgmma width of each column block (0: none)
  int bytes[WG_MAXSL];      // bytes of each slice, in the products' order
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.  A wait of
// more than 2^35 clocks (about 20 s) is a fault of the kernel: it traps, and
// the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16) global -> shared, counted on the barrier
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
#ifdef PROF_NO_BULK
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
#else
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
#endif
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// this thread's shared-memory writes, before wgmma reads them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}

// The accumulators a wgmma writes asynchronously are not read before the
// wait that follows it: an empty asm that "writes" them after the wait.
template <int R>
__device__ __forceinline__ void keep(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The descriptor of an operand at shared address saddr (8-row groups
// 1024-aligned): rows of 64 bf16 (128 bytes, K-major), 128-byte swizzle,
// 8-row groups 1024 bytes apart; + 2 steps 16 deeper.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64, N] (+)= a[64, 16] b[16, N], both by descriptor; scale_d 0
// overwrites d.
template <int N>
struct WgSS;
template <> struct WgSS<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <> struct WgSS<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <> struct WgSS<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <> struct WgSS<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <> struct WgSS<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float ldsf(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float2 lds64(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t atom_add_shared(uint32_t addr, uint32_t v) {
  uint32_t old;
  asm volatile("atom.shared.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "r"(addr), "r"(v)
               : "memory");
  return old;
}

// The ring: stage s holds a slice at base + s * WG_STAGE.  Its bookkeeping
// sits at meta (shared addresses): the full barriers [WG_MAXST] (8 bytes
// each), the counters of warpgroups done with each stage [WG_MAXST], the
// offsets in the pack and the sizes of the chain's slices [WG_MAXSL] each.
// Slice q of the CTA's walk (turns x the chain's slices, total) sits in stage
// q % stages.  Only addresses and positions live in registers: the kernel's
// parameters give the rest where it is used.
#define WG_META_CNT (8 * WG_MAXST)
#define WG_META_OFFS (WG_META_CNT + 4 * WG_MAXST)
#define WG_META_LENS (WG_META_OFFS + 4 * WG_MAXSL)
#define WG_META_BYTES (WG_META_LENS + 4 * WG_MAXSL)
struct Ring {
  uint32_t base, meta;
  int stage, q, total;
  uint32_t phase;
  __device__ __forceinline__ void next(int stages) {
    ++q;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// start the copy of slice q (< total) of the walk into stage st
__device__ __forceinline__ void ring_fill(const Ring& rg, const WgPlan& plan,
                                          const bf16* W, int q, int st) {
  const int s = q % plan.nsl;
  const uint32_t off = lds32(rg.meta + WG_META_OFFS + 4 * s);
  const uint32_t len = lds32(rg.meta + WG_META_LENS + 4 * s);
  bulk_g2s(rg.base + st * WG_STAGE,
           reinterpret_cast<const unsigned char*>(W) + off, len,
           rg.meta + 8 * st);
}

// A warpgroup is done with stage st, which held slice q: its first thread
// counts it, and the fourth warpgroup to be done starts slice q + stages's
// copy into the stage.  Every read of the stage by all four has completed
// (each waited for its products first).
__device__ __forceinline__ void release(const Ring& rg, const WgPlan& plan,
                                        const bf16* W, int st, int q,
                                        bool leader) {
  if (leader && (atom_add_shared(rg.meta + WG_META_CNT + 4 * st, 1) & 3) == 3 &&
      q + plan.stages < rg.total)
    ring_fill(rg, plan, W, q + plan.stages, st);
}

// One column block's products for a warpgroup: acc = A @ W_h (+ x0 @ W_x)
// over its M columns of the block (b_off: their first row in a slice), the
// slices taken from the ring in order.  a_tile: the A operand of W_h (x0's
// tile for layer 0, else the activations'), x_tile x0's; nsh, nsx: slices of
// W_h and of W_x (0: no skip).  Each slice's 4 steps form one group, waited
// for before anything else runs (the other warpgroups keep the tensor cores
// busy meanwhile; with a group left in flight across the next slice's wait
// and copy, ptxas serialised every wgmma for want of registers), then the
// slice is released.
template <int M>
__device__ __forceinline__ void block_products(
    float (&acc)[M / 2], uint32_t a_tile, uint32_t x_tile, int nsh, int nsx,
    uint32_t b_off, Ring& rg, const WgPlan& plan, const bf16* W,
    bool leader) {
  int sd = 0;
  for (int part = 0; part < 2; ++part) {
    const int ns = part == 0 ? nsh : nsx;
    const uint32_t tile = part == 0 ? a_tile : x_tile;
    for (int s = 0; s < ns; ++s) {
      mbar_wait(rg.meta + 8 * rg.stage, rg.phase);
      const uint64_t da = sw128_desc(tile + s * WG_SLAB);
      const uint64_t db = sw128_desc(rg.base + rg.stage * WG_STAGE + b_off);
      wg_fence();
#ifndef PROF_NO_WGMMA
      WgSS<M>::mma(acc, da, db, sd);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk)
        WgSS<M>::mma(acc, da + 2 * kk, db + 2 * kk, 1);
#endif
      sd = 1;
      wg_commit();
      wg_wait<0>();
      keep(acc);
      release(rg, plan, W, rg.stage, rg.q, leader);
      rg.next(plan.stages);
    }
  }
}

// Byte of element (row r, column c) of an operand tile: 64-wide slabs of 64
// rows x 128 bytes, 8-row atoms, the 16-byte chunk c / 8 of row r at chunk
// (c / 8) ^ (r % 8) (``sw128_offset`` in ops/fused_mlp.py).
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return (c >> 6) * WG_SLAB + (r >> 3) * 1024 + (r & 7) * 128 +
         ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// A hidden layer's epilogue, in the accumulators' layout: a thread holds
// columns c0 + 8 j + 2 q + {0, 1} of its warp's rows rt and rt + 8 (rt = 16 w
// + g in the tile, r in the chain's rows).  z * scale + b, the activation,
// one rounding to bf16; columns past the layer's width are 0.  Each pair
// goes to the operand tile ht (4-byte stores: the 8 rows of a warp's store
// sit in 8 different chunks, conflict-free) and, with a stash, to it (row
// stride outp, columns below outp).  bias: the layer's biases, zero past its
// width.  With zero_to (a layer narrower than 64) the columns from zero_to
// to the slab's end are written as zeros.  At M >= 64 the chunk of column
// c0 + 8 j is j % 8 (c0 is a multiple of 64), so every store is one of 8
// row bases a thread plus an immediate.  Shared memory by address.  MASK:
// the block reaches past the layer's width.  z * scale is one rounding as
// before, and exact at a scale of 1.
template <int M, int ACT, bool STASH, bool MASK>
__device__ __forceinline__ void hidden_epilogue(const float (&acc)[M / 2],
                                                uint32_t ht, int c0,
                                                uint32_t bias, int out,
                                                int outp, float scale,
                                                bf16* st, int rt, long r,
                                                int n, int q, int zero_to) {
  const int g = rt & 7;
  const uint32_t row = ht + (rt >> 3) * 1024 + g * 128 + 4 * q;
  uint32_t base[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    base[k] = row + (M >= 64 ? (c0 >> 6) * WG_SLAB + ((k ^ g) << 4) : 0);
  bf16* st0 = STASH ? st + r * outp : nullptr;
#pragma unroll
  for (int j = 0; j < M / 8; ++j) {
    const int c = c0 + 8 * j + 2 * q;
    const float2 bb = lds64(bias + 4 * c);
    // a column past the width has z = 0 (zero weights, zero bias) and a
    // finite act(0): a multiply by 0 or 1 masks it without a branch, which
    // keeps the values' chains free to interleave
    const float m0 = c < out ? 1.f : 0.f, m1 = c + 1 < out ? 1.f : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float z0 = __fmul_rn(acc[4 * j + 2 * h], scale);
      const float z1 = __fmul_rn(acc[4 * j + 2 * h + 1], scale);
      float v0 = act_mma(ACT, z0 + bb.x), v1 = act_mma(ACT, z1 + bb.y);
      if (MASK) {
        v0 *= m0;
        v1 *= m1;
      }
      __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
      const uint32_t u = *reinterpret_cast<uint32_t*>(&p);
      if (M >= 64)
        sts32(base[j & 7] + (j >> 3) * WG_SLAB + h * 1024, u);
      else
        sts32(ht + tile_offset(rt + 8 * h, c), u);
      if (STASH && c < outp && r + 8 * h < n)
        *reinterpret_cast<uint32_t*>(st0 + 8 * h * outp + c) = u;
    }
  }
  for (int c = zero_to + 2 * q; c < 64; c += 8) {
    sts32(ht + tile_offset(rt, c), 0u);
    sts32(ht + tile_offset(rt + 8, c), 0u);
  }
}

// The last layer's epilogue: f32, act_f, columns c0 + ... below out, rows
// below n, row stride out.  bias: the layer's biases (a shared address).
template <int M>
__device__ __forceinline__ void last_epilogue(const float (&acc)[M / 2],
                                              uint32_t bias, int out, int act,
                                              float scale, int c0, float* y,
                                              long r, int n, int q) {
#pragma unroll
  for (int j = 0; j < M / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + 2 * q + e;
      if (c >= out) continue;
      const float b = ldsf(bias + 4 * c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r + 8 * h >= n) continue;
        float z = acc[4 * j + 2 * h + e];
        if (scale != 1.f) z *= scale;
        y[(r + 8 * h) * out + c] = act_f(act, z + b);
      }
    }
}

// What a thread keeps for the whole kernel.
struct WgThread {
  uint32_t xt, ht, bias;  // shared addresses: x0's tile, the activations', the biases
  int rt, half, rtile, q; // row in the tile, column half, tile, lane % 4
  bool leader;            // the warpgroup's first thread
};

// Column block b of layer l for a warpgroup: its half of the block's
// products, then (both warpgroups of the tile done reading it) the epilogue,
// and for a hidden layer the tile made ready for the next one.  wb: the
// layer's first bias; r: this thread's first row.  The layer's fields are
// read from the parameters after the products.
template <int N>
__device__ __forceinline__ void run_block(const Chain& ch, const WgPlan& plan,
                                          const bf16* W, float* out,
                                          bf16* stash, int n, int l, int b,
                                          int wb, long r, const WgThread& th,
                                          Ring& rg) {
  constexpr int M = N / 2;
  float acc[M / 2];
  {
    const int nsh = (ch.l[l].inp + 63) >> 6;
    const int nsx = ch.l[l].wx >= 0 ? plan.xslabs : 0;
    block_products<M>(acc, l == 0 ? th.xt : th.ht, th.xt, nsh, nsx,
                      (uint32_t)(th.half * M * 128), rg, plan, W, th.leader);
  }
  const Layer& Ly = ch.l[l];
  const int c0 = b * MAXW + th.half * M;
  const uint32_t bias = th.bias + 4 * wb;
  if (l == ch.L - 1) {
    last_epilogue<M>(acc, bias, Ly.out, Ly.act, Ly.scale, c0, out, r, n, th.q);
    return;
  }
  const int tbar = 1 + th.rtile;  // the tile's two warpgroups
  bar_sync(tbar, 2 * 128);        // the tile is read: it may be overwritten
  const int zero_to = N < 64 && th.half ? N : 64;
  bf16* st = stash ? stash + (size_t)n * Ly.pstash : nullptr;
#define WG_EPILOGUE(ACT, STASH, MASK)                                       \
  hidden_epilogue<M, ACT, STASH, MASK>(acc, th.ht, c0, bias, Ly.out, Ly.outp, \
                                       Ly.scale, st, th.rt, r, n, th.q,      \
                                       zero_to)
  const bool mask = c0 + M > Ly.out;
  if (Ly.act == ACT_SP100) {
    if (st) {
      if (mask) WG_EPILOGUE(ACT_SP100, true, true);
      else WG_EPILOGUE(ACT_SP100, true, false);
    } else {
      if (mask) WG_EPILOGUE(ACT_SP100, false, true);
      else WG_EPILOGUE(ACT_SP100, false, false);
    }
  } else if (Ly.act == ACT_RELU) {
    if (st) WG_EPILOGUE(ACT_RELU, true, true);
    else WG_EPILOGUE(ACT_RELU, false, true);
  } else {
    if (st) WG_EPILOGUE(ACT_NONE, true, true);
    else WG_EPILOGUE(ACT_NONE, false, true);
  }
#undef WG_EPILOGUE
  fence_async_shared();
  bar_sync(tbar, 2 * 128);  // the whole tile, before the next layer reads it
}

// Shared memory of the kernel: the ring (1024-aligned), both tiles' operand
// tiles (x0's and the activations', or one where they alias), the biases
// [bwsum] (each layer's as wide as its blocks, zero past its width), the
// ring's bookkeeping (WG_META_BYTES).
__host__ __device__ __forceinline__ size_t wg_tile_bytes(int xslabs,
                                                         int hslabs,
                                                         int alias) {
  return (size_t)WG_SLAB *
         (alias ? (xslabs > hslabs ? xslabs : hslabs) : xslabs + hslabs);
}
__host__ __device__ __forceinline__ size_t wg_smem_bytes(int stages,
                                                         size_t tile,
                                                         int bwsum) {
  return 1024 + (size_t)stages * WG_STAGE + 2 * tile +
         sizeof(float) * bwsum + WG_META_BYTES;
}

__global__ void __launch_bounds__(WG_THREADS, 1)
chain_fwd_wgmma_kernel(const float* __restrict__ x, const bf16* __restrict__ W,
                       const float* __restrict__ Bs, float* __restrict__ out,
                       bf16* __restrict__ stash, int n, Chain ch,
                       WgPlan plan) {
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const int E = ch.E;
  const int S = plan.stages;
  const size_t tile = wg_tile_bytes(plan.xslabs, plan.hslabs, plan.alias);
  const uint32_t raw = smem_u32(smem_wg);
  unsigned char* ring = smem_wg + ((1024 - (raw & 1023)) & 1023);
  unsigned char* tiles = ring + (size_t)S * WG_STAGE;
  float* bias = reinterpret_cast<float*>(tiles + 2 * tile);
  unsigned char* meta = reinterpret_cast<unsigned char*>(bias + plan.bwsum);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  // the tile walk (``tile_walk`` in ops/fused_mlp.py): turn k of CTA b takes
  // pair b + k G
  const int turns = (plan.pairs - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;
  Ring rg{smem_u32(ring), smem_u32(meta), 0, 0, turns * plan.nsl, 0};
  if (t == 0) {
    int* cnt = reinterpret_cast<int*>(meta + WG_META_CNT);
    int* offs = reinterpret_cast<int*>(meta + WG_META_OFFS);
    int* lens = reinterpret_cast<int*>(meta + WG_META_LENS);
    for (int s = 0, o = 0; s < plan.nsl; o += plan.bytes[s], ++s) {
      offs[s] = o;
      lens[s] = plan.bytes[s];
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(rg.meta + 8 * s, 1);
      cnt[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < S && q < rg.total; ++q) ring_fill(rg, plan, W, q, q);
  }
  for (int l = 0, base = 0; l < ch.L; ++l) {
    const int w = plan.bw[l][0] + plan.bw[l][1];
    for (int c = t; c < w; c += WG_THREADS)
      bias[base + c] = c < ch.l[l].out ? Bs[ch.l[l].b + c] : 0.f;
    base += w;
  }
  __syncthreads();

  // warpgroup w: tile w / 2, columns half w % 2; a warp's rows in its tile
  WgThread th;
  th.rtile = warp >> 3;
  th.half = (warp >> 2) & 1;
  th.rt = 16 * (warp & 3) + (lane >> 2);
  th.q = lane & 3;
  th.leader = (t & 127) == 0;
  th.xt = smem_u32(tiles + th.rtile * tile);
  th.ht = th.xt + (plan.alias ? 0 : WG_SLAB * plan.xslabs);
  th.bias = smem_u32(bias);
  const int tbar = 1 + th.rtile;  // the tile's two warpgroups
  const int xr0 = 8 * (warp & 7);  // the 8 rows of x0 this warp writes
  for (int k = 0; k < turns; ++k) {
    const long row0 = ((long)blockIdx.x + (long)k * gridDim.x) * WG_PAIR +
                      th.rtile * WG_ROWS;
    // x0: 8 rows a warp of the tile's 8, rounded to bf16, zero past n and E
    // to the end of the tile; a warp's 32 lanes read 64 columns of a row
    bar_sync(tbar, 2 * 128);  // the last turn's reads of the tile are done
    for (int c = 2 * lane; c < 64 * plan.xslabs; c += 64) {
      float v[16];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const long gr = row0 + xr0 + rr;
        const float* xr = x + gr * E + c;
        v[2 * rr] = gr < n && c < E ? xr[0] : 0.f;
        v[2 * rr + 1] = gr < n && c + 1 < E ? xr[1] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * rr], v[2 * rr + 1]);
        sts32(th.xt + tile_offset(xr0 + rr, c), *reinterpret_cast<uint32_t*>(&p));
      }
    }
    fence_async_shared();
    bar_sync(tbar, 2 * 128);
    const long r = row0 + th.rt;
    for (int l = 0, wb = 0; l < ch.L; ++l) {
      for (int b = 0; b < 2; ++b) {
        switch (plan.bw[l][b]) {
          case 0: break;
          case 16: run_block<16>(ch, plan, W, out, stash, n, l, b, wb, r, th, rg); break;
          case 32: run_block<32>(ch, plan, W, out, stash, n, l, b, wb, r, th, rg); break;
          case 64: run_block<64>(ch, plan, W, out, stash, n, l, b, wb, r, th, rg); break;
          case 128: run_block<128>(ch, plan, W, out, stash, n, l, b, wb, r, th, rg); break;
          default: run_block<256>(ch, plan, W, out, stash, n, l, b, wb, r, th, rg); break;
        }
      }
      wb += plan.bw[l][0] + plan.bw[l][1];
    }
  }
}

// ---------------------------------------------------------------- C interface
// meta: 12 ints per layer (in, out, wh, wx, wht, wxt, b, act, stash, and the
// bf16 route's pwh, pwx, pstash); scales: one float per layer.  round_bf16
// chooses the route: 0 the f32 FMA kernels, 1 the tensor-core kernels, whose
// weight packs and stashes are bf16 in the padded layout.  Every function
// returns a cudaError_t.

#define META 12

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
    const int* m = meta + META * l;
    Layer& y = ch->l[l];
    y.in = m[0]; y.out = m[1]; y.wh = m[2]; y.wx = m[3]; y.wht = m[4];
    y.wxt = m[5]; y.b = m[6]; y.act = m[7]; y.stash = m[8];
    y.pwh = m[9]; y.pwx = m[10]; y.pstash = m[11];
    y.inp = pad16(y.in); y.outp = pad16(y.out);
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

template <typename K>
static int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

#include "chain_bwd_wgmma.cuh"

// The bf16 forward's plan, from the wrapper (``wgmma_plan`` in
// ops/fused_mlp.py): grid, slices, then per layer the wgmma widths
// of its two column blocks (0: none), then the bytes of every slice in the
// products' order.  It is held to the chain here: the slices' walk (per
// block W_h's 64-deep slices, then W_x's), each slice its block's width x 128
// bytes, hidden layers one block, every block as wide as the layer's padded
// width; the grid at most one CTA a tile pair.  The
// ring is as deep as the shared memory left beside the operand tiles and the
// biases allows (``wgmma_stages``), at least two stages.
static int build_wg_plan(WgPlan* p, const Chain& ch, const int* plan,
                         int nplan, int n, int* grid) {
  const int L = ch.L;
  if (!plan || nplan < 2 + 2 * L) return (int)cudaErrorInvalidValue;
  *grid = plan[0];
  p->nsl = plan[1];
  const int* bw = plan + 2;
  const int* bytes = plan + 2 + 2 * L;
  if (*grid < 1 || p->nsl < 1 || p->nsl > WG_MAXSL ||
      nplan != 2 + 2 * L + p->nsl)
    return (int)cudaErrorInvalidValue;
  const int Ep = pad16(ch.E);
  int s = 0, hidden = 0;
  for (int l = 0; l < L; ++l) {
    const Layer& y = ch.l[l];
    const int k = (y.inp + 63) / 64 + (y.wx >= 0 ? (Ep + 63) / 64 : 0);
    int cover = 0;
    for (int b = 0; b < 2; ++b) {
      const int w = bw[2 * l + b];
      p->bw[l][b] = (short)w;
      if (w == 0 && b == 1) continue;
      if ((w != 16 && w != 32 && w != 64 && w != 128 && w != 256) ||
          (b == 1 && (l < L - 1 || bw[2 * l] != MAXW)))
        return (int)cudaErrorInvalidValue;
      cover += w;
      if (l < L - 1 && w > hidden) hidden = w;
      for (int i = 0; i < k; ++i, ++s) {
        if (s >= p->nsl || bytes[s] != w * 128) return (int)cudaErrorInvalidValue;
        p->bytes[s] = bytes[s];
      }
    }
    if (cover < y.outp) return (int)cudaErrorInvalidValue;
  }
  if (s != p->nsl) return (int)cudaErrorInvalidValue;
  p->pairs = (n + WG_PAIR - 1) / WG_PAIR;
  if (*grid > p->pairs) return (int)cudaErrorInvalidValue;
  p->bwsum = 0;
  for (int l = 0; l < L; ++l) p->bwsum += bw[2 * l] + bw[2 * l + 1];
  p->xslabs = (Ep + 63) / 64;
  p->hslabs = (hidden + 63) / 64;
  p->alias = ch.x0_alias;
  const size_t tile = wg_tile_bytes(p->xslabs, p->hslabs, p->alias);
  int S = WG_MAXST;
  while (S >= 2 && wg_smem_bytes(S, tile, p->bwsum) > WG_SMEM_MAX) --S;
  if (S < 2) return (int)cudaErrorInvalidValue;
  p->stages = S;
  return 0;
}

// plan: the bf16 route's (build_wg_plan), unused on the f32 route
extern "C" int nunerf_chain_fwd(const float* x, const void* W,
                                const float* B, float* out, void* stash,
                                int n, const int* meta, const float* scales,
                                int L, int E, int round_bf16, const int* plan,
                                int nplan, void* stream) {
  Chain ch;
  int err = build_chain(&ch, meta, scales, L, E, round_bf16);
  if (err) return err;
  if (round_bf16) {
    WgPlan p;
    int grid;
    err = build_wg_plan(&p, ch, plan, nplan, n, &grid);
    if (err) return err;
    const size_t smem = wg_smem_bytes(
        p.stages, wg_tile_bytes(p.xslabs, p.hslabs, p.alias), p.bwsum);
    err = set_smem(chain_fwd_wgmma_kernel, smem);
    if (err) return err;
    chain_fwd_wgmma_kernel<<<grid, WG_THREADS, smem, (cudaStream_t)stream>>>(
        x, (const bf16*)W, B, out, (bf16*)stash, n, ch, p);
    return launch_check();
  }
  const unsigned grid = (unsigned)((n + TR - 1) / TR);
  const size_t smem = sizeof(float) * TR *
      (size_t)(ch.x0_alias ? (ch.hw > E ? ch.hw : E) : ch.hw + E);
  err = set_smem(chain_fwd_kernel, smem);
  if (err) return err;
  chain_fwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      x, (const float*)W, B, out, (float*)stash, n, ch);
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

// The f32 route's passes (the bf16 route's are nunerf_chain_bwd_wgmma):
// K2's data pass (dbar null) and K5's (dbar given), the J-pass and its
// reverse, which writes p over q.
extern "C" int nunerf_chain_bwd_data(const float* stash, const float* WT,
                                     const float* g, float* dx, float* gzs,
                                     const float* dbar, float* dbp, int n,
                                     const int* meta, const float* scales,
                                     int L, int E, void* stream) {
  Chain ch;
  int err = dbar ? build_jac_chain(&ch, meta, scales, L, E, 0)
                 : build_chain(&ch, meta, scales, L, E, 0);
  if (err) return err;
  const unsigned grid = (unsigned)((n + TR - 1) / TR);
  const size_t smem = (size_t)TR * (ch.gw + E) * sizeof(float);
  err = set_smem(chain_bwd_data_kernel, smem);
  if (err) return err;
  chain_bwd_data_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      stash, WT, g, dx, gzs, dbar, dbp, n, ch);
  return launch_check();
}

extern "C" int nunerf_chain_jac_down(const float* stash, const float* WT,
                                     const float* wl_h, const float* wl_x,
                                     float* j, float* qst, int n,
                                     const int* meta, const float* scales,
                                     int L, int E, void* stream) {
  Chain ch;
  int err = build_jac_chain(&ch, meta, scales, L, E, 0);
  if (err) return err;
  if ((ch.l[L - 1].wx >= 0) != (wl_x != nullptr))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + TR - 1) / TR);
  const size_t smem = (size_t)TR * (ch.hw + E) * sizeof(float);
  err = set_smem(chain_jac_down_kernel, smem);
  if (err) return err;
  chain_jac_down_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      stash, WT, wl_h, wl_x, j, qst, n, ch);
  return launch_check();
}

extern "C" int nunerf_chain_jac_up(const float* stash, float* qst,
                                   const float* W, const float* gj,
                                   float* dbar, float* qbs, float* colp,
                                   int n, const int* meta, const float* scales,
                                   int L, int E, void* stream) {
  Chain ch;
  int err = build_jac_chain(&ch, meta, scales, L, E, 0);
  if (err) return err;
  const unsigned grid = (unsigned)((n + TR - 1) / TR);
  const size_t smem =
      (size_t)TR * ((ch.hw > E ? ch.hw : E) + E) * sizeof(float);
  err = set_smem(chain_jac_up_kernel, smem);
  if (err) return err;
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

// The backward walks on the bf16 route (chain_bwd_wgmma_kernel): pass
// BW_DATA (split: K2's, from ylast; else K5's, with dbar), BW_JDOWN (q, zst:
// K5's q and p stashes, null for K4), BW_JUP.  W: the walk's pack from its
// first slice; h: the activation stash; zst: the stash the A tile goes to
// (the data pass's zs, the J-pass's p, its reverse's qbar); grid: the
// persistent CTAs (``wgmma_grid``); nsl, nbytes: the wrapper's counts of the
// walk (``bwd_walk``), held to the kernel's own.
extern "C" int nunerf_chain_bwd_wgmma(int pass, int split, const void* W,
                                      const float* g, const float* ylast,
                                      const void* h, float* out, void* zst,
                                      const float* dbar, float* q, float* dbo,
                                      float* part, const float* wl_h,
                                      const float* wl_x, int n, const int* meta,
                                      const float* scales, int L, int E,
                                      int grid, int nsl, int nbytes,
                                      void* stream) {
  Chain ch;
  const bool k2 = pass == BW_DATA && split;
  int err = k2 ? build_chain(&ch, meta, scales, L, E, 1)
               : build_jac_chain(&ch, meta, scales, L, E, 1);
  if (err) return err;
  if (pass != BW_DATA && split) return (int)cudaErrorInvalidValue;
  // h: the hidden layers' stash (none in a one-layer chain)
  if (!W || (L > 1 && !h) || (pass != BW_JDOWN && !g)) return (int)cudaErrorInvalidValue;
  if (pass == BW_JDOWN && (q == nullptr) != (zst == nullptr))
    return (int)cudaErrorInvalidValue;
  BwPlan plan;
  err = build_bw_plan(&plan, ch, pass, split, n, grid, nsl, nbytes);
  if (err) return err;
  // the tensor maps: h's hidden layers, and the layers of the A tile's stash
  BwMaps maps;
  memset(&maps, 0, sizeof(maps));
  const bf16* hb = (const bf16*)h;
  bf16* zb = (bf16*)zst;
  for (int l = 0; l < L - 1; ++l) {
    err = encode_box_map(&maps.a[l], hb + (size_t)n * ch.l[l].pstash, n, ch.l[l].outp);
    if (err) return err;
  }
  const int nout = pass == BW_DATA ? L : pass == BW_JDOWN ? (zb ? L - 1 : 0) : L - 2;
  for (int l = 0; l < nout; ++l) {
    err = encode_box_map(&maps.out[l], zb + (size_t)n * ch.l[l].pstash, n, ch.l[l].outp);
    if (err) return err;
  }
  const BwPtrs P{(const bf16*)W, g, ylast, hb, out, zb, dbar, q, dbo, part, wl_h, wl_x};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pass) {
    case BW_DATA:
      if (!out || !zst || !part || (k2 ? !ylast : !dbar))
        return (int)cudaErrorInvalidValue;
      return k2 ? launch_bw<BW_DATA, true>(maps, P, n, ch, plan, grid, s)
                : launch_bw<BW_DATA, false>(maps, P, n, ch, plan, grid, s);
    case BW_JDOWN:
      if (!out || !wl_h || (ch.l[L - 1].wx >= 0) != (wl_x != nullptr))
        return (int)cudaErrorInvalidValue;
      return q ? launch_bw<BW_JDOWN, true>(maps, P, n, ch, plan, grid, s)
               : launch_bw<BW_JDOWN, false>(maps, P, n, ch, plan, grid, s);
    case BW_JUP:
      if ((L > 2 && !zst) || !q || !dbo || !part) return (int)cudaErrorInvalidValue;
      return launch_bw<BW_JUP, false>(maps, P, n, ch, plan, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Every dW of a chain over n rows in one launch (the bf16 route): ntiles
// table rows (DW_ROWW ints), splits row ranges of rps rows (a multiple of
// 64), part [splits][part_stride]; the tensor maps of the operands' stash
// layers, each [n, width] bf16 at maps[i]; grid persistent CTAs.
extern "C" int nunerf_chain_dw_wgmma(const int* table, const float* scales,
                                     const void* const* maps,
                                     const int* widths, int nmaps,
                                     float* part, long long part_stride,
                                     int ntiles, int n, int splits, int rps,
                                     int grid, void* stream) {
  if (ntiles < 1 || splits < 1 || rps < 1 || rps % 64 || n < 1 || nmaps < 1 ||
      nmaps > DW_MAXMAPS || grid < 1 || grid > ntiles * splits)
    return (int)cudaErrorInvalidValue;
  DwMaps m;
  memset(&m, 0, sizeof(m));
  for (int i = 0; i < nmaps; ++i) {
    const int err = encode_box_map(&m.m[i], maps[i], n, widths[i]);
    if (err) return err;
  }
  const int stages = DW_MAXST;
  const size_t smem = 1024 + (size_t)stages * DW_STAGE + 16 * DW_MAXST;
  const int err = set_smem(chain_dw_wgmma_kernel, smem);
  if (err) return err;
  chain_dw_wgmma_kernel<<<grid, DW_THREADS, smem, (cudaStream_t)stream>>>(
      m, table, scales, part, part_stride, ntiles, ntiles * splits, n, rps,
      stages);
  return launch_check();
}

extern "C" const char* nunerf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
