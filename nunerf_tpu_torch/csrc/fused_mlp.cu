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
// The bf16 route (round_bf16 == 1): the same passes on tensor-core tiles.
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
//   * The other passes run mma.sync.m16n8k16 tiles.  Their weights are
//     packed as real bf16, each matrix and its transpose, zero-padded so
//     that every depth and width is a multiple of 16 (MmaLayout in
//     ops/fused_mlp.py): no masks inside a k-step, 16-byte cp.async pieces,
//     aligned ldmatrix rows.  A block is 64 rows x 8 warps, each warp a
//     [32, 64] piece of the layer output: 64 f32 accumulators a thread, the
//     whole layer output in registers before the epilogue runs; weight
//     slices of 32 rows come from L2 through three cp.async stages, the
//     next product's first slices started before the epilogue.
//   * K4/K5 are bound by the scratch stashes that carry a layer's values
//     from pass to pass through device memory.  They are stored in the
//     narrowest exact type: h, p, zs and the stored qbar are bf16-exact and
//     go as bf16 (padded rows, zero pad columns, so that the dW kernel reads
//     them as they lie); q and dbar are unrounded and stay f32, which is why
//     p and zs get stashes of their own here instead of overwriting them.
//     The J-pass keeps only p in shared memory: q arrives in the
//     accumulators and is stored and turned into p by the epilogue; the
//     reverse pass and the data pass work the same way, and take their
//     column sums (db, the seed's share of the last dW) from the
//     accumulators by warp shuffles.
//   * dW: one launch a chunk for every weight of the chain
//     (chain_dw_mma_kernel), driven by a table of [128, 128] output tiles x
//     row splits; a block sums both of K5's terms into one set of
//     accumulators (s qbar^T p first, then the scale, then h_prev^T zs); both
//     operands are row-major [rows, width] stashes, read by transposed
//     ldmatrix from 64-row slices staged by cp.async (zero-filled past the
//     split's end).  Per-split partials and one sum outside, no atomics: the
//     result is the same from run to run.
//   * K2's data pass multiplies by the UNROUNDED f32 W^T, as the TPU kernel
//     does.  Each f32 weight is split into three bf16 pieces whose sum is the
//     weight (mma_gemm_split), so the pass runs on the tensor cores too: three
//     MMAs a k-step from one A fragment of the rounded gz, one f32
//     accumulator, the products of the f32 W^T summed in another order.

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
// The bf16 route: tensor-core tiles (mma.sync m16n8k16, f32 accumulation)
// ===================================================================
//
// Every operand is a bf16 value, so the products are the ones the f32 FMA
// loops above would form; only the order of the f32 sums differs.

// Switches for timing alone, set with -D by tools/prof_chain_kernels.py
// --variants and by nothing else (K1's forward has switches of its own, in
// its note): KS and NSTAGE give another pipeline shape;
// PROF_NO_MMA, PROF_NO_CP_ASYNC, PROF_NO_LDMATRIX, PROF_NO_ACT and
// PROF_NO_PREFETCH each compile one piece of this route out (such a build
// computes nothing right: what the piece costs is the time that goes with it);
// PROF_SPLIT_UNROLLED unrolls K2's split gemm over its three pieces,
// NSTAGE3 gives that gemm another number of stages, and PROF_DX_GLOBAL sends
// the data passes' dx to device memory from the accumulators.  One switch
// plants a fault instead, for tools/prof_chain_kernels.py --split-faults
// alone: PROF_SPLIT_SKIP=p leaves piece p of K2's split out (2: lo, 1: mid),
// to show which checks see it.
#ifndef KS
#define KS 32            // depth of a staged weight slice
#endif
#define AS (MAXW + 8)    // row stride (bf16) of an activation tile: 528 bytes,
                         // so the 8 rows of an ldmatrix hit 8 different
                         // 16-byte bank groups
#define WSS (MAXW + 8)   // row stride of a staged weight slice
#define WSTAGE (KS * WSS)
#ifndef NSTAGE
#define NSTAGE 3         // weight stages: NSTAGE - 1 slices in flight behind the one at work
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without passing through registers; with
// bytes == 0 the destination is filled with zeros and src is not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
#ifndef PROF_NO_CP_ASYNC
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
#endif
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most the N newest groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
#ifndef PROF_NO_LDMATRIX
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
#endif
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
#ifndef PROF_NO_LDMATRIX
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
#endif
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
#ifndef PROF_NO_MMA
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#endif
}

// The block's 8 warps tile a [64, 256] product as 2 x 4 warps of [32, 64]:
// a warp owns 2 m-tiles x 8 n-tiles of m16n8, 64 f32 accumulators a thread.
// Accumulator e of tile (mi, ni) sits at
//   row 32 wr + 16 mi + 8 (e >> 1) + lane / 4,
//   column 64 wc + 8 ni + 2 (lane % 4) + (e & 1).
typedef float Acc[2][8][4];

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

// Ask L2 for the rows [row0, row0 + 64) (those below n) of a stash layer
// whose rows are row_bytes long, a 128-byte line a request: the epilogue
// that reads them runs after a whole matrix product, and finds them there.
__device__ __forceinline__ void prefetch_rows(const void* base, long row0,
                                              int n, int row_bytes, int t) {
  const int lpr = (row_bytes + 127) >> 7;
  const char* p = reinterpret_cast<const char*>(base);
  for (int idx = t; idx < TR * lpr; idx += NT) {
    const int r = idx / lpr, c = idx - r * lpr;
#ifndef PROF_NO_PREFETCH
    if (row0 + r < n)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
          p + (size_t)(row0 + r) * row_bytes + c * 128));
#endif
  }
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

struct WarpPos {
  int wr, wc, g, t2;  // warp row and column, lane / 4, 2 (lane % 4)
  __device__ WarpPos(int t) {
    const int warp = t >> 5, lane = t & 31;
    wr = warp >> 2; wc = warp & 3; g = lane >> 2; t2 = 2 * (lane & 3);
  }
  // n-tiles of this warp inside ncols columns (a multiple of 16), <= 0: none
  __device__ int ntiles(int ncols) const {
    const int nt = (ncols - 64 * wc) >> 3;
    return nt > 8 ? 8 : nt;
  }
  __device__ int row(int mi, int half) const {
    return 32 * wr + 16 * mi + 8 * half + g;
  }
  __device__ int col(int ni) const { return 64 * wc + 8 * ni + t2; }
};

template <int ROWS = KS>
__device__ __forceinline__ void stage_slice(bf16* ws,
                                            const bf16* __restrict__ B,
                                            int ldb, int k0, int krows,
                                            int ncols, int t) {
  // thread t copies the 16-byte piece t % 32 of rows t / 32, + 8, + 16, ...
  // (a row has at most 32 pieces): no division, at most ROWS / 8 copies
  const int c = t & 31;
  if (c < (ncols >> 3)) {
    const bf16* src = B + (size_t)k0 * ldb + c * 8;
    bf16* dst = ws + c * 8;
#pragma unroll
    for (int r = t >> 5; r < ROWS; r += NT / 32)
      if (r < krows) cp_async16(dst + r * WSS, src + (size_t)r * ldb, 16);
  }
  cp_async_commit();
}

// The B operand of a product: bf16 in global memory, [Kp, ncols] at row
// stride ldb (padded: Kp, ncols and ldb are multiples of 16, ncols <= 256).
struct GemmB {
  const bf16* B;
  int ldb, Kp, ncols;
};

// Start a product's first two weight slices on their way.  The caller has
// passed a barrier since the last product's tensor-core work, so the stages
// are free; it may run an epilogue while the slices travel.
__device__ __forceinline__ void gemm_head(const GemmB& b, bf16* ws, int t) {
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    const int rest = b.Kp - s * KS;
    if (rest > 0)
      stage_slice(ws + s * WSTAGE, b.B, b.ldb, s * KS, rest < KS ? rest : KS,
                  b.ncols, t);
    else
      cp_async_commit();
  }
}

// acc += A[64, Kp] @ B.  A: bf16 in shared memory, row stride lda.  B is
// streamed through the three-stage buffer ws in slices of KS rows with
// cp.async: slices s + 1 and s + 2 are in flight while the tensor cores work
// on slice s, one barrier a slice, one (possibly empty) group a slice so that
// "all but the newest group" always means "slice s has landed".  Every thread
// of the block calls it.  Without head_done it passes a barrier and starts
// the head itself; either way the barrier of slice 0 orders the caller's
// writes of A before the first read.
__device__ __forceinline__ void mma_gemm(Acc& acc, const bf16* A, int lda,
                                         const GemmB& b, bf16* ws, int t,
                                         bool head_done = false) {
  const int lane = t & 31;
  const WarpPos wp(t);
  const int Kp = b.Kp;
  const int nt = wp.ntiles(b.ncols);
  const int nsl = (Kp + KS - 1) / KS;
  if (!head_done) {
    __syncthreads();
    gemm_head(b, ws, t);
  }
  // ldmatrix row addresses: lanes 8j..8j+7 give the rows of matrix j
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  const bf16* a_base = A + (32 * wp.wr + lr) * lda + lc;
  const int b_off = lr * WSS + 64 * wp.wc + lc;
  int st = 0;  // s % NSTAGE
  for (int s = 0; s < nsl; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    const int k0 = s * KS;
    if (s + NSTAGE - 1 < nsl) {  // into the stage slice s - 1 has left
      const int rest = Kp - k0 - (NSTAGE - 1) * KS;
      stage_slice(ws + (st == 0 ? NSTAGE - 1 : st - 1) * WSTAGE, b.B, b.ldb,
                  k0 + (NSTAGE - 1) * KS, rest < KS ? rest : KS, b.ncols, t);
    } else {
      cp_async_commit();
    }
    const bf16* wst = ws + st * WSTAGE + b_off;
    st = st == NSTAGE - 1 ? 0 : st + 1;
    if (nt <= 0) continue;
    const int nk = (Kp - k0 < KS ? Kp - k0 : KS) >> 4;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      if (kk >= nk) break;
      uint32_t a0[4], a1[4];
      ldmatrix_x4(a0, a_base + k0 + 16 * kk);
      ldmatrix_x4(a1, a_base + 16 * lda + k0 + 16 * kk);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (2 * np < nt) {
          uint32_t bb[4];  // B is [k][n] with n contiguous: transposed load
          ldmatrix_x4_trans(bb, wst + 16 * kk * WSS + 16 * np);
          mma_bf16(acc[0][2 * np], a0, bb[0], bb[1]);
          mma_bf16(acc[1][2 * np], a1, bb[0], bb[1]);
          mma_bf16(acc[0][2 * np + 1], a0, bb[2], bb[3]);
          mma_bf16(acc[1][2 * np + 1], a1, bb[2], bb[3]);
        }
      }
    }
  }
}

// K2's transposes are the unrounded f32 weights, each split into three bf16
// pieces hi = bf16(W), mid = bf16(W - hi), lo = bf16(W - hi - mid), whose
// sum is W (a 24-bit significand in three 8-bit ones; exact for |W| >=
// 2^-110, below that within 2^-134, bf16's subnormal grain).  gz is
// bf16-exact, so gz hi, gz mid and gz lo are exact products and three MMAs
// into one f32 accumulator form the products of the f32 W^T; only the order
// of the sums changes.  The split pack (pack_mma_split in ops/fused_mlp.py)
// stores every transposed matrix as 16-deep k-blocks [kb][piece][16][ncols]
// at 3x its pack_mma offset, so one staged slice of KS3 = 48 rows is one
// k-block with all three pieces: one cp.async stage, one barrier a k-block.
#define KS3 48
#define WSTAGE3 (KS3 * WSS)
#ifndef NSTAGE3
#define NSTAGE3 2        // split slices: one in flight behind the one at work
#endif

__device__ __forceinline__ void gemm_head_split(const GemmB& b, bf16* ws,
                                                int t) {
  const int nkb = b.Kp >> 4;
#pragma unroll
  for (int s = 0; s < NSTAGE3 - 1; ++s) {
    if (s < nkb)
      stage_slice<KS3>(ws + s * WSTAGE3, b.B, b.ldb, s * KS3, KS3, b.ncols, t);
    else
      cp_async_commit();
  }
}

// acc += A[64, Kp] @ (hi + mid + lo) with B the split pack [3 Kp, ncols]:
// mma_gemm's pipeline over k-blocks, NSTAGE3 stages; each k-block's A
// fragments meet the lo, mid and hi fragments in that order (the small
// pieces are summed before the large one), one piece at a time: unrolling
// the three spills registers and measured 0.7 ms slower per 65,536 rows of
// the SDF chain (H100, tools/prof_chain_kernels.py --variants).
__device__ __forceinline__ void mma_gemm_split(Acc& acc, const bf16* A,
                                               int lda, const GemmB& b,
                                               bf16* ws, int t,
                                               bool head_done = false) {
  const int lane = t & 31;
  const WarpPos wp(t);
  const int nt = wp.ntiles(b.ncols);
  const int nsl = b.Kp >> 4;
  if (!head_done) {
    __syncthreads();
    gemm_head_split(b, ws, t);
  }
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  const bf16* a_base = A + (32 * wp.wr + lr) * lda + lc;
  const int b_off = lr * WSS + 64 * wp.wc + lc;
  int st = 0;
  for (int s = 0; s < nsl; ++s) {
    cp_async_wait<NSTAGE3 - 2>();
    __syncthreads();
    if (s + NSTAGE3 - 1 < nsl)
      stage_slice<KS3>(ws + (st == 0 ? NSTAGE3 - 1 : st - 1) * WSTAGE3, b.B,
                       b.ldb, (s + NSTAGE3 - 1) * KS3, KS3, b.ncols, t);
    else
      cp_async_commit();
    const bf16* wst = ws + st * WSTAGE3 + b_off;
    st = st == NSTAGE3 - 1 ? 0 : st + 1;
    if (nt <= 0) continue;
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, a_base + 16 * s);
    ldmatrix_x4(a1, a_base + 16 * lda + 16 * s);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (2 * np >= nt) continue;
#ifdef PROF_SPLIT_UNROLLED
#pragma unroll
#else
#pragma unroll 1
#endif
      for (int piece = 2; piece >= 0; --piece) {
#ifdef PROF_SPLIT_SKIP
        if (piece == PROF_SPLIT_SKIP) continue;
#endif
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, wst + 16 * piece * WSS + 16 * np);
        mma_bf16(acc[0][2 * np], a0, bb[0], bb[1]);
        mma_bf16(acc[1][2 * np], a1, bb[0], bb[1]);
        mma_bf16(acc[0][2 * np + 1], a0, bb[2], bb[3]);
        mma_bf16(acc[1][2 * np + 1], a1, bb[2], bb[3]);
      }
    }
  }
}

__device__ __forceinline__ void st_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The epilogues that read or write global stashes work on the accumulators
// in "row layout": lanes lane and lane ^ 1 swap halves of every pair of
// n-tiles, after which a lane holds 4 CONSECUTIVE columns of a row,
//   x[0..3] = acc[mi][2 np][2 hf], [2 np][2 hf + 1], [2 np + 1][2 hf],
//             [2 np + 1][2 hf + 1]
// at row WarpPos::row(mi, hf) and column rcol(np), and the 4 lanes of a row
// cover 16 columns in a piece: 64 contiguous bytes of an f32 stash row, 32 of
// a bf16 one, a load or store.  In the MMA's own layout a lane holds 2
// columns and a warp's access touches 8 rows with 16 or 32 bytes each, twice
// as many instructions on half-used sectors; measured on the H100 each such
// access type cost 0.4 ms per 65,536 rows of the SDF chain.
__device__ __forceinline__ void acc_to_rows(Acc& acc, int nt, int lane) {
  const bool odd = lane & 1;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    if (2 * np >= nt) continue;  // warp-uniform
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float& a0 = acc[mi][2 * np][2 * hf];
        float& a1 = acc[mi][2 * np][2 * hf + 1];
        float& b0 = acc[mi][2 * np + 1][2 * hf];
        float& b1 = acc[mi][2 * np + 1][2 * hf + 1];
        // an even lane keeps its tile-2np pair and gets its neighbour's; an
        // odd lane keeps its tile-(2np+1) pair, behind its neighbour's
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
        if (odd) { a0 = r0; a1 = r1; }
        else { b0 = r0; b1 = r1; }
      }
  }
}

// first of the 4 columns a lane holds of n-tile pair np, in row layout
__device__ __forceinline__ int rcol(const WarpPos& wp, int np, int lane) {
  return 64 * wp.wc + 16 * np + 8 * (lane & 1) + 4 * ((lane >> 1) & 1);
}

__device__ __forceinline__ float4 ld_bf16x4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void st_bf16x4(bf16* p, float a, float b, float c,
                                          float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Rows of a bf16 tile in shared memory -> a stash layer (row stride wq <=
// 256, a multiple of 16), whole rows in 16-byte pieces: the values the tile
// holds for the next product are the ones the stash wants.
__device__ __forceinline__ void tile_to_stash(const bf16* tile, int ts,
                                              bf16* dst, int wq, long row0,
                                              int n, int t) {
  const int c = t & 31;
  if (c >= (wq >> 3)) return;
#pragma unroll
  for (int r = t >> 5; r < TR; r += NT / 32)
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * wq + c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * ts + c * 8);
}

// Column sums over the block's 64 rows of accumulators in row layout -> dst[c],
// c < w.  red: [2][MAXW] floats of shared memory.
__device__ __forceinline__ void rows_colsum(const Acc& acc, int ncols, int w,
                                            float* red, float* dst, int t) {
  const WarpPos wp(t);
  const int nt = wp.ntiles(ncols), lane = t & 31;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    if (2 * np >= nt) continue;  // warp-uniform
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ni = 2 * np + (i >> 1), e = i & 1;
      float s = (acc[0][ni][e] + acc[0][ni][e + 2]) +
                (acc[1][ni][e] + acc[1][ni][e + 2]);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (wp.g == 0) red[wp.wr * MAXW + rcol(wp, np, lane) + i] = s;
    }
  }
  __syncthreads();
  for (int c = t; c < w; c += NT) dst[c] = red[c] + red[MAXW + c];
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

// K4 pass 2 on the bf16 route.  The tile holds p_l (bf16-exact); the product
// q_{l-1} = s p_l W_h^T arrives in the accumulators, where the epilogue
// stores it unrounded (K5's q stash, f32) and turns it into p_{l-1} =
// round(q act'(a_{l-1})) for the tile.  j is summed in f32 shared memory.
// All stashes share the padded layout (layer base n * pstash, row stride outp).
__global__ void __launch_bounds__(NT, 2)
chain_jac_down_mma_kernel(const bf16* __restrict__ stash,
                          const bf16* __restrict__ WT,
                          const float* __restrict__ wl_h,
                          const float* __restrict__ wl_x,
                          float* __restrict__ jout, float* __restrict__ qst,
                          int n, Chain ch) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int E = ch.E, Ep = pad16(E);
  bf16* pb = reinterpret_cast<bf16*>(smem_mma);           // [TR][AS]
  bf16* ws = pb + TR * AS;                                // [NSTAGE][KS][WSS]
  float* js = reinterpret_cast<float*>(ws + NSTAGE * WSTAGE);  // [TR][Ep]
  const int t = threadIdx.x, lane = t & 31;
  const WarpPos wp(t);
  const long row0 = (long)blockIdx.x * TR;

  {
    const Layer& Ll = ch.l[ch.L - 1];
    const Layer& Lt = ch.l[ch.L - 2];
    const bf16* a = stash + (size_t)n * Lt.pstash;
    float* qs = qst ? qst + (size_t)n * Lt.pstash : nullptr;
    const int wq = Lt.outp;
    for (int idx = t; idx < TR * wq; idx += NT) {
      const int r = idx / wq, c = idx - r * wq;
      const long g = row0 + r;
      float q = 0.f, p = 0.f;
      if (c < Lt.out) {
        q = Ll.scale * wl_h[(size_t)c * Ll.out];
        if (g < n) p = q * dact_mma(Lt.act, __bfloat162float(a[g * wq + c]));
      }
      if (qs && g < n) qs[g * wq + c] = q;
      pb[r * AS + c] = __float2bfloat16_rn(p);
    }
    for (int idx = t; idx < TR * Ep; idx += NT) {
      const int c = idx % Ep;
      js[idx] = (wl_x && c < E) ? Ll.scale * wl_x[(size_t)c * Ll.out] : 0.f;
    }
  }

  Acc acc;
  bool head = false;
  for (int l = ch.L - 2; l >= 0; --l) {
    const Layer& Ly = ch.l[l];
    if (Ly.wx >= 0) {
      zero_acc(acc);
      mma_gemm(acc, pb, AS, {WT + Ly.pwx, Ep, Ly.outp, Ep}, ws, t, head);
      head = false;
      const int nt = wp.ntiles(Ep);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        if (ni >= nt) continue;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            js[wp.row(mi, e >> 1) * Ep + wp.col(ni) + (e & 1)] +=
                Ly.scale * acc[mi][ni][e];
      }
    }
    if (l > 0)
      prefetch_rows(stash + (size_t)n * ch.l[l - 1].pstash, row0, n,
                    2 * Ly.inp, t);
    zero_acc(acc);
    mma_gemm(acc, pb, AS, {WT + Ly.pwh, Ly.inp, Ly.outp, Ly.inp}, ws, t, head);
    __syncthreads();  // every read of pb precedes its overwrite
    if (l > 0) {  // the layer below's first weight slices travel meanwhile
      const Layer& Ln = ch.l[l - 1];
      if (Ln.wx >= 0) gemm_head({WT + Ln.pwx, Ep, Ln.outp, Ep}, ws, t);
      else gemm_head({WT + Ln.pwh, Ln.inp, Ln.outp, Ln.inp}, ws, t);
      head = true;
    }
    const int nt = wp.ntiles(Ly.inp);
    if (l == 0) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        if (ni >= nt) continue;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            js[wp.row(mi, e >> 1) * Ep + wp.col(ni) + (e & 1)] +=
                acc[mi][ni][e] * Ly.scale;
      }
      break;
    }
    const Layer& Lb = ch.l[l - 1];  // Lb.out == Ly.in, Lb.outp == Ly.inp
    const int w = Lb.out, wq = Lb.outp;
    const bf16* a = stash + (size_t)n * Lb.pstash;
    float* qs = qst ? qst + (size_t)n * Lb.pstash : nullptr;
    acc_to_rows(acc, nt, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (2 * np >= nt) continue;
      const int c = rcol(wp, np, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = wp.row(mi, hf);
          const long g = row0 + r;
          const float q0 = acc[mi][2 * np][2 * hf] * Ly.scale;
          const float q1 = acc[mi][2 * np][2 * hf + 1] * Ly.scale;
          const float q2 = acc[mi][2 * np + 1][2 * hf] * Ly.scale;
          const float q3 = acc[mi][2 * np + 1][2 * hf + 1] * Ly.scale;
          float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
          if (g < n) {
            const float4 av = ld_bf16x4(a + g * wq + c);
            if (c < w) p0 = q0 * dact_mma(Lb.act, av.x);
            if (c + 1 < w) p1 = q1 * dact_mma(Lb.act, av.y);
            if (c + 2 < w) p2 = q2 * dact_mma(Lb.act, av.z);
            if (c + 3 < w) p3 = q3 * dact_mma(Lb.act, av.w);
            if (qs)
              *reinterpret_cast<float4*>(qs + g * wq + c) =
                  make_float4(q0, q1, q2, q3);
          }
          st_bf16x4(pb + r * AS + c, p0, p1, p2, p3);
        }
    }
  }
  __syncthreads();
  for (int idx = t; idx < TR * E; idx += NT) {
    const int r = idx / E, c = idx - r * E;
    const long g = row0 + r;
    if (g < n) jout[g * E + c] = js[r * Ep + c];
  }
}

// K5 pass 3 on the bf16 route.  The tile holds the rounded qbar (bf16-exact;
// layer 0 reads the rounded gj tile itself); pbar arrives in the
// accumulators and the epilogue forms dbar = pbar q (f32 stash), p =
// round(q act') (bf16 stash of its own: q stays f32, so p cannot overwrite
// it), and the next qbar = round(pbar act'), which goes to the tile and from
// there, whole rows at a time, to its bf16 stash.  The top qbar stays
// unrounded: its column sums are taken from the accumulators.
__global__ void __launch_bounds__(NT, 2)
chain_jac_up_mma_kernel(const bf16* __restrict__ stash,
                        const float* __restrict__ qst,
                        const bf16* __restrict__ W,
                        const float* __restrict__ gj, float* __restrict__ dbar,
                        bf16* __restrict__ qbs, bf16* __restrict__ pst,
                        float* __restrict__ colp, int n, Chain ch) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int E = ch.E, Ep = pad16(E), ES = Ep + 8;
  bf16* qb = reinterpret_cast<bf16*>(smem_mma);  // [TR][AS]
  bf16* ws = qb + TR * AS;                       // [NSTAGE][KS][WSS]
  bf16* gjs = ws + NSTAGE * WSTAGE;              // [TR][ES]
  float* red = reinterpret_cast<float*>(gjs + TR * ES);  // [2][MAXW]
  const int t = threadIdx.x, lane = t & 31;
  const WarpPos wp(t);
  const long row0 = (long)blockIdx.x * TR;
  const int wtop = ch.l[ch.L - 2].out;
  float* cp = colp + (size_t)blockIdx.x * (wtop + E);

  for (int idx = t; idx < TR * Ep; idx += NT) {
    const int r = idx / Ep, c = idx - r * Ep;
    const long g = row0 + r;
    gjs[r * ES + c] =
        __float2bfloat16_rn((g < n && c < E) ? gj[g * E + c] : 0.f);
  }
  for (int c = t; c < E; c += NT) {
    float s = 0.f;
    for (int r = 0; r < TR; ++r)
      if (row0 + r < n) s += gj[(row0 + r) * E + c];
    cp[wtop + c] = s;
  }

  Acc acc;
  bool head = false;
  for (int l = 0; l < ch.L - 1; ++l) {
    const Layer& Ly = ch.l[l];
    const int w = Ly.out, wq = Ly.outp;
    const bool top = l == ch.L - 2;
    const size_t base = (size_t)n * Ly.pstash;
    prefetch_rows(qst + base, row0, n, 4 * wq, t);
    prefetch_rows(stash + base, row0, n, 2 * wq, t);
    zero_acc(acc);
    mma_gemm(acc, l == 0 ? gjs : qb, l == 0 ? ES : AS,
             {W + Ly.pwh, wq, Ly.inp, wq}, ws, t, head);
    if (Ly.wx >= 0) mma_gemm(acc, gjs, ES, {W + Ly.pwx, wq, Ep, wq}, ws, t);
    __syncthreads();  // every read of qb precedes its overwrite
    head = !top;
    if (head) {  // the next layer's first weight slices travel meanwhile
      const Layer& Ln = ch.l[l + 1];
      gemm_head({W + Ln.pwh, Ln.outp, Ln.inp, Ln.outp}, ws, t);
    }
    const int nt = wp.ntiles(wq);
    acc_to_rows(acc, nt, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (2 * np >= nt) continue;
      const int c = rcol(wp, np, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = wp.row(mi, hf);
          const long g = row0 + r;
          float& x0 = acc[mi][2 * np][2 * hf];
          float& x1 = acc[mi][2 * np][2 * hf + 1];
          float& x2 = acc[mi][2 * np + 1][2 * hf];
          float& x3 = acc[mi][2 * np + 1][2 * hf + 1];
          const float pb0 = Ly.scale * x0, pb1 = Ly.scale * x1;
          const float pb2 = Ly.scale * x2, pb3 = Ly.scale * x3;
          float4 q = make_float4(0.f, 0.f, 0.f, 0.f), av = q;
          if (g < n) {
            q = *reinterpret_cast<const float4*>(qst + base + g * wq + c);
            av = ld_bf16x4(stash + base + g * wq + c);
          }
          const float d0 = c < w ? dact_mma(Ly.act, av.x) : 0.f;
          const float d1 = c + 1 < w ? dact_mma(Ly.act, av.y) : 0.f;
          const float d2 = c + 2 < w ? dact_mma(Ly.act, av.z) : 0.f;
          const float d3 = c + 3 < w ? dact_mma(Ly.act, av.w) : 0.f;
          x0 = pb0 * d0; x1 = pb1 * d1; x2 = pb2 * d2; x3 = pb3 * d3;
          if (g < n) {
            st_bf16x4(pst + base + g * wq + c, q.x * d0, q.y * d1, q.z * d2,
                      q.w * d3);
            *reinterpret_cast<float4*>(dbar + base + g * wq + c) =
                make_float4(pb0 * q.x, pb1 * q.y, pb2 * q.z, pb3 * q.w);
          }
          if (!top) st_bf16x4(qb + r * AS + c, x0, x1, x2, x3);
        }
    }
    if (top) {
      rows_colsum(acc, wq, wtop, red, cp, t);
    } else {
      __syncthreads();
      tile_to_stash(qb, AS, qbs + base, wq, row0, n, t);
    }
  }
}

// The data pass on the bf16 route, K5's pass 4 (SPLIT false) and K2's pass 2
// (SPLIT true), every product on the tensor cores.  The tile holds the
// rounded zs_l; hbar of the layer below arrives in the accumulators, where
// the epilogue forms zbar = hbar act' (+ dbar act'' for K5), its column sums
// (db partials) and the next zs = round(zbar s) (the tile, and from there a
// bf16 stash of its own: dbar is f32 and is only read).  a of the hidden
// layers comes from the bf16 stash.  K5's transposes are the bf16 pack of the
// rounded weights and its last layer is linear (K4/K5's condition); K2's are
// the split pack of the unrounded ones (mma_gemm_split), and its last layer
// may carry an activation, read off the forward's f32 output ylast as the
// f32 kernel reads it.  dx is summed 256 columns a product (the input may be
// 512 wide) into an f32 tile [64][Ep] in shared memory when the wrapper finds
// room for it beside two blocks an SM (DXS), and written out in whole
// rows at the end; otherwise (K2's wide inputs) it goes to device memory from
// the accumulators, the first product writing it and later ones adding to
// it, every element by the thread that owns it.  The accumulators' own
// layout makes that access slow (see acc_to_rows), so the tile is the rule.
template <bool SPLIT>
__device__ __forceinline__ void data_gemm(Acc& acc, const bf16* A, int lda,
                                          const GemmB& b, bf16* ws, int t,
                                          bool head_done) {
  if (SPLIT) mma_gemm_split(acc, A, lda, b, ws, t, head_done);
  else mma_gemm(acc, A, lda, b, ws, t, head_done);
}

template <bool SPLIT, bool DXS>
__global__ void __launch_bounds__(NT, 2)
chain_bwd_data_mma_kernel(const bf16* __restrict__ stash,
                          const bf16* __restrict__ WT,
                          const float* __restrict__ gin,
                          const float* __restrict__ ylast,
                          float* __restrict__ dx, bf16* __restrict__ zst,
                          const float* __restrict__ dbar,
                          float* __restrict__ dbp, int n, Chain ch) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int E = ch.E, Ep = pad16(E);
  const int wm = SPLIT ? 3 : 1;  // a matrix's offset in WT: wm x its pack offset
  const Layer& Ll = ch.l[ch.L - 1];
  const int TS = (Ll.outp > MAXW ? Ll.outp : MAXW) + 8;
  bf16* zb = reinterpret_cast<bf16*>(smem_mma);            // [TR][TS]
  bf16* ws = zb + TR * TS;         // [NSTAGE or NSTAGE3][KS or KS3][WSS]
  float* red = reinterpret_cast<float*>(ws + (SPLIT ? NSTAGE3 * WSTAGE3 : NSTAGE * WSTAGE));
  float* dxs = red + 2 * MAXW;                            // [TR][Ep] (DXS)
  const int t = threadIdx.x, lane = t & 31;
  const WarpPos wp(t);
  const long row0 = (long)blockIdx.x * TR;
  float* dbb = dbp + (size_t)blockIdx.x * ch.bsum;

  {  // the last layer: gz = g act'(y), db from it, zs = round(gz s)
    const int w = Ll.out, wq = Ll.outp;
    bf16* zs = zst + (size_t)n * Ll.pstash;
    for (int idx = t; idx < TR * wq; idx += NT) {
      const int r = idx / wq, c = idx - r * wq;
      const long g = row0 + r;
      float v = 0.f;
      if (g < n && c < w) {
        v = gin[g * w + c];
        if (SPLIT) v *= dact_from_a(Ll.act, ylast[g * w + c]);
      }
      if (Ll.scale != 1.f) v *= Ll.scale;
      const bf16 vb = __float2bfloat16_rn(v);
      zb[r * TS + c] = vb;
      if (g < n) zs[g * wq + c] = vb;
    }
    for (int c = t; c < w; c += NT) {
      float s = 0.f;
      for (int r = 0; r < TR; ++r) {
        const long g = row0 + r;
        if (g < n)
          s += SPLIT ? gin[g * w + c] * dact_from_a(Ll.act, ylast[g * w + c])
                     : gin[g * w + c];
      }
      dbb[Ll.b + c] = s;
    }
    if (DXS)
      for (int idx = t; idx < TR * Ep; idx += NT) dxs[idx] = 0.f;
  }

  Acc acc;
  bool head = false, dx_first = true;
  for (int l = ch.L - 1; l >= 0; --l) {
    const Layer& Ly = ch.l[l];
    // dx += zs @ W_x^T (skip) and, at layer 0, zs @ W_h^T: both [outp, Ep]
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 0 ? Ly.wx < 0 : l > 0) continue;
      const bf16* wt = WT + wm * (pass == 0 ? Ly.pwx : Ly.pwh);
      for (int cb = 0; cb < Ep; cb += MAXW) {
        const int ncols = Ep - cb < MAXW ? Ep - cb : MAXW;
        zero_acc(acc);
        data_gemm<SPLIT>(acc, zb, TS, {wt + cb, Ep, Ly.outp, ncols}, ws, t, head);
        head = false;
        const int nt = wp.ntiles(ncols);
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          if (ni >= nt) continue;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = wp.row(mi, e >> 1), c = cb + wp.col(ni) + (e & 1);
              if (DXS) {
                dxs[r * Ep + c] += acc[mi][ni][e];
                continue;
              }
              const long g = row0 + r;
              if (g >= n || c >= E) continue;
              float* p = dx + g * E + c;
              *p = dx_first ? acc[mi][ni][e] : *p + acc[mi][ni][e];
            }
        }
      }
      dx_first = false;
    }
    if (l == 0) break;
    const Layer& Lb = ch.l[l - 1];  // Lb.out == Ly.in, Lb.outp == Ly.inp
    const int w = Lb.out, wq = Lb.outp;
    const size_t base = (size_t)n * Lb.pstash;
    const bool sp = dbar && Lb.act == ACT_SP100;
    prefetch_rows(stash + base, row0, n, 2 * wq, t);
    if (sp) prefetch_rows(dbar + base, row0, n, 4 * wq, t);
    zero_acc(acc);
    data_gemm<SPLIT>(acc, zb, TS, {WT + wm * Ly.pwh, Ly.inp, Ly.outp, Ly.inp},
                     ws, t, head);
    __syncthreads();  // every read of zb precedes its overwrite
    {  // the first weight slices of the layer below's first product travel
       // while the epilogue runs: its skip's W_x^T, else its W_h^T
      const GemmB nb = Lb.wx >= 0
          ? GemmB{WT + wm * Lb.pwx, Ep, Lb.outp, Ep < MAXW ? Ep : MAXW}
          : GemmB{WT + wm * Lb.pwh, Lb.inp, Lb.outp, Lb.inp < MAXW ? Lb.inp : MAXW};
      if (SPLIT) gemm_head_split(nb, ws, t);
      else gemm_head(nb, ws, t);
    }
    head = true;
    const int nt = wp.ntiles(wq);
    acc_to_rows(acc, nt, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (2 * np >= nt) continue;
      const int c = rcol(wp, np, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const long g = row0 + wp.row(mi, hf);
          float& x0 = acc[mi][2 * np][2 * hf];
          float& x1 = acc[mi][2 * np][2 * hf + 1];
          float& x2 = acc[mi][2 * np + 1][2 * hf];
          float& x3 = acc[mi][2 * np + 1][2 * hf + 1];
          float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
          if (g < n) {
            const float4 av = ld_bf16x4(stash + base + g * wq + c);
            const float d0 = dact_mma(Lb.act, av.x), d1 = dact_mma(Lb.act, av.y);
            const float d2 = dact_mma(Lb.act, av.z), d3 = dact_mma(Lb.act, av.w);
            v0 = x0 * d0; v1 = x1 * d1; v2 = x2 * d2; v3 = x3 * d3;
            if (sp) {
              const float4 db =
                  *reinterpret_cast<const float4*>(dbar + base + g * wq + c);
              v0 += db.x * d2act_from_d(Lb.act, d0);
              v1 += db.y * d2act_from_d(Lb.act, d1);
              v2 += db.z * d2act_from_d(Lb.act, d2);
              v3 += db.w * d2act_from_d(Lb.act, d3);
            }
            if (c >= w) v0 = 0.f;
            if (c + 1 >= w) v1 = 0.f;
            if (c + 2 >= w) v2 = 0.f;
            if (c + 3 >= w) v3 = 0.f;
          }
          x0 = v0; x1 = v1; x2 = v2; x3 = v3;
        }
    }
    rows_colsum(acc, wq, w, red, dbb + Lb.b, t);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (2 * np >= nt) continue;
      const int c = rcol(wp, np, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float s = Lb.scale;
          st_bf16x4(zb + wp.row(mi, hf) * TS + c,
                    acc[mi][2 * np][2 * hf] * s, acc[mi][2 * np][2 * hf + 1] * s,
                    acc[mi][2 * np + 1][2 * hf] * s,
                    acc[mi][2 * np + 1][2 * hf + 1] * s);
        }
    }
    __syncthreads();
    tile_to_stash(zb, TS, zst + base, wq, row0, n, t);
  }
  if (DXS) {
    __syncthreads();
    for (int idx = t; idx < TR * E; idx += NT) {
      const int r = idx / E, c = idx - r * E;
      const long g = row0 + r;
      if (g < n) dx[g * E + c] = dxs[r * Ep + c];
    }
  }
}

// dW on the bf16 route, every weight of the chain in one launch.  A table row
// a tile (14 int64: for each of A1, B1, A2, B2 the index of its buffer in
// DwBuffers, -1 for none, and the element offset of the tile's first column
// in it; the tile's element offset in a split's partial buffer; lda, ldb,
// ldo; the tile's valid extents mext <= 128 and next <= 128) and a scale a
// tile; the table depends on the chain and n alone, the buffers' addresses
// are launch arguments.  Block (tile, split) forms
//   part[split][tile] = A1^T B1 + scale * A2^T B2     over the split's rows,
// both terms in the same accumulators (A2^T B2 first, then the scale, then
// A1^T B1).  A and B are row-major [rows, width] bf16 stashes, so both MMA
// operands are transposed ldmatrix loads of staged [64 rows][128] slices;
// rows past the split's end are zero-filled by cp.async.  Partials, not
// atomics: the sum over splits is one reduction outside, and the result is
// the same from run to run.
#define DT 128         // tile edge
#define DKS 64         // rows a staged slice
#define DS (DT + 8)
#define DSTAGE (DKS * DS)
#define DNSTAGE 3      // stages: two slices in flight behind the one at work

__device__ __forceinline__ void dw_stage(bf16* dst, const bf16* __restrict__ S,
                                         int lds, int ext, long r0, long r_end,
                                         int t) {
  // thread t copies the 16-byte piece t % 16 of rows t / 16, + 16, ...
  const int c = t & 15;
  if (c >= (ext >> 3)) return;
#pragma unroll
  for (int r = t >> 4; r < DKS; r += NT / 16) {
    const bool v = r0 + r < r_end;
    cp_async16(dst + r * DS + c * 8, v ? S + (r0 + r) * lds + c * 8 : S,
               v ? 16 : 0);
  }
}

#define DW_NBUF 6
#define DW_ROW 14
struct DwBuffers { const bf16* p[DW_NBUF]; };

__global__ void __launch_bounds__(NT, 2)
chain_dw_mma_kernel(const long long* __restrict__ table,
                    const float* __restrict__ scales, DwBuffers bufs,
                    float* __restrict__ part, long long part_stride, int n,
                    int rps) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* as = reinterpret_cast<bf16*>(smem_mma);  // [DNSTAGE][DKS][DS]
  bf16* bs = as + DNSTAGE * DSTAGE;              // [DNSTAGE][DKS][DS]
  const long long* tb = table + DW_ROW * (size_t)blockIdx.x;
  const int lda = (int)tb[9], ldb = (int)tb[10], ldo = (int)tb[11];
  const int mext = (int)tb[12], next = (int)tb[13];
  const float scale = scales[blockIdx.x];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int wr = warp >> 1, wc = warp & 1;  // 4 x 2 warps of [32 i][64 c]
  const long r_begin = (long)blockIdx.y * rps;
  long r_end = r_begin + rps;
  if (r_end > n) r_end = n;
  int nt = (next - 64 * wc) >> 3;
  nt = nt > 8 ? 8 : nt;
  const bool active = 32 * wr < mext && nt > 0;
  // A is [k][m] with m contiguous: matrices (k lo, m lo), (k lo, m hi),
  // (k hi, m lo), (k hi, m hi) give a0..a3
  const int a_off = ((lane & 7) + (lane >> 4) * 8) * DS + 32 * wr +
                    ((lane >> 3) & 1) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * DS + 64 * wc +
                    (lane >> 4) * 8;
  Acc acc;
  zero_acc(acc);
  for (int term = 2; term >= 1; --term) {
    const long long* op = tb + (term == 2 ? 4 : 0);
    if (op[0] < 0) continue;
    const bf16* A = nullptr;
    const bf16* B = nullptr;
#pragma unroll
    for (int i = 0; i < DW_NBUF; ++i) {  // no runtime index into a parameter
      if (op[0] == i) A = bufs.p[i] + op[1];
      if (op[2] == i) B = bufs.p[i] + op[3];
    }
    const int nsl = r_end > r_begin ? (int)((r_end - r_begin + DKS - 1) / DKS) : 0;
    __syncthreads();  // the last term's reads of the stages are done
    // slices s + 1 and s + 2 in flight behind slice s, a group a slice
    for (int s = 0; s < 2; ++s) {
      if (s < nsl) {
        dw_stage(as + s * DSTAGE, A, lda, mext, r_begin + s * DKS, r_end, t);
        dw_stage(bs + s * DSTAGE, B, ldb, next, r_begin + s * DKS, r_end, t);
      }
      cp_async_commit();
    }
    int st = 0;  // s % NSTAGE
    for (int s = 0; s < nsl; ++s) {
      cp_async_wait<1>();
      __syncthreads();
      if (s + 2 < nsl) {
        const long r0 = r_begin + (long)(s + 2) * DKS;
        const int sn = st == 0 ? 2 : st - 1;
        dw_stage(as + sn * DSTAGE, A, lda, mext, r0, r_end, t);
        dw_stage(bs + sn * DSTAGE, B, ldb, next, r0, r_end, t);
      }
      cp_async_commit();
      const int sc = st;
      st = st == DNSTAGE - 1 ? 0 : st + 1;
      if (!active) continue;
      const bf16* ast = as + sc * DSTAGE + a_off;
      const bf16* bst = bs + sc * DSTAGE + b_off;
#pragma unroll
      for (int kk = 0; kk < DKS / 16; ++kk) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4_trans(a0, ast + 16 * kk * DS);
        ldmatrix_x4_trans(a1, ast + 16 * kk * DS + 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (2 * np < nt) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, bst + 16 * kk * DS + 16 * np);
            mma_bf16(acc[0][2 * np], a0, b[0], b[1]);
            mma_bf16(acc[1][2 * np], a1, b[0], b[1]);
            mma_bf16(acc[0][2 * np + 1], a0, b[2], b[3]);
            mma_bf16(acc[1][2 * np + 1], a1, b[2], b[3]);
          }
        }
      }
    }
    if (term == 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] *= scale;
    }
  }
  float* p = part + (size_t)blockIdx.y * part_stride + tb[8];
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int c = 64 * wc + 8 * ni + t2;
    if (c >= next) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 32 * wr + 16 * mi + 8 * hf + g;
        if (i < mext)
          *reinterpret_cast<float2*>(p + (size_t)i * ldo + c) =
              make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
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

// bytes of the tensor-core kernels' common part: a tile of TR rows, tw wide,
// and the two weight stages
static size_t mma_smem(int tw) {
  return sizeof(bf16) * ((size_t)TR * (tw + 8) + NSTAGE * WSTAGE);
}

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

// K2's data pass (dbar null) and K5's (dbar given).  On the bf16 route both
// run on the tensor cores: K5's with WT the bf16 pack of the rounded
// transposes, K2's with WT the split pack of the f32 ones and the last
// activation from ylast; stash and gzs are bf16 in the padded layout.  On the
// f32 route both run the f32 FMA kernel (ylast unused).
extern "C" int nunerf_chain_bwd_data(const void* stash, const void* WT,
                                     const float* g, float* dx, void* gzs,
                                     const float* dbar, float* dbp,
                                     const float* ylast, int n,
                                     const int* meta, const float* scales,
                                     int L, int E, int round_bf16,
                                     void* stream) {
  Chain ch;
  int err = dbar ? build_jac_chain(&ch, meta, scales, L, E, round_bf16)
                 : build_chain(&ch, meta, scales, L, E, round_bf16);
  if (err) return err;
  const unsigned grid = (unsigned)((n + TR - 1) / TR);
  if (round_bf16) {
    const bool split = dbar == nullptr;
    if (split && !ylast) return (int)cudaErrorInvalidValue;
    const int lw = ch.l[L - 1].outp;
    const size_t base =
        sizeof(bf16) * ((size_t)TR * ((lw > MAXW ? lw : MAXW) + 8) +
                        (split ? NSTAGE3 * (size_t)WSTAGE3 : NSTAGE * (size_t)WSTAGE)) +
        sizeof(float) * 2 * MAXW;
    // the f32 dx tile goes into shared memory where two blocks still fit on
    // an SM (its 228 KB less 1 KB a block)
    const size_t with_dx = base + sizeof(float) * TR * (size_t)pad16(E);
#ifdef PROF_DX_GLOBAL
    const int dx_smem = 0;
#else
    const int dx_smem = with_dx <= (228 - 2) * 1024 / 2;
#endif
    const size_t smem = dx_smem ? with_dx : base;
    auto kernel = split ? (dx_smem ? chain_bwd_data_mma_kernel<true, true>
                                   : chain_bwd_data_mma_kernel<true, false>)
                        : (dx_smem ? chain_bwd_data_mma_kernel<false, true>
                                   : chain_bwd_data_mma_kernel<false, false>);
    err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
        (const bf16*)stash, (const bf16*)WT, g, split ? ylast : nullptr, dx,
        (bf16*)gzs, dbar, dbp, n, ch);
    return launch_check();
  }
  const size_t smem = (size_t)TR * (ch.gw + E) * sizeof(float);
  err = set_smem(chain_bwd_data_kernel, smem);
  if (err) return err;
  chain_bwd_data_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)stash, (const float*)WT, g, dx, (float*)gzs, dbar, dbp, n,
      ch);
  return launch_check();
}

extern "C" int nunerf_chain_jac_down(const void* stash, const void* WT,
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
  const unsigned grid = (unsigned)((n + TR - 1) / TR);
  if (round_bf16) {
    const size_t smem = mma_smem(MAXW) + sizeof(float) * TR * pad16(E);
    err = set_smem(chain_jac_down_mma_kernel, smem);
    if (err) return err;
    chain_jac_down_mma_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
        (const bf16*)stash, (const bf16*)WT, wl_h, wl_x, j, qst, n, ch);
    return launch_check();
  }
  const size_t smem = (size_t)TR * (ch.hw + E) * sizeof(float);
  err = set_smem(chain_jac_down_kernel, smem);
  if (err) return err;
  chain_jac_down_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)stash, (const float*)WT, wl_h, wl_x, j, qst, n, ch);
  return launch_check();
}

// pst: the bf16 route's p stash (the f32 route writes p over q and takes none)
extern "C" int nunerf_chain_jac_up(const void* stash, float* qst,
                                   const void* W, const float* gj,
                                   float* dbar, void* qbs, void* pst,
                                   float* colp, int n, const int* meta,
                                   const float* scales, int L, int E,
                                   int round_bf16, void* stream) {
  Chain ch;
  int err = build_jac_chain(&ch, meta, scales, L, E, round_bf16);
  if (err) return err;
  const unsigned grid = (unsigned)((n + TR - 1) / TR);
  if (round_bf16) {
    if (!pst) return (int)cudaErrorInvalidValue;
    const size_t smem = mma_smem(MAXW) + sizeof(bf16) * TR * (pad16(E) + 8) +
                        sizeof(float) * 2 * MAXW;
    err = set_smem(chain_jac_up_mma_kernel, smem);
    if (err) return err;
    chain_jac_up_mma_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
        (const bf16*)stash, qst, (const bf16*)W, gj, dbar, (bf16*)qbs,
        (bf16*)pst, colp, n, ch);
    return launch_check();
  }
  const size_t smem =
      (size_t)TR * ((ch.hw > E ? ch.hw : E) + E) * sizeof(float);
  err = set_smem(chain_jac_up_kernel, smem);
  if (err) return err;
  chain_jac_up_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)stash, qst, (const float*)W, gj, dbar, (float*)qbs, colp,
      n, ch);
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

// Every dW of a chain in one launch (the bf16 route): ntiles table rows,
// splits row ranges of rps rows (a multiple of 64), part [splits][part_stride].
extern "C" int nunerf_chain_dw_grouped(const long long* table,
                                       const float* tile_scales,
                                       const void* const* buffers,
                                       float* part, long long part_stride,
                                       int ntiles, int n, int splits, int rps,
                                       void* stream) {
  if (ntiles < 1 || splits < 1 || splits > 65535 || rps < 1 || rps % DKS)
    return (int)cudaErrorInvalidValue;
  DwBuffers bufs;
  for (int i = 0; i < DW_NBUF; ++i) bufs.p[i] = (const bf16*)buffers[i];
  const size_t smem = sizeof(bf16) * 2 * DNSTAGE * DSTAGE;
  int err = set_smem(chain_dw_mma_kernel, smem);
  if (err) return err;
  dim3 grid(ntiles, splits);
  chain_dw_mma_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      table, tile_scales, bufs, part, part_stride, n, rps);
  return launch_check();
}

extern "C" const char* nunerf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
