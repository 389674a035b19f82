// The backward passes of the chain kernels on the bf16 route, for Hopper:
// K2's and K5's data pass, K4's and K5's J-pass and K5's reverse J-pass as
// persistent wgmma chain walks, and every dW of a chain as one wgmma GEMM
// fed by TMA.  Included by fused_mlp.cu after K1's forward, whose pieces
// (the ring, the descriptors, the operand tiles) they share.
//
// Replaces, with chain_fwd_wgmma_kernel as pass 1 of each, the Pallas
// kernels _make_bwd_kernel (K2), _jac_fwd_kernel (K4) and
// _make_jac_bwd_kernel (K5) of nunerf_tpu/ops/fused_mlp.py on the bf16
// route.  The TPU kernels keep a tile's stashes in VMEM across their sweeps;
// here a 64-row tile's bf16 h stash of the SDF chain alone is 258 KB, more
// than a block's shared memory, and wgmma takes 64 rows, so the passes stay
// separate and carry their stashes through device memory.  What bounds each
// pass is then those bytes (K2 at 65,536 rows about 1.33 GB, 0.40 ms at
// 3.35 TB/s; K5 at 131,072 rows about 10.2 GB, 3.04 ms) and the epilogues
// that read and write them, not the products (0.18 and 0.78 ms at the bf16
// peak).  The design goes after both:
//
// * chain_bwd_wgmma_kernel<PASS>: the forward's skeleton (persistent, one CTA
//   an SM walking 128-row tile pairs, two warpgroups a 64-row tile each
//   taking half of every product's columns, the tile in a 128-byte-swizzled
//   shared operand tile, the weights streamed once a tile pair by 1-D bulk
//   copies through the mbarrier ring whose last reader starts the next copy)
//   with a walk and an epilogue a pass:
//     BW_DATA  (K2's pass 2 with SPLIT, K5's pass 4): the tile holds the
//              rounded zs_l; hbar = zs_l W_h^T arrives in the accumulators and
//              the epilogue forms zbar = hbar act'(a) (+ dbar act'' for K5),
//              its column sums (the db partials of the tile) and the next
//              zs = round(zbar s), into the tile and the zs stash.  The
//              products with W_x^T and, at layer 0, W_h^T go to dx.
//     BW_JDOWN (K4's and K5's pass 2): the tile holds p_l; q = s p_l W_h^T
//              arrives in the accumulators, is stored unrounded (K5's f32 q
//              stash) and becomes p = round(q act'(a)) in the tile; the
//              products with W_x^T and at layer 0 go to j.
//     BW_JUP   (K5's pass 3): the forward's walk over every layer but the
//              last, the rounded gj in x0's place: pbar arrives in the
//              accumulators; the epilogue writes dbar = pbar q (f32), p =
//              round(q act') and the next qbar = round(pbar act') (tile and
//              stash); the top qbar stays unrounded and gives its column sums.
//   The transposed walks read ``pack_wgmma_t`` (ops/fused_mlp.py): each W^T
//   laid in pack_wgmma's K-major slices, in the walk's order.  A K-major pack
//   of W^T and not the forward pack read through the descriptor's transpose
//   bit, because K2 multiplies by the three bf16 pieces of the f32 W^T
//   (below) and K5 by the rounded W^T: both are packs of their own anyway,
//   built once a call, and the K-major slices keep the forward's copies,
//   descriptors and epilogue addressing.
//   The epilogues' stash traffic goes by TMA where it can, in the operand
//   tile's own layout: once a step's products have read the A tile, the
//   tile's rows of the activations a come into it (2-D tensor copies of the
//   stash layer, 64 x 64 boxes with the 128-byte swizzle), and each thread
//   writes its outputs over the pairs it read; the bf16 output the next
//   product reads (zs, p, qbar) then leaves the tile for its stash by TMA
//   stores.  The f32 stashes (q, dbar) are read and written by the threads,
//   in 32-byte row pieces a lane quad; every input of an epilogue is asked
//   into L2 by one bulk prefetch of the tile's rows when its products start.
//   K5's J-pass, whose tile holds p = round(q act'), stashes p for the dW;
//   its reverse needs q only for dbar.
//   Rows past n go through every product (every warpgroup walks the whole
//   ring) and are masked in the epilogues: rows are independent in every
//   product of these passes, so their values never reach a stored row.
//   db and the top qbar's column sums are per 64-row tile partials summed in
//   a fixed order (warp shuffles, then the tile's four warps through shared
//   memory): the result is the same from run to run.
// * K2's split: its data pass multiplies the rounded gz by the UNROUNDED f32
//   W^T, as the TPU kernel does.  Each f32 weight is the exact sum of three
//   bf16 pieces hi = bf16(W), mid = bf16(W - hi), lo = bf16(W - hi - mid)
//   (a 24-bit significand in three 8-bit ones; exact for |W| >= 2^-110,
//   within 2^-134 below).  gz is bf16-exact, so gz lo, gz mid and gz hi are
//   exact products in f32, and three wgmma groups a 64-deep step, lo, mid,
//   then hi, one slice each, into the same f32 accumulators form the
//   products of the f32 W^T summed in another order: every 16-deep k-step of
//   a piece sums its exact products in the tensor core's own order, the
//   pieces go small first, and only the f32 roundings of those sums differ
//   from an f32 product's (data_pass_errors holds them to 1e-5).  Where a
//   row of gz has one nonzero entry (split_probe), each of its sums holds one
//   product: gz lo + gz mid is exact (their significands do not overlap),
//   and + gz hi gives gz W, exact in f32; so dx is the f32 weights to the
//   last bit, and a dropped piece shows by many units (split_probe_units).
// * chain_dw_wgmma_kernel: every dW of a chunk, one GEMM over a work table of
//   [128, 128] output tiles x row splits, each part[split][tile] = A1^T B1 +
//   scale A2^T B2 (K5's second term s qbar^T p first, then the scale, then
//   h_prev^T zs).  A and B are row-major [rows, width] bf16 stashes, so both
//   wgmma operands are MN-major (the transpose bits), read from 64 x 64 TMA
//   boxes with the 128-byte swizzle.  One producer thread issues the boxes
//   of the CTA's whole walk into a ring of 32 KB stages (full barriers count
//   the bytes, empty barriers the two consumer warpgroups); the consumers
//   take 64 output rows each, m64n128k16 (a tile at most 64 rows wide
//   leaves the second one idle, one at most 64 columns wide takes m64n64k16,
//   and either loads one box of that operand).  Persistent CTAs walk the (tile,
//   split) list on a static stride, sibling tiles of a split side by side so
//   that they share their operands in L2.  Per-split partials and one sum
//   outside: no atomics, the result the same from run to run.  Rows past n
//   and columns past a stash's width come in as TMA's zero fill.
//
// Switches for timing alone, as K1's (set by tools/prof_chain_kernels.py
// --variants; such a build computes nothing right): PROF_NO_WGMMA leaves the
// products out, PROF_NO_BULK the weight copies, the epilogues' TMA loads
// and stores and the L2 prefetches (and the dW's TMA boxes), PROF_NO_ACT the
// epilogues' activation math.  One switch
// plants a fault, for tools/prof_chain_kernels.py --split-faults alone:
// PROF_SPLIT_SKIP=p leaves piece p of K2's split out (2: lo, 1: mid).

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda

enum { BW_DATA = 0, BW_JDOWN = 1, BW_JUP = 2 };
enum { STEP_HIDDEN = 0, STEP_OUT = 1, STEP_OUT_FIRST = 2 };

#define BW_MAXSTEPS 64
#define BW_RED_BYTES (4 * 4 * 128 * 4)  // column sums: [warpgroup][warp][128]
#define BW_INIT_FLOATS MAXW             // j's seed (the J-pass)
#define BW_META_BYTES ((12 * WG_MAXST + 7) & ~7)  // the ring's barriers and counters

struct BwStep {
  short layer;  // the layer whose weights the step multiplies by
  short c0;     // first output column of its block
  short bw;     // the block's wgmma width
  short nsh;    // slices against the A tile (the x tile for the reverse
                // J-pass's layer 0)
  short nsx;    // slices against the x tile (the reverse J-pass's skips)
  short kind;   // STEP_HIDDEN, or STEP_OUT(_FIRST): into dx or j
  int slice0;   // its first slice in the walk
  int byte0;    // that slice's byte offset in the pack
};

struct BwPlan {
  int pairs;    // 128-row tile pairs
  int stages;   // ring depth
  int aslabs;   // 64-wide slabs of the A tile (zs, p or qbar)
  int xslabs;   // of the x tile (the reverse J-pass's rounded gj), 0 else
  int alias;    // the reverse J-pass's A tile is its x tile
  int pieces;   // slices a 64-deep step: 3 with K2's split, else 1
  int nsteps, nsl;
  BwStep st[BW_MAXSTEPS];
};

struct BwPtrs {
  const bf16* W;       // the walk's pack
  const float* g;      // DATA: the cotangent of y [n][out_L]; JUP: gj [n][E]
  const float* ylast;  // DATA with the split: the forward's f32 y
  const bf16* h;       // the forward's activation stash
  float* out;          // DATA: dx [n][E]; JDOWN: j [n][E]
  bf16* zst;           // the stash the A tile goes to: DATA zs, JDOWN (K5) p,
                       // JUP qbar
  const float* dbar;   // DATA (K5): the dbar stash
  float* q;            // JDOWN: the q stash written (K5; null for K4); JUP: read
  float* dbo;          // JUP: the dbar stash written
  float* part;         // DATA: db partials [tiles][bsum]; JUP: [tiles][wtop + E]
  const float* wl_h;   // JDOWN: the last W_h, f32 (its column 0 seeds q)
  const float* wl_x;   // JDOWN: the last W_x, f32 (seeds j), or null
};

__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
#ifndef PROF_NO_BULK
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(bytes)
               : "memory");
#endif
}

__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c, int r, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// start the copy of slice q (< total) of the walk into stage st
__device__ __forceinline__ void bw_fill(const Ring& rg, const BwPlan& plan,
                                        const bf16* W, int q, int st) {
  const int s = q % plan.nsl;
  int i = 0;
  while (i + 1 < plan.nsteps && plan.st[i + 1].slice0 <= s) ++i;
  const uint32_t len = (uint32_t)plan.st[i].bw * 128;
  bulk_g2s(rg.base + st * WG_STAGE,
           reinterpret_cast<const unsigned char*>(W) + plan.st[i].byte0 +
               (size_t)(s - plan.st[i].slice0) * len,
           len, rg.meta + 8 * st);
}

__device__ __forceinline__ void bw_release(const Ring& rg, const BwPlan& plan,
                                           const bf16* W, int st, int q,
                                           bool leader) {
  if (leader && (atom_add_shared(rg.meta + WG_META_CNT + 4 * st, 1) & 3) == 3 &&
      q + plan.stages < rg.total)
    bw_fill(rg, plan, W, q + plan.stages, st);
}

// One step's products for a warpgroup, as block_products: nsh slices against
// a_tile, then nsx against x_tile, each slice's 4 steps one group waited for
// at once, then the slice released.  With the split a slice triple (lo, mid,
// hi) shares one slab of the A tile.  (A triple as one group, waited for
// once, measured slower on the H100.)
template <int M>
__device__ __forceinline__ void bw_products(float (&acc)[M / 2],
                                            uint32_t a_tile, uint32_t x_tile,
                                            int nsh, int nsx, int pieces,
                                            uint32_t b_off, Ring& rg,
                                            const BwPlan& plan, const bf16* W,
                                            bool leader) {
  int sd = 0;
  for (int part = 0; part < 2; ++part) {
    const int ns = part == 0 ? nsh : nsx;
    const uint32_t tile = part == 0 ? a_tile : x_tile;
    for (int s = 0; s < ns; ++s) {
      mbar_wait(rg.meta + 8 * rg.stage, rg.phase);
      const int slab = pieces == 3 ? s / 3 : s;
      const uint64_t da = sw128_desc(tile + slab * WG_SLAB);
      const uint64_t db = sw128_desc(rg.base + rg.stage * WG_STAGE + b_off);
      bool skip = false;
#ifdef PROF_SPLIT_SKIP
      // piece p (0 hi, 1 mid, 2 lo) is slice 2 - p of its triple
      skip = pieces == 3 && s % 3 == 2 - PROF_SPLIT_SKIP;
#endif
      wg_fence();
#ifndef PROF_NO_WGMMA
      if (!skip) {
        WgSS<M>::mma(acc, da, db, sd);
#pragma unroll
        for (int kk = 1; kk < 4; ++kk)
          WgSS<M>::mma(acc, da + 2 * kk, db + 2 * kk, 1);
        sd = 1;
      }
#endif
      wg_commit();
      wg_wait<0>();
      keep(acc);
      bw_release(rg, plan, W, rg.stage, rg.q, leader);
      rg.next(plan.stages);
    }
  }
}

// The shared addresses of a thread's 8 swizzled chunks of its rows rt and
// rt + 8 in a tile (as hidden_epilogue), and the address of its bf16 pair
// (j, h) there.
template <int M>
__device__ __forceinline__ void tile_bases(uint32_t (&base)[8], uint32_t tile,
                                           int rt, int q, int c0) {
  const int g = rt & 7;
  const uint32_t row = tile + (rt >> 3) * 1024 + g * 128 + 4 * q;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    base[k] = row + (M >= 64 ? (c0 >> 6) * WG_SLAB + ((k ^ g) << 4) : 0);
}
template <int M>
__device__ __forceinline__ uint32_t tile_addr(const uint32_t (&base)[8],
                                              uint32_t tile, int rt, int j,
                                              int h, int c) {
  return M >= 64 ? base[j & 7] + (j >> 3) * WG_SLAB + h * 1024
                 : tile + tile_offset(rt + 8 * h, c);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
// columns zero_to .. 63 of the thread's rows (a block narrower than 64)
__device__ __forceinline__ void tile_zero_rest(uint32_t tile, int rt, int q,
                                               int zero_to) {
  for (int c = zero_to + 2 * q; c < 64; c += 8) {
    sts32(tile + tile_offset(rt, c), 0u);
    sts32(tile + tile_offset(rt + 8, c), 0u);
  }
}


// A pair's column sums over the warp's 16 rows (cs: the thread's two rows'
// sum), into red[warp][column] by the lanes of the first row.
__device__ __forceinline__ void colsum_pair(float cs0, float cs1, float* red,
                                            int col, int lane) {
  cs0 += __shfl_xor_sync(0xffffffffu, cs0, 4);
  cs1 += __shfl_xor_sync(0xffffffffu, cs1, 4);
  cs0 += __shfl_xor_sync(0xffffffffu, cs0, 8);
  cs1 += __shfl_xor_sync(0xffffffffu, cs1, 8);
  cs0 += __shfl_xor_sync(0xffffffffu, cs0, 16);
  cs1 += __shfl_xor_sync(0xffffffffu, cs1, 16);
  if (lane < 4) {
    red[col] = cs0;
    red[col + 1] = cs1;
  }
}

// What a thread of the backward walks keeps for the whole kernel.
struct BwThread {
  uint32_t at, xt;         // shared addresses: the A tile, the x tile
  uint32_t sbar;           // the barrier of the A tile's activation loads
  float* red;              // its warpgroup's column sums [4][128]
  uint32_t init;           // j's seed (the J-pass), a shared address
  int rt, half, rtile, q;  // row in the tile, column half, tile, lane % 4
  int w4, lane, wg;        // warp in the warpgroup, lane, warpgroup
  bool leader;             // the warpgroup's first thread
  bool issuer;             // the tile's thread that issues its TMA copies
};

// The epilogues read the activations a of their layer from the A tile,
// where the issuer's TMA loads put them once the products had read it (the
// stash's rows in the tile's swizzled layout, zeros past n and the width),
// and write their output over them, each thread the pairs it read.
//
// The data pass's hidden epilogue for the layer Lb below the step's layer:
// zbar = hbar act'(a) (+ dbar act''(a)) masked past Lb's width and past n,
// its column sums into red, zs = round(zbar s) into the tile (whence the
// tile goes to the zs stash by TMA).
template <int M, int ACT, bool DBAR>
__device__ __forceinline__ void data_epilogue(const float (&acc)[M / 2],
                                              const BwThread& th, int c0,
                                              const Layer& Lb, const float* db,
                                              long r, int n) {
  uint32_t base[8];
  tile_bases<M>(base, th.at, th.rt, th.q, c0);
  const int w = Lb.out, wq = Lb.outp;
  const float s = Lb.scale;
#pragma unroll
  for (int j = 0; j < M / 8; ++j) {
    const int c = c0 + 8 * j + 2 * th.q;
    float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long rr = r + 8 * h;
      const bool ok = rr < n && c < wq;
      const uint32_t addr = tile_addr<M>(base, th.at, th.rt, j, h, c);
      const float2 av = unpack_bf16x2(lds32(addr));  // a, landed in the tile
      float2 dv = make_float2(0.f, 0.f);
      if (DBAR && ok) dv = *reinterpret_cast<const float2*>(db + rr * wq + c);
#ifdef PROF_NO_ACT
      const float d0 = av.x, d1 = av.y;
#else
      const float d0 = dact_mma(ACT, av.x), d1 = dact_mma(ACT, av.y);
#endif
      float v0 = acc[4 * j + 2 * h] * d0, v1 = acc[4 * j + 2 * h + 1] * d1;
      if (DBAR) {
        v0 += dv.x * d2act_from_d(ACT, d0);
        v1 += dv.y * d2act_from_d(ACT, d1);
      }
      if (!ok || c >= w) v0 = 0.f;
      if (!ok || c + 1 >= w) v1 = 0.f;
      cs0 += v0;
      cs1 += v1;
      sts32(addr, pack_bf16x2(v0 * s, v1 * s));
    }
    colsum_pair(cs0, cs1, th.red + th.w4 * 128, 8 * j + 2 * th.q, th.lane);
  }
}

// The J-pass's hidden epilogue: q = s acc (stashed unrounded for K5), p =
// round(q act'(a)) of the layer Lb below into the tile (whence, for K5, the
// tile goes to the p stash by TMA).
template <int M, int ACT, bool QST>
__device__ __forceinline__ void jdown_epilogue(const float (&acc)[M / 2],
                                               const BwThread& th, int c0,
                                               float s, const Layer& Lb,
                                               float* qs, long r, int n) {
  uint32_t base[8];
  tile_bases<M>(base, th.at, th.rt, th.q, c0);
  const int w = Lb.out, wq = Lb.outp;
#pragma unroll
  for (int j = 0; j < M / 8; ++j) {
    const int c = c0 + 8 * j + 2 * th.q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long rr = r + 8 * h;
      const bool ok = rr < n && c < wq;
      const float q0 = acc[4 * j + 2 * h] * s, q1 = acc[4 * j + 2 * h + 1] * s;
      const uint32_t addr = tile_addr<M>(base, th.at, th.rt, j, h, c);
      const float2 av = unpack_bf16x2(lds32(addr));  // a, landed in the tile
      if (QST && ok)
        *reinterpret_cast<float2*>(qs + rr * wq + c) = make_float2(q0, q1);
#ifdef PROF_NO_ACT
      float p0 = q0 * av.x, p1 = q1 * av.y;
#else
      float p0 = q0 * dact_mma(ACT, av.x), p1 = q1 * dact_mma(ACT, av.y);
#endif
      if (!ok || c >= w) p0 = 0.f;
      if (!ok || c + 1 >= w) p1 = 0.f;
      sts32(addr, pack_bf16x2(p0, p1));
    }
  }
}

// The reverse J-pass's epilogue of layer Ly: pbar = s acc; dbar = pbar q,
// qbar = pbar act'(a): rounded into the tile (whence it goes to its stash by
// TMA), or (TOP) unrounded into the column sums.  p = round(q act') is the
// J-pass's, which K5's J-pass stashes.
template <int M, int ACT, bool TOP>
__device__ __forceinline__ void jup_epilogue(const float (&acc)[M / 2],
                                             const BwThread& th, int c0,
                                             const Layer& Ly, const float* qs,
                                             float* dbo, long r, int n) {
  uint32_t base[8];
  tile_bases<M>(base, th.at, th.rt, th.q, c0);
  const int w = Ly.out, wq = Ly.outp;
  const float s = Ly.scale;
#pragma unroll
  for (int j = 0; j < M / 8; ++j) {
    const int c = c0 + 8 * j + 2 * th.q;
    float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long rr = r + 8 * h;
      const bool ok = rr < n && c < wq;
      const float pb0 = acc[4 * j + 2 * h] * s, pb1 = acc[4 * j + 2 * h + 1] * s;
      const uint32_t addr = tile_addr<M>(base, th.at, th.rt, j, h, c);
      const float2 av = unpack_bf16x2(lds32(addr));  // a, landed in the tile
      if (ok) {
        const float2 qv = *reinterpret_cast<const float2*>(qs + rr * wq + c);
        *reinterpret_cast<float2*>(dbo + rr * wq + c) = make_float2(pb0 * qv.x, pb1 * qv.y);
      }
#ifdef PROF_NO_ACT
      float d0 = av.x, d1 = av.y;
#else
      float d0 = dact_mma(ACT, av.x), d1 = dact_mma(ACT, av.y);
#endif
      if (!ok || c >= w) d0 = 0.f;
      if (!ok || c + 1 >= w) d1 = 0.f;
      const float x0 = pb0 * d0, x1 = pb1 * d1;
      if (TOP) {
        cs0 += x0;
        cs1 += x1;
      } else {
        sts32(addr, pack_bf16x2(x0, x1));
      }
    }
    if (TOP) colsum_pair(cs0, cs1, th.red + th.w4 * 128, 8 * j + 2 * th.q, th.lane);
  }
}

// A product into dx or j ([n][E] f32): acc scale (+ the seed, or the value
// already there), columns below E, rows below n.
template <int M, bool SEED>
__device__ __forceinline__ void out_epilogue(const float (&acc)[M / 2],
                                             int c0, float scale, float* out,
                                             int E, long r, int n, int q,
                                             bool first, uint32_t init) {
#pragma unroll
  for (int j = 0; j < M / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + 2 * q + e;
      if (c >= E) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r + 8 * h >= n) continue;
        float* p = out + (r + 8 * h) * E + c;
        const float v = scale == 1.f ? acc[4 * j + 2 * h + e]
                                     : acc[4 * j + 2 * h + e] * scale;
        if (first)
          *p = SEED ? v + ldsf(init + 4 * c) : v;
        else
          *p += v;
      }
    }
}

// The column sums a warpgroup left in red (its half of the block, M
// columns from c0) -> dst[c] for c < w: the tile's four warps in order.
template <int M>
__device__ __forceinline__ void colsum_out(const BwThread& th, int c0, int w,
                                           float* dst, bool store) {
  bar_sync(3 + th.wg, 128);  // the warpgroup's sums are in red
  const int tl = threadIdx.x & 127;
  if (store && tl < M && c0 + tl < w)
    dst[c0 + tl] = ((th.red[tl] + th.red[128 + tl]) + th.red[256 + tl]) +
                   th.red[384 + tl];
}

// The tensor maps of a walk: the activation stash's hidden layers (the
// epilogues' a, TMA loads into the staging tile) and the stash the A tile
// goes to (the data pass's zs, K5's J-pass's p, the reverse J-pass's qbar),
// each layer [n, outp] bf16 in 64 x 64 boxes with the 128-byte swizzle.
struct BwMaps {
  CUtensorMap a[MAXL];
  CUtensorMap out[MAXL];
};

__device__ __forceinline__ void tma_store_box(const CUtensorMap* map,
                                              uint32_t src, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c), "r"(r), "r"(src)
      : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// The issuer's store of the A tile's first slabs (the layer's outp columns)
// to its stash layer; rows past n and columns past outp are not written.
__device__ __forceinline__ void tile_to_stash_tma(const CUtensorMap* map,
                                                  uint32_t tile, int outp,
                                                  long row0, int n) {
#ifndef PROF_NO_BULK
  if (row0 >= n) return;
  for (int s = 0; s * 64 < outp; ++s)
    tma_store_box(map, tile + s * WG_SLAB, 64 * s, (int)row0);
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
#endif
}

// The issuer's TMA loads of the tile's rows of a layer's activations into
// the A tile (zero past n and the width), counted on its barrier.
__device__ __forceinline__ void stage_a(const CUtensorMap* map, uint32_t dst,
                                        uint32_t bar, int outp, long row0,
                                        int n) {
  const int ns = (outp + 63) / 64;
#ifndef PROF_NO_BULK
  if (row0 < n) {
    mbar_expect_tx(bar, ns * WG_SLAB);
    for (int s = 0; s < ns; ++s) tma_box(dst + s * WG_SLAB, map, 64 * s, (int)row0, bar);
    return;
  }
#endif
  mbar_arrive(bar);
}

// Step i of the walk for a warpgroup: its products, then the step's
// epilogue.  row0: its tile's first row; r: the thread's first row; sphase:
// the parity of the tile's next activation loads.
template <int N, int PASS, bool FLAG>
__device__ __forceinline__ void run_bw_step(const BwMaps& maps,
                                            const Chain& ch,
                                            const BwPlan& plan,
                                            const BwPtrs& P, int n, int i,
                                            long row0, long r,
                                            const BwThread& th, Ring& rg,
                                            uint32_t& sphase) {
  constexpr int M = N / 2;
  float acc[M / 2];
  const BwStep& S = plan.st[i];
  const int l = S.layer;
  const int le = PASS == BW_JUP ? l : l - 1;  // the epilogue's layer
  if (th.issuer && S.kind == STEP_HIDDEN && row0 < n) {
    // the epilogue's stash inputs of the tile's rows into L2 while the
    // products run
    const Layer& Le = ch.l[le];
    const long rows = n - row0 < WG_ROWS ? n - row0 : WG_ROWS;
    const size_t at = (size_t)n * Le.pstash + (size_t)row0 * Le.outp;
    const uint32_t nb = (uint32_t)(rows * Le.outp);
    prefetch_l2(P.h + at, 2 * nb);
    if (PASS == BW_JUP) prefetch_l2(P.q + at, 4 * nb);
    if (PASS == BW_DATA && !FLAG && Le.act == ACT_SP100) prefetch_l2(P.dbar + at, 4 * nb);
  }
  const uint32_t a_tile = PASS == BW_JUP && l == 0 ? th.xt : th.at;
  bw_products<M>(acc, a_tile, th.xt, S.nsh, S.nsx, plan.pieces,
                 (uint32_t)(th.half * M * 128), rg, plan, P.W, th.leader);
  const int c0 = S.c0 + th.half * M;
  if (S.kind != STEP_HIDDEN) {
    const float scale = PASS == BW_JDOWN ? ch.l[l].scale : 1.f;
    out_epilogue<M, PASS == BW_JDOWN>(acc, c0, scale, P.out, ch.E, r, n, th.q,
                                      S.kind == STEP_OUT_FIRST, th.init);
    return;
  }
  const int tbar = 1 + th.rtile;  // the tile's two warpgroups
  const Layer& Le = ch.l[le];
  // the tile's last TMA store has read it
  if (th.issuer) bulk_wait_read<0>();
  bar_sync(tbar, 2 * 128);        // the tile is read: it may be overwritten
  if (th.issuer) stage_a(&maps.a[le], th.at, th.sbar, Le.outp, row0, n);
  mbar_wait(th.sbar, sphase);     // a has landed in the tile
  sphase ^= 1;
  const int tile_idx = (int)(row0 / WG_ROWS);
  const size_t base = (size_t)n * Le.pstash;
  const bool top = PASS == BW_JUP && l == ch.L - 2;
  if (PASS == BW_DATA) {
#define BW_DATA_EPI(ACT, DB) \
  data_epilogue<M, ACT, DB>(acc, th, c0, Le, DB ? P.dbar + base : nullptr, r, n)
    if (Le.act == ACT_SP100) {
      if (!FLAG) BW_DATA_EPI(ACT_SP100, true);  // K5: dbar act''(a)
      else BW_DATA_EPI(ACT_SP100, false);
    } else if (Le.act == ACT_RELU) {
      BW_DATA_EPI(ACT_RELU, false);
    } else {
      BW_DATA_EPI(ACT_NONE, false);
    }
#undef BW_DATA_EPI
    colsum_out<M>(th, c0, Le.out, P.part + (size_t)tile_idx * ch.bsum + Le.b,
                  row0 < n);
  } else if (PASS == BW_JDOWN) {
    float* qs = FLAG ? P.q + base : nullptr;
#define BW_JDOWN_EPI(ACT) \
  jdown_epilogue<M, ACT, FLAG>(acc, th, c0, ch.l[l].scale, Le, qs, r, n)
    if (Le.act == ACT_SP100) BW_JDOWN_EPI(ACT_SP100);
    else if (Le.act == ACT_RELU) BW_JDOWN_EPI(ACT_RELU);
    else BW_JDOWN_EPI(ACT_NONE);
#undef BW_JDOWN_EPI
  } else {
#define BW_JUP_EPI(ACT, TOP) \
  jup_epilogue<M, ACT, TOP>(acc, th, c0, Le, P.q + base, P.dbo + base, r, n)
    if (Le.act == ACT_SP100) {
      if (top) BW_JUP_EPI(ACT_SP100, true);
      else BW_JUP_EPI(ACT_SP100, false);
    } else if (Le.act == ACT_RELU) {
      if (top) BW_JUP_EPI(ACT_RELU, true);
      else BW_JUP_EPI(ACT_RELU, false);
    } else {
      if (top) BW_JUP_EPI(ACT_NONE, true);
      else BW_JUP_EPI(ACT_NONE, false);
    }
#undef BW_JUP_EPI
    if (top)
      colsum_out<M>(th, c0, Le.out, P.part + (size_t)tile_idx * (Le.out + ch.E),
                    row0 < n);
  }
  if (N < 64) tile_zero_rest(th.at, th.rt, th.q, th.half ? N : 64);
  fence_async_shared();
  bar_sync(tbar, 2 * 128);  // the whole tile, before the next step reads it
  // the tile to its stash: the data pass's zs, K5's J-pass's p, the reverse
  // J-pass's qbar below the top
  if (th.issuer && (PASS == BW_DATA || (PASS == BW_JDOWN && FLAG) ||
                    (PASS == BW_JUP && !top)))
    tile_to_stash_tma(&maps.out[le], th.at, Le.outp, row0, n);
}

// The tile's first values, by its 256 threads (tt), before the walk.
//   DATA:  zs of the last layer = round(g act'(y) s) (K2; K5: round(g s))
//          into the A tile (zeros past the width; the issuer stores it to the
//          zs stash), and its column sums into the db partials;
//   JDOWN: p of the last hidden layer = round(q act'(a)), q = the last
//          W_h's column 0 times its scale (stashed for K5, as is p);
//   JUP:   the rounded gj into the x tile, and gj's f32 column sums.
template <int PASS, bool FLAG>
__device__ __forceinline__ void bw_tile_start(const Chain& ch,
                                              const BwPlan& plan,
                                              const BwPtrs& P, int n,
                                              long row0, const BwThread& th,
                                              int tt) {
  const int warp8 = tt >> 5, lane = tt & 31;
  const int tile_idx = (int)(row0 / WG_ROWS);
  if (PASS == BW_DATA) {
    const Layer& Ll = ch.l[ch.L - 1];
    const int w = Ll.out;
    for (int c = 2 * lane; c < 64 * plan.aslabs; c += 64) {
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int rt = 8 * warp8 + rr;
        const long gr = row0 + rt;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = 0.f;
          if (gr < n && c + e < w) {
            v[e] = P.g[gr * w + c + e];
            if (FLAG) v[e] *= dact_from_a(Ll.act, P.ylast[gr * w + c + e]);
          }
          if (Ll.scale != 1.f) v[e] *= Ll.scale;
        }
        sts32(th.at + tile_offset(rt, c), pack_bf16x2(v[0], v[1]));
      }
    }
    if (row0 < n)
      for (int c = tt; c < w; c += 256) {
        float s = 0.f;
        for (int rt = 0; rt < WG_ROWS && row0 + rt < n; ++rt) {
          const long gr = row0 + rt;
          s += FLAG ? P.g[gr * w + c] * dact_from_a(Ll.act, P.ylast[gr * w + c])
                    : P.g[gr * w + c];
        }
        P.part[(size_t)tile_idx * ch.bsum + Ll.b + c] = s;
      }
  } else if (PASS == BW_JDOWN) {
    const Layer& Ll = ch.l[ch.L - 1];
    const Layer& Lt = ch.l[ch.L - 2];
    const int w = Lt.out, wq = Lt.outp;
    const size_t base = (size_t)n * Lt.pstash;
    for (int c = 2 * lane; c < 64 * plan.aslabs; c += 64) {
      float qv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        qv[e] = c + e < w ? Ll.scale * P.wl_h[(size_t)(c + e) * Ll.out] : 0.f;
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int rt = 8 * warp8 + rr;
        const long gr = row0 + rt;
        float p0 = 0.f, p1 = 0.f;
        if (gr < n && c < wq) {
          const float2 av = ld_bf16x2(P.h + base + gr * wq + c);
          p0 = qv[0] * dact_mma(Lt.act, av.x);
          p1 = qv[1] * dact_mma(Lt.act, av.y);
          if (FLAG)
            *reinterpret_cast<float2*>(P.q + base + gr * wq + c) = make_float2(qv[0], qv[1]);
        }
        sts32(th.at + tile_offset(rt, c), pack_bf16x2(p0, p1));
      }
    }
  } else {
    const int E = ch.E;
    for (int c = 2 * lane; c < 64 * plan.xslabs; c += 64) {
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int rt = 8 * warp8 + rr;
        const long gr = row0 + rt;
        const float v0 = gr < n && c < E ? P.g[gr * E + c] : 0.f;
        const float v1 = gr < n && c + 1 < E ? P.g[gr * E + c + 1] : 0.f;
        sts32(th.xt + tile_offset(rt, c), pack_bf16x2(v0, v1));
      }
    }
    const int wtop = ch.l[ch.L - 2].out;
    if (row0 < n)
      for (int c = tt; c < E; c += 256) {
        float s = 0.f;
        for (int rt = 0; rt < WG_ROWS && row0 + rt < n; ++rt)
          s += P.g[(row0 + rt) * E + c];
        P.part[(size_t)tile_idx * (wtop + E) + wtop + c] = s;
      }
  }
}

__host__ __device__ __forceinline__ size_t bw_tile_bytes(const BwPlan& p) {
  return (size_t)WG_SLAB *
         (p.alias ? (p.aslabs > p.xslabs ? p.aslabs : p.xslabs)
                  : p.aslabs + p.xslabs);
}
// the ring, both tiles' operand tiles, the column sums, j's seed, the
// ring's barriers and the tiles' barriers (8-byte aligned)
__host__ __device__ __forceinline__ size_t bw_smem_bytes(int stages,
                                                         size_t tile) {
  return 1024 + (size_t)stages * WG_STAGE + 2 * tile + BW_RED_BYTES +
         4 * BW_INIT_FLOATS + BW_META_BYTES + 16;
}

// FLAG: BW_DATA K2's split (its last activation from the forward's y, no
// dbar); BW_JDOWN K5's q and p stashes; BW_JUP none.
template <int PASS, bool FLAG>
__global__ void __launch_bounds__(WG_THREADS, 1)
chain_bwd_wgmma_kernel(const __grid_constant__ BwMaps maps, BwPtrs P, int n,
                       Chain ch, BwPlan plan) {
  extern __shared__ __align__(1024) unsigned char smem_bw[];
  const int S = plan.stages;
  const size_t tile = bw_tile_bytes(plan);
  const uint32_t raw = smem_u32(smem_bw);
  unsigned char* ring = smem_bw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* tiles = ring + (size_t)S * WG_STAGE;
  float* red = reinterpret_cast<float*>(tiles + 2 * tile);
  float* init = red + BW_RED_BYTES / 4;
  unsigned char* meta = reinterpret_cast<unsigned char*>(init + BW_INIT_FLOATS);
  const uint32_t sbars = smem_u32(meta) + BW_META_BYTES;  // a barrier a tile
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  const int turns = (plan.pairs - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;
  Ring rg{smem_u32(ring), smem_u32(meta), 0, 0, turns * plan.nsl, 0};
  if (t == 0) {
    int* cnt = reinterpret_cast<int*>(meta + WG_META_CNT);
    for (int s = 0; s < S; ++s) {
      mbar_init(rg.meta + 8 * s, 1);
      cnt[s] = 0;
    }
    mbar_init(sbars, 1);
    mbar_init(sbars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < S && q < rg.total; ++q) bw_fill(rg, plan, P.W, q, q);
  }
  // both tiles zeroed once: every value a product reads is finite
  for (size_t i = 4 * t; i < 2 * tile; i += 4 * WG_THREADS)
    *reinterpret_cast<uint32_t*>(tiles + i) = 0u;
  if (PASS == BW_JDOWN)
    for (int c = t; c < BW_INIT_FLOATS; c += WG_THREADS) {
      const Layer& Ll = ch.l[ch.L - 1];
      init[c] = P.wl_x && c < ch.E ? Ll.scale * P.wl_x[(size_t)c * Ll.out] : 0.f;
    }
  fence_async_shared();
  __syncthreads();

  BwThread th;
  th.wg = warp >> 2;
  th.rtile = warp >> 3;
  th.half = (warp >> 2) & 1;
  th.w4 = warp & 3;
  th.lane = lane;
  th.rt = 16 * (warp & 3) + (lane >> 2);
  th.q = lane & 3;
  th.leader = (t & 127) == 0;
  th.issuer = (t & 255) == 0;
  th.at = smem_u32(tiles + th.rtile * tile);
  th.xt = th.at + (plan.alias ? 0 : WG_SLAB * plan.aslabs);
  th.sbar = sbars + 8 * th.rtile;
  th.red = red + th.wg * 512;
  th.init = smem_u32(init);
  const int tbar = 1 + th.rtile;
  uint32_t sphase = 0;
  for (int k = 0; k < turns; ++k) {
    const long row0 = ((long)blockIdx.x + (long)k * gridDim.x) * WG_PAIR +
                      th.rtile * WG_ROWS;
    if (th.issuer) bulk_wait_read<0>();  // the last turn's stores have read the tile
    bar_sync(tbar, 2 * 128);  // the last turn's reads of the tile are done
    bw_tile_start<PASS, FLAG>(ch, plan, P, n, row0, th, t & 255);
    fence_async_shared();
    bar_sync(tbar, 2 * 128);
    if (th.issuer) {
      if (PASS == BW_DATA)
        tile_to_stash_tma(&maps.out[ch.L - 1], th.at, ch.l[ch.L - 1].outp, row0, n);
      if (PASS == BW_JDOWN && FLAG)
        tile_to_stash_tma(&maps.out[ch.L - 2], th.at, ch.l[ch.L - 2].outp, row0, n);
    }
    const long r = row0 + th.rt;
    for (int i = 0; i < plan.nsteps; ++i) {
#define BW_STEP(N) \
  run_bw_step<N, PASS, FLAG>(maps, ch, plan, P, n, i, row0, r, th, rg, sphase)
      switch (plan.st[i].bw) {
        case 16: BW_STEP(16); break;
        case 32: BW_STEP(32); break;
        case 64: BW_STEP(64); break;
        case 128: BW_STEP(128); break;
        default: BW_STEP(256); break;
      }
#undef BW_STEP
    }
  }
  if (th.issuer) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The walk of a pass, from the chain (``WgmmaTLayout`` and ``bwd_walk`` in
// ops/fused_mlp.py lay the same): the steps, their slices and their bytes,
// checked against the wrapper's counts; the tiles' slabs and the ring's
// depth from the shared memory left.
static int wg_width_host(int w) {
  return w <= 16 ? 16 : w <= 32 ? 32 : w <= 64 ? 64 : w <= 128 ? 128 : 256;
}

static int build_bw_plan(BwPlan* p, const Chain& ch, int pass, int split,
                         int n, int grid, int nsl, int nbytes) {
  const int L = ch.L, Ep = pad16(ch.E);
  int ns = 0, sl = 0, by = 0, aw = 0, xw = 0;
  unsigned written = 0;  // the column blocks of dx or j a product has written
  auto add = [&](int l, int c0, int bw, int nsh, int nsx, int kind) -> bool {
    if (ns >= BW_MAXSTEPS) return false;
    BwStep& s = p->st[ns++];
    s.layer = (short)l; s.c0 = (short)c0; s.bw = (short)bw;
    s.nsh = (short)nsh; s.nsx = (short)nsx; s.kind = (short)kind;
    s.slice0 = sl; s.byte0 = by;
    sl += nsh + nsx;
    by += (nsh + nsx) * bw * 128;
    return true;
  };
  p->pieces = split ? 3 : 1;
  if (pass == BW_JUP) {
    for (int l = 0; l < L - 1; ++l) {
      const Layer& y = ch.l[l];
      const int nsh = (y.inp + 63) / 64, nsx = y.wx >= 0 ? (Ep + 63) / 64 : 0;
      const int bw = wg_width_host(y.outp);
      if (!add(l, 0, bw, nsh, nsx, STEP_HIDDEN)) return (int)cudaErrorInvalidValue;
      if (l < L - 2 && bw > aw) aw = bw;
    }
    xw = Ep;
    p->alias = ch.x0_alias;
  } else {
    // the A tile holds the top's values, then every hidden step's block
    const int top = pass == BW_DATA ? L - 1 : L - 2;
    aw = ch.l[top].outp;
    for (int l = top; l >= 0; --l) {
      const Layer& y = ch.l[l];
      const int nk = (y.outp + 63) / 64 * p->pieces;
      for (int part = 0; part < 2; ++part) {
        const bool out = part == 0 || l == 0;
        if (part == 0 && y.wx < 0) continue;
        const int rows = part == 0 ? Ep : y.inp;
        if (out) {
          for (int c0 = 0; c0 < rows; c0 += MAXW) {
            const int w = wg_width_host(rows - c0 < MAXW ? rows - c0 : MAXW);
            const unsigned blk = 1u << (c0 / MAXW);
            if (!add(l, c0, w, nk, 0, written & blk ? STEP_OUT : STEP_OUT_FIRST))
              return (int)cudaErrorInvalidValue;
            written |= blk;
          }
        } else {
          const int bw = wg_width_host(rows);
          if (!add(l, 0, bw, nk, 0, STEP_HIDDEN)) return (int)cudaErrorInvalidValue;
          if (bw > aw) aw = bw;
        }
      }
    }
    p->alias = 0;
  }
  if (sl != nsl || by != nbytes) return (int)cudaErrorInvalidValue;
  p->nsteps = ns;
  p->nsl = sl;
  p->aslabs = (aw + 63) / 64;
  p->xslabs = (xw + 63) / 64;
  p->pairs = (n + WG_PAIR - 1) / WG_PAIR;
  if (grid < 1 || grid > p->pairs) return (int)cudaErrorInvalidValue;
  const size_t tile = bw_tile_bytes(*p);
  int S = WG_MAXST;
  while (S >= 2 && bw_smem_bytes(S, tile) > WG_SMEM_MAX) --S;
  if (S < 2) return (int)cudaErrorInvalidValue;
  p->stages = S;
  return 0;
}

template <int PASS, bool FLAG>
static int launch_bw(const BwMaps& maps, const BwPtrs& P, int n,
                     const Chain& ch, const BwPlan& plan, int grid,
                     cudaStream_t stream) {
  const size_t smem = bw_smem_bytes(plan.stages, bw_tile_bytes(plan));
  auto kernel = chain_bwd_wgmma_kernel<PASS, FLAG>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, WG_THREADS, smem, stream>>>(maps, P, n, ch, plan);
  return launch_check();
}

// ------------------------------------------------ dW: a wgmma GEMM fed by TMA

#define DW_MAXMAPS 64
#define DW_ROWW 12      // ints a table row
#define DW_THREADS 384  // a producer warpgroup (one thread at work), two consumers
#define DW_STAGE 32768  // A's two 64 x 64 boxes, then B's two
#define DW_MAXST 6
#define DW_BOX 8192

struct DwMaps {
  CUtensorMap m[DW_MAXMAPS];
};

// d[64, 128] (+)= a[64, 16] b[16, 128], both MN-major by descriptor
__device__ __forceinline__ void wgmma_m64n128_mn(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
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
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// d[64, 64] (+)= a[64, 16] b[16, 64]: a tile at most 64 columns wide
__device__ __forceinline__ void wgmma_m64n64_mn(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The descriptor of an MN-major operand in 128-byte-swizzled 64 x 64 boxes
// (TMA's CU_TENSOR_MAP_SWIZZLE_128B): rows of 64 MN elements (128 bytes)
// one K row each, 8-row groups 1024 bytes apart (the stride byte offset),
// the next 64 MN elements lbo bytes on (the leading byte offset); + 128 (in
// 16-byte units) is 16 K rows deeper.
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t saddr,
                                                  uint32_t lbo) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Work item w of the walk: tile w % ntiles of split w / ntiles; the CTA b
// takes w = b, b + G, ... (``dw_work`` in ops/fused_mlp.py).  A table row:
// for A1, B1, A2, B2 its tensor map (-1: none) and the first column of the
// tile in it; the tile's offset in a split's partials; their row stride; the
// tile's extents (<= 128).
__global__ void __launch_bounds__(DW_THREADS, 1)
chain_dw_wgmma_kernel(const __grid_constant__ DwMaps maps,
                      const int* __restrict__ table,
                      const float* __restrict__ scales,
                      float* __restrict__ part, long long part_stride,
                      int ntiles, int nwork, int n, int rps, int stages) {
  extern __shared__ __align__(1024) unsigned char smem_dw[];
  const uint32_t raw = smem_u32(smem_dw);
  const uint32_t ring = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t full = ring + stages * DW_STAGE, empty = full + 8 * DW_MAXST;
  const int t = threadIdx.x, warp = t >> 5;
  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int stage = 0;
  uint32_t phase = 0;
  if (warp < 4) {  // the producer
    if (t != 0) return;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
      const int* tb = table + DW_ROWW * (w % ntiles);
      const long rb = (long)(w / ntiles) * rps;
      const long re = rb + rps < n ? rb + rps : n;
      const int nsl = (int)((re - rb + 63) / 64);
      for (int term = 2; term >= 1; --term) {
        const int* op = tb + (term == 2 ? 4 : 0);
        if (op[0] < 0) continue;
        for (int s = 0; s < nsl; ++s) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t dst = ring + stage * DW_STAGE, bar = full + 8 * stage;
          const int row = (int)(rb + 64 * s);
#ifdef PROF_NO_BULK
          mbar_arrive(bar);
#else
          // a tile no more than 64 rows or columns wide takes one box of
          // that operand
          const bool m2 = tb[10] > 64, n2 = tb[11] > 64;
          mbar_expect_tx(bar, DW_BOX * (2 + m2 + n2));
          tma_box(dst, &maps.m[op[0]], op[1], row, bar);
          if (m2) tma_box(dst + DW_BOX, &maps.m[op[0]], op[1] + 64, row, bar);
          tma_box(dst + 2 * DW_BOX, &maps.m[op[2]], op[3], row, bar);
          if (n2) tma_box(dst + 3 * DW_BOX, &maps.m[op[2]], op[3] + 64, row, bar);
#endif
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  // the consumers: warpgroup cw takes the tile's output rows 64 cw ..
  const int cw = (warp >> 2) - 1, w4 = warp & 3, lane = t & 31;
  const bool leader = (t & 127) == 0;
  float acc[64];
  for (int w = blockIdx.x; w < nwork; w += gridDim.x) {
    const int tile = w % ntiles, split = w / ntiles;
    const int* tb = table + DW_ROWW * tile;
    const long rb = (long)split * rps;
    const long re = rb + rps < n ? rb + rps : n;
    const int nsl = (int)((re - rb + 63) / 64);
    // the second warpgroup idles on a tile of at most 64 rows; a tile of at
    // most 64 columns takes the narrower product
    const bool busy = cw == 0 || tb[10] > 64, wide = tb[11] > 64;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int term = 2; term >= 1; --term) {
      if (tb[term == 2 ? 4 : 0] < 0) continue;
      for (int s = 0; s < nsl; ++s) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t base = ring + stage * DW_STAGE;
        const uint64_t da = sw128_mn_desc(base + cw * DW_BOX, DW_BOX);
        const uint64_t db = sw128_mn_desc(base + 2 * DW_BOX, DW_BOX);
        wg_fence();
#ifndef PROF_NO_WGMMA
        if (busy && wide) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n128_mn(acc, da + 128 * kk, db + 128 * kk);
        } else if (busy) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64_mn(acc, da + 128 * kk, db + 128 * kk);
        }
#endif
        wg_commit();
        wg_wait<0>();
        keep(acc);
        if (leader) mbar_arrive(empty + 8 * stage);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (term == 2) {
        const float sc = scales[tile];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] *= sc;
      }
    }
    float* p = part + (size_t)split * part_stride + tb[8];
    const int ldo = tb[9], mext = tb[10], next = tb[11];
    const int g = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + q2;
      if (c >= next) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 64 * cw + 16 * w4 + g + 8 * h;
        if (i < mext)
          *reinterpret_cast<float2*>(p + (size_t)i * ldo + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point: the
// library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [rows, width] bf16 stash layer (row stride width) as 64 x 64 boxes with
// the 128-byte swizzle; rows past rows and columns past width read as zeros.
static int encode_box_map(CUtensorMap* m, const void* base, int rows,
                          int width) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
