// TV denoise, Chambolle dual ascent (skimage denoise_tv_chambolle /
// mdx.ops.tv.tv_chambolle_xla): step tau = 1/4, per-image weight,
// E = (sum d^2 + w * sum |grad out|) / HW, stop per image when
// |E_prev - E| < eps * E_0 or after max_iter iterations; the output is
// out_t = x + div p_{t-1}, t the image's iteration count, p_0 = 0.
//
// Replaces the TPU kernel mdx/ops/pallas_kernels.py tv_chambolle_tpu /
// _tv_kernel, which keeps one image's whole solve (x, out, p0, p1) in VMEM.
// That state is 3 MB at 512^2 and 48 MB at 2048^2: it fits neither one
// SM's 227 KB of shared memory nor, for a batch, the 50 MB L2, so the dual
// has to go through device memory between launches.  Bound: memory, unless
// each trip through device memory does several iterations.  The design is
// temporal blocking: a launch runs S = TV_S iterations in shared memory.
//   1. tv_blk_step_kernel: one block per 64 x 64 window, the owned
//      (64 - 2S)^2 tile plus an S-cell halo on each side.  It loads x (into
//      registers) and the dual p_a (into shared memory; zeros at a = 0 and
//      outside the image, which is the p = 0 above and left of the image
//      that the divergence reads), then runs m <= S steps in place, two
//      phases each: (i) out = x + div p on every cell still valid, into a
//      shared out buffer; (ii) the forward differences of out (0 at the
//      image's last row and column), the norm and the update of p0, p1 on
//      the image's cells (a cell's update reads its own p and out alone, so
//      p needs one buffer).  The valid region shrinks by one cell a step, so
//      after S steps the owned tile is exact.  Each step sums d^2 and
//      |grad out| over the owned cells in float64 (a fixed warp-shuffle tree,
//      then the warps in order) into partials [n, nblk, S, 2].  The block
//      writes the owned p_{a+m} into the other buffer of a ping-pong pair and
//      no out.  20 bytes a pixel a launch (x, p read; p written) plus the
//      halo's re-read: 5 bytes a pixel an iteration at S = 4, against 24 for
//      a launch per iteration.
//   2. tv_blk_finalize_kernel: one block per image.  Sums each step's
//      partials over the blocks in a fixed order (all sums float64, rounded
//      once to float32, as the plain version) and walks the m energies in
//      order with tv_chambolle_xla's stop rule (tv_stop_rule); it records
//      the launch's base a of every image active at its start.  An image
//      that stops keeps p_a in the launch's input buffer: later launches skip
//      it (their blocks return at once), so nothing overwrites that buffer.
//   3. tv_blk_rebuild_kernel, once after the loop: per image, p_a from
//      the buffer of the base recorded for it (launch a / S read buffer
//      (a / S) % 2), r = t - 1 - a in [0, S - 1] steps of the same device
//      function on the same window, then out = x + div p_{t-1} on the owned
//      tile.  Same arithmetic in the same order as the plain version under
//      --fmad=false, so the pixels are exact; the first count (p = 0) needs
//      no special case, since -(0 + 0) + 0 + 0 is 0.
// No float atomics, so the stop decisions are the same on every run.  The
// host reads the active flags once every 16 iterations; a launch for
// images that have all stopped returns at once.  S is the compile-time
// constant TV_S = 4, measured among 2, 4 and 8 on an H100 (PERF.md
// section 6): against s = 4, s = 2 took 3.1 % longer at 32 x 512^2 and
// 0.9 % less at 16 x 2048^2, and s = 8 took 24 % and 35 % longer (1.78x
// the cell-steps on 48^2 tiles); s = 4 runs half the launches of s = 2.
// The wrapper reads S from mdx_tv_blocked_steps.  Past the bytes the
// step is bound by its instructions (three IEEE divides and a sqrt per
// cell-step, kept for exactness): 3 blocks an SM (40 registers, a 12-byte
// spill) ran 6.5 % faster at 16 x 2048^2 than 2 (60 registers).  Shared
// memory is 3 x 64^2 floats plus S x 16 warps x 2 float64 sums, above the
// 48 KB a launch gets without cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// TPU kernel 12 (mdx/parallel/tv_sp.py _tv_sharded_banded, whose body is
// pallas_kernels.py _tv_band_step, one launch an iteration on a row band)
// is the same iteration on one row block, or one tile of a 2-D grid, of a
// spatially-sharded image (mdx_torch/parallel/tv_sp.py).  Here it runs on
// the same step body as the dense solve, temporally blocked in the same
// way: the windows are placed in global image coordinates (TvGeo: the
// global size, the block's origin in it), and a window's cells outside the
// block come from halo slabs (TvSlabs) of the neighbouring blocks, hw <= S
// rows above and below and hw columns left and right of the row-extended
// block (the corners come with the columns: rows are exchanged first, then
// the columns of the row-extended block, so no message goes diagonally).
// Cells outside the image are zeros and are never updated, as in the dense
// kernel, and the forward differences are 0 at the image's last row and
// column.  A launch of m <= hw steps needs nothing further away: the dual
// at a cell after a step depends on the dual within one cell of it, so the
// block's own cells are exact after m steps from a halo of m, and so are
// each step's energies over them.  Per launch of kernel 12:
//   1. tv_blk_step_kernel (the dense kernel's) on the block's windows with
//      the slabs of p_a (exchanged by the caller once a launch) and of x
//      (once a solve), writing the block's p_{a+m} and the partials;
//   2. tv_blk_rank_sums_kernel: the block's sums of each step, the
//      partials summed over the windows in a fixed order → [n, m, 2];
//   3. the caller adds those over the tile group (one all-reduce a launch)
//      and tv_blk_finalize_kernel walks the m global energies with the stop
//      rule (the dense finalize, fed with one "block": the global sums).
// After the loop tv_blk_rebuild_kernel rebuilds out from each image's base
// launch as in the dense solve; the slabs it reads are those of the
// image's buffer (the caller keeps a slab set per buffer of the ping-pong
// pair: a stopped image's dual and its neighbours' copies of it stay as
// they were, since stops are decided on global sums and every rank skips
// the image from then on).  A dense call is the case of no slabs and a
// block that is the whole image.  Bound: as the dense solve, 20 bytes a
// pixel a launch plus the slabs (5 an iteration at S = 4, against 24 for
// the launch an iteration the TPU kernel runs).
#include "common.cuh"

namespace {

constexpr int FIN_T = 256;

// An image's (sum d^2, sum |grad out|) from its blocks' partials, in a
// fixed order: block k's pair at pi[stride * k], pi[stride * k + 1].  Every
// thread of the block gets the sums.
__device__ __forceinline__ void tv_sum_partials(
        const double* __restrict__ pi, int nblk, int stride, double* sh,
        double& a, double& b) {
    a = 0.0;
    b = 0.0;
    for (int k = threadIdx.x; k < nblk; k += FIN_T) {
        a += pi[(size_t)stride * k];
        b += pi[(size_t)stride * k + 1];
    }
    a = mdx::block_sum<double, FIN_T>(a, sh);
    b = mdx::block_sum<double, FIN_T>(b, sh);
}

// The stop rule of tv_chambolle_xla on an image's global sums.
__device__ __forceinline__ void tv_stop_rule(
        int img, double a, double b, const float* __restrict__ weight,
        float* __restrict__ e0, float* __restrict__ e_prev,
        int* __restrict__ active, int* __restrict__ iters, int first,
        float eps, float size) {
    const float e = ((float)a + weight[img] * (float)b) / size;
    if (first) {
        e0[img] = e;
        e_prev[img] = e;
        iters[img] = 1;
        return;
    }
    iters[img] += 1;
    if (fabsf(e_prev[img] - e) >= eps * e0[img]) {
        e_prev[img] = e;
    } else {
        active[img] = 0;
    }
}

// d = -(p0 + p1) + (p0 above) + (p1 left), in the plain version's order
__device__ __forceinline__ float tv_dval(float p0c, float p1c, float above,
                                         float left) {
    float d = -(p0c + p1c);
    d = d + above;
    d = d + left;
    return d;
}

constexpr int TV_S = 4;                 // iterations a launch (see above)
constexpr int BW = 64;                  // window edge: tile + S-cell halos
constexpr int BT = BW - 2 * TV_S;       // owned tile edge
constexpr int BX = 32, BY = 16;         // block of 32 x 16 threads
constexpr int BNT = BX * BY;
constexpr int BNWARP = BNT / 32;
constexpr int BR = BW / BY;             // window rows a thread covers
constexpr int BC = BW / BX;             // window columns a thread covers

// shared memory of the step and rebuild kernels: p0, p1, out and the
// warps' float64 sums of each step
constexpr size_t BSMEM = 3 * BW * BW * sizeof(float)
                         + (size_t)TV_S * BNWARP * 2 * sizeof(double);

// The block the kernels work on: its extents h x w, the image's gh x gw,
// the block's first row and column in the image, and the width hw of the
// halo slabs.  The dense solve: the whole image, no slabs.
struct TvGeo {
    int h, w;
    int gh, gw;
    int row0, col0;
    int hw;
};

// The halo slabs of one array of c planes an image, each null for zeros:
// up and dn [n, c, hw, w] (the hw rows above and below the block), lf and
// rt [n, c, h + 2 hw, hw] (the hw columns left and right of the
// row-extended block, corners included).
struct TvSlabs {
    const float* up;
    const float* dn;
    const float* lf;
    const float* rt;
};

// Plane `pl` (image * c + channel) of an array at the block's cell (r, c)
// in block coordinates: the block's own value (a: the plane, [h, w]) or
// the slab's; 0 beyond the slabs.
__device__ __forceinline__ float tv_fetch(const float* __restrict__ a,
                                          const TvSlabs& sl, size_t pl,
                                          const TvGeo& g, int r, int c) {
    if (c >= 0 && c < g.w) {
        if (r >= 0 && r < g.h) return a[(size_t)r * g.w + c];
        if (r < 0)
            return r >= -g.hw && sl.up
                       ? sl.up[(pl * g.hw + (r + g.hw)) * g.w + c] : 0.0f;
        return r < g.h + g.hw && sl.dn
                   ? sl.dn[(pl * g.hw + (r - g.h)) * g.w + c] : 0.0f;
    }
    if (r < -g.hw || r >= g.h + g.hw) return 0.0f;
    const size_t row = pl * (g.h + 2 * g.hw) + (r + g.hw);
    if (c < 0)
        return c >= -g.hw && sl.lf ? sl.lf[row * g.hw + (c + g.hw)] : 0.0f;
    return c < g.w + g.hw && sl.rt ? sl.rt[row * g.hw + (c - g.w)] : 0.0f;
}

// One window's state: the thread's cells (row ty + BY * u, column
// tx + BX * v of the window) in registers, p0, p1 and out shared.  The
// step reads only these fields: it is bound by its instructions under a
// cap of 40 registers.
struct TvWin {
    float* p0;
    float* p1;
    float* o;
    double* wsum;           // [TV_S][BNWARP][2]
    int gi0, gj0;           // the window's origin in the image
    int gh, gw;             // the image
    float wgt;
};

// Load x of the thread's cells into xr and the dual p (null: p = 0) into
// the window, each from the block or (SLABS) its slabs; zeros outside the
// image.  Sets the in-image and owned masks (owned: the window's tile, in
// the block).  The dense solve's block is the image, so it compiles without
// the slab lookup; the sharded solve's windows inside the block (most of
// them; the test is uniform over the block) skip it too.  The lookup on
// every cell made kernel T 25 % slower (PERF.md section 6).
template <bool SLABS>
__device__ __forceinline__ void tv_blk_load(
        const TvWin& win, const TvGeo& g, int img,
        const float* __restrict__ x, const TvSlabs& xs,
        const float* __restrict__ p, const TvSlabs& ps, float (&xr)[BR][BC],
        unsigned& inimg, unsigned& owned) {
    const size_t plane = (size_t)g.h * g.w;
    const float* xi = x + img * plane;
    const float* pi = p ? p + img * 2 * plane : nullptr;
    const int li0 = win.gi0 - g.row0, lj0 = win.gj0 - g.col0;
    const bool inside = li0 >= 0 && li0 + BW <= g.h && lj0 >= 0
                        && lj0 + BW <= g.w;
    inimg = 0u;
    owned = 0u;
#pragma unroll
    for (int u = 0; u < BR; ++u) {
#pragma unroll
        for (int v = 0; v < BC; ++v) {
            const int r = threadIdx.y + BY * u, c = threadIdx.x + BX * v;
            const int li = li0 + r, lj = lj0 + c;
            const int gi = win.gi0 + r, gj = win.gj0 + c;
            const int q = r * BW + c;
            const int bit = u * BC + v;
            const bool in = gi >= 0 && gi < g.gh && gj >= 0 && gj < g.gw;
            if (!SLABS || inside) {
                const size_t l = (size_t)li * g.w + lj;
                xr[u][v] = in ? xi[l] : 0.0f;
                win.p0[q] = in && pi ? pi[l] : 0.0f;
                win.p1[q] = in && pi ? pi[plane + l] : 0.0f;
            } else {
                xr[u][v] = in ? tv_fetch(xi, xs, img, g, li, lj) : 0.0f;
                win.p0[q] = in && pi ? tv_fetch(pi, ps, 2 * img, g, li, lj)
                                     : 0.0f;
                win.p1[q] = in && pi ? tv_fetch(pi + plane, ps, 2 * img + 1,
                                                g, li, lj)
                                     : 0.0f;
            }
            if (in) inimg |= 1u << bit;
            if (li >= 0 && li < g.h && lj >= 0 && lj < g.w && r >= TV_S
                && r < BW - TV_S && c >= TV_S && c < BW - TV_S)
                owned |= 1u << bit;
        }
    }
    __syncthreads();
}

// Step k of a launch (0-based) on the window, in place.  ENERGY: add the
// owned cells' d^2 and |grad out| in float64 and store the warp's sums in
// wsum[k].
template <bool ENERGY>
__device__ __forceinline__ void tv_blk_step(const TvWin& win, int k,
                                            const float (&xr)[BR][BC],
                                            unsigned inimg, unsigned owned) {
    const float tau = 0.25f;
    double sd = 0.0, sn = 0.0;
    // (i) out = x + div p where p, p above and p left are still valid
#pragma unroll
    for (int u = 0; u < BR; ++u) {
#pragma unroll
        for (int v = 0; v < BC; ++v) {
            const int r = threadIdx.y + BY * u, c = threadIdx.x + BX * v;
            if (r <= k || r >= BW - k || c <= k || c >= BW - k) continue;
            const int q = r * BW + c;
            const float d = tv_dval(win.p0[q], win.p1[q], win.p0[q - BW],
                                    win.p1[q - 1]);
            win.o[q] = xr[u][v] + d;
            if (ENERGY && (owned >> (u * BC + v) & 1u))
                sd += (double)(d * d);
        }
    }
    __syncthreads();
    // (ii) the differences of out (0 at the image's last row and column),
    // the norm and the update of p on the image's cells where out below and
    // to the right is still valid
#pragma unroll
    for (int u = 0; u < BR; ++u) {
#pragma unroll
        for (int v = 0; v < BC; ++v) {
            const int r = threadIdx.y + BY * u, c = threadIdx.x + BX * v;
            if (r <= k || r >= BW - k - 1 || c <= k || c >= BW - k - 1
                || !(inimg >> (u * BC + v) & 1u))
                continue;
            const int q = r * BW + c;
            const float o = win.o[q];
            const float gy = win.gi0 + r < win.gh - 1 ? win.o[q + BW] - o
                                                      : 0.0f;
            const float gx = win.gj0 + c < win.gw - 1 ? win.o[q + 1] - o
                                                      : 0.0f;
            const float norm = sqrtf(gy * gy + gx * gx);
            if (ENERGY && (owned >> (u * BC + v) & 1u)) sn += (double)norm;
            const float scale = norm * tau / win.wgt + 1.0f;
            win.p0[q] = (win.p0[q] - tau * gy) / scale;
            win.p1[q] = (win.p1[q] - tau * gx) / scale;
        }
    }
    if (ENERGY) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            sd += __shfl_down_sync(0xffffffffu, sd, off);
            sn += __shfl_down_sync(0xffffffffu, sn, off);
        }
        const int tid = threadIdx.y * BX + threadIdx.x;
        if ((tid & 31) == 0) {
            double* ws = win.wsum + ((size_t)k * BNWARP + (tid >> 5)) * 2;
            ws[0] = sd;
            ws[1] = sn;
        }
    }
    __syncthreads();
}

__device__ __forceinline__ TvWin tv_blk_window(float* sm, const TvGeo& g,
                                               float wgt) {
    TvWin win;
    win.p0 = sm;
    win.p1 = sm + BW * BW;
    win.o = sm + 2 * BW * BW;
    win.wsum = reinterpret_cast<double*>(sm + 3 * BW * BW);
    win.gi0 = g.row0 + blockIdx.y * BT - TV_S;
    win.gj0 = g.col0 + blockIdx.x * BT - TV_S;
    win.gh = g.gh;
    win.gw = g.gw;
    win.wgt = wgt;
    return win;
}

// m <= TV_S iterations from p_a (p_in and its slabs ps; null p_in at
// a = 0) on the active images: writes p_{a+m} of the owned tiles to p_out
// and each step's partial sums to partials [n, nblk, TV_S, 2].
template <bool SLABS>
__global__ void __launch_bounds__(BNT, 3)
tv_blk_step_kernel(const float* __restrict__ x, const float* __restrict__ p_in,
                   float* __restrict__ p_out, double* __restrict__ partials,
                   const int* __restrict__ active,
                   const float* __restrict__ weight, TvGeo g, TvSlabs xs,
                   TvSlabs ps, int m) {
    extern __shared__ __align__(16) float tv_sm[];
    const int img = blockIdx.z;
    if (!active[img]) return;  // uniform over the block
    const size_t plane = (size_t)g.h * g.w;
    const TvWin win = tv_blk_window(tv_sm, g, weight[img]);
    float xr[BR][BC];
    unsigned inimg, owned;
    tv_blk_load<SLABS>(win, g, img, x, xs, p_in, ps, xr, inimg, owned);
    for (int k = 0; k < m; ++k) tv_blk_step<true>(win, k, xr, inimg, owned);

    float* q0 = p_out + img * 2 * plane;
#pragma unroll
    for (int u = 0; u < BR; ++u) {
#pragma unroll
        for (int v = 0; v < BC; ++v) {
            if (!(owned >> (u * BC + v) & 1u)) continue;
            const int r = threadIdx.y + BY * u, c = threadIdx.x + BX * v;
            const size_t l = (size_t)(win.gi0 - g.row0 + r) * g.w
                             + (win.gj0 - g.col0 + c);
            q0[l] = win.p0[r * BW + c];
            q0[plane + l] = win.p1[r * BW + c];
        }
    }
    const int tid = threadIdx.y * BX + threadIdx.x;
    if (tid < 2 * m) {  // the warps' sums of step tid / 2 in order
        const int k = tid >> 1, e = tid & 1;
        double acc = 0.0;
        for (int wp = 0; wp < BNWARP; ++wp)
            acc += win.wsum[((size_t)k * BNWARP + wp) * 2 + e];
        const size_t blk = (size_t)img * gridDim.x * gridDim.y
                           + blockIdx.y * gridDim.x + blockIdx.x;
        partials[(blk * TV_S + k) * 2 + e] = acc;
    }
}

// The block's sums of each of a launch's m steps, one block per active
// image: the windows' partials summed in a fixed order → sums [n, m, 2].
__global__ void __launch_bounds__(FIN_T)
tv_blk_rank_sums_kernel(const double* __restrict__ partials, int nblk,
                        const int* __restrict__ active,
                        double* __restrict__ sums, int m) {
    __shared__ double sh[FIN_T];
    const int img = blockIdx.x;
    if (!active[img]) return;
    const double* pi = partials + (size_t)img * nblk * TV_S * 2;
    for (int k = 0; k < m; ++k) {
        double a, b;
        tv_sum_partials(pi + 2 * k, nblk, 2 * TV_S, sh, a, b);
        if (threadIdx.x == 0) {
            sums[((size_t)img * m + k) * 2] = a;
            sums[((size_t)img * m + k) * 2 + 1] = b;
        }
    }
}

// The stop rule over a launch's m steps, one block per active image: the
// base a of the launch is recorded, the steps' energies walked in order
// until the image stops.  partials [n, nblk, stride, 2]: the dense solve's
// windows (stride TV_S), or the sharded solve's global sums (nblk 1,
// stride m).
__global__ void __launch_bounds__(FIN_T)
tv_blk_finalize_kernel(const double* __restrict__ partials, int nblk,
                       int stride, const float* __restrict__ weight,
                       float* __restrict__ e0, float* __restrict__ e_prev,
                       int* __restrict__ active, int* __restrict__ iters,
                       int* __restrict__ base, int a, int m, float eps,
                       float size) {
    __shared__ double sh[FIN_T];
    __shared__ int still;
    const int img = blockIdx.x;
    if (!active[img]) return;
    if (threadIdx.x == 0) base[img] = a;
    const double* pi = partials + (size_t)img * nblk * stride * 2;
    for (int k = 0; k < m; ++k) {
        double sd, sn;
        tv_sum_partials(pi + 2 * k, nblk, 2 * stride, sh, sd, sn);
        if (threadIdx.x == 0) {
            tv_stop_rule(img, sd, sn, weight, e0, e_prev, active, iters,
                         a + k == 0, eps, size);
            still = active[img];
        }
        __syncthreads();
        if (!still) return;
    }
}

// out = x + div p_{t-1} per image: p_a from the buffer its base a names
// (p_even and its slabs for even a / ms, p_odd for odd; zeros at a = 0;
// ms: the steps of a full launch), r = t - 1 - a steps, then the
// divergence on the owned tile.
template <bool SLABS>
__global__ void __launch_bounds__(BNT)
tv_blk_rebuild_kernel(const float* __restrict__ x,
                      const float* __restrict__ p_even,
                      const float* __restrict__ p_odd,
                      const int* __restrict__ iters,
                      const int* __restrict__ base,
                      const float* __restrict__ weight,
                      float* __restrict__ out, TvGeo g, TvSlabs xs,
                      TvSlabs ps_even, TvSlabs ps_odd, int ms) {
    extern __shared__ __align__(16) float tv_sm[];
    const int img = blockIdx.z;
    const int a = base[img];
    const int r_steps = iters[img] - 1 - a;
    const bool odd = (a / ms) % 2;
    const float* p = a == 0 ? nullptr : (odd ? p_odd : p_even);
    // chosen member by member: a reference to one of the two parameter
    // structs would put a copy of it on the stack
    const TvSlabs ps{odd ? ps_odd.up : ps_even.up,
                     odd ? ps_odd.dn : ps_even.dn,
                     odd ? ps_odd.lf : ps_even.lf,
                     odd ? ps_odd.rt : ps_even.rt};
    const TvWin win = tv_blk_window(tv_sm, g, weight[img]);
    float xr[BR][BC];
    unsigned inimg, owned;
    tv_blk_load<SLABS>(win, g, img, x, xs, p, ps, xr, inimg, owned);
    for (int k = 0; k < r_steps; ++k)
        tv_blk_step<false>(win, k, xr, inimg, owned);
    float* oi = out + img * (size_t)g.h * g.w;
#pragma unroll
    for (int u = 0; u < BR; ++u) {
#pragma unroll
        for (int v = 0; v < BC; ++v) {
            if (!(owned >> (u * BC + v) & 1u)) continue;
            const int r = threadIdx.y + BY * u, c = threadIdx.x + BX * v;
            const int q = r * BW + c;
            const float d = tv_dval(win.p0[q], win.p1[q], win.p0[q - BW],
                                    win.p1[q - 1]);
            oi[(size_t)(win.gi0 - g.row0 + r) * g.w + (win.gj0 - g.col0 + c)]
                = xr[u][v] + d;
        }
    }
}

// BSMEM is above the 48 KB a launch gets by default.  The attribute belongs
// to the current device, so it is set before each launch (a cheap host
// call beside a launch).
cudaError_t tv_blk_smem_attr(const void* kernel) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)BSMEM);
}

dim3 tv_blk_grid(int n, const TvGeo& g) {
    return dim3((g.w + BT - 1) / BT, (g.h + BT - 1) / BT, n);
}

TvGeo tv_dense(int h, int w) { return TvGeo{h, w, h, w, 0, 0, 0}; }

constexpr TvSlabs NO_SLABS{nullptr, nullptr, nullptr, nullptr};

template <bool SLABS>
cudaError_t tv_blk_launch_step(const float* x, const float* p_in,
                               float* p_out, double* partials,
                               const int* active, const float* weight,
                               const TvGeo& g, const TvSlabs& xs,
                               const TvSlabs& ps, int n, int a, int m,
                               cudaStream_t st) {
    const cudaError_t e = tv_blk_smem_attr(
        reinterpret_cast<const void*>(tv_blk_step_kernel<SLABS>));
    if (e != cudaSuccess) return e;
    tv_blk_step_kernel<SLABS><<<tv_blk_grid(n, g), dim3(BX, BY), BSMEM, st>>>(
        x, a == 0 ? nullptr : p_in, p_out, partials, active, weight, g, xs,
        ps, m);
    return cudaGetLastError();
}

template <bool SLABS>
cudaError_t tv_blk_launch_rebuild(const float* x, const float* p_even,
                                  const float* p_odd, const int* iters,
                                  const int* base, const float* weight,
                                  float* out, const TvGeo& g,
                                  const TvSlabs& xs, const TvSlabs& ps_even,
                                  const TvSlabs& ps_odd, int n, int ms,
                                  cudaStream_t st) {
    const cudaError_t e = tv_blk_smem_attr(
        reinterpret_cast<const void*>(tv_blk_rebuild_kernel<SLABS>));
    if (e != cudaSuccess) return e;
    tv_blk_rebuild_kernel<SLABS><<<tv_blk_grid(n, g), dim3(BX, BY), BSMEM,
                                   st>>>(
        x, p_even, p_odd, iters, base, weight, out, g, xs, ps_even, ps_odd,
        ms);
    return cudaGetLastError();
}

}  // namespace

// The iterations one launch runs (TV_S), for the wrappers' partials and
// ping-pong buffers.
extern "C" int mdx_tv_blocked_steps() { return TV_S; }

// Kernel T's launch of steps a .. a + m - 1 (m <= TV_S) on every active
// image: the blocked step from p_in (ignored at a = 0: p = 0) into p_out,
// then the finalize over its m energies.  p_in, p_out: [n, 2, h, w];
// partials [n, nblk, TV_S, 2] float64 with nblk = ceil(h / (64 - 2 TV_S)) *
// ceil(w / (64 - 2 TV_S)); base [n] int32 gets a for every image active at
// the start.
extern "C" int mdx_tv_blocked_step(const float* x, const float* p_in,
                                   float* p_out, double* partials,
                                   const float* weight, float* e0,
                                   float* e_prev, int* active, int* iters,
                                   int* base, int n, int h, int w, int a,
                                   int m, float eps, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (m < 1 || m > TV_S) return (int)cudaErrorInvalidValue;
    const TvGeo g = tv_dense(h, w);
    const cudaError_t e = tv_blk_launch_step<false>(
        x, p_in, p_out, partials, active, weight, g, NO_SLABS, NO_SLABS, n,
        a, m, st);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid = tv_blk_grid(n, g);
    tv_blk_finalize_kernel<<<n, FIN_T, 0, st>>>(
        partials, grid.x * grid.y, TV_S, weight, e0, e_prev, active, iters,
        base, a, m, eps, (float)h * (float)w);
    return (int)cudaGetLastError();
}

// Kernel T's output after the loop: out [n, h, w] = x + div p_{t-1} from
// each image's count t (iters) and base a (base), p_a in p_even (a / TV_S
// even) or p_odd.
extern "C" int mdx_tv_blocked_rebuild(const float* x, const float* p_even,
                                      const float* p_odd, const int* iters,
                                      const int* base, const float* weight,
                                      float* out, int n, int h, int w,
                                      void* stream) {
    return (int)tv_blk_launch_rebuild<false>(
        x, p_even, p_odd, iters, base, weight, out, tv_dense(h, w),
        NO_SLABS, NO_SLABS, NO_SLABS, n, TV_S,
        static_cast<cudaStream_t>(stream));
}

// Kernel 12's launch of m <= hw <= TV_S steps on a block [n, h, w] at
// (row0, col0) of a gh x gw image: the blocked step from p_in (null at
// a = 0) with the slabs of x (xu, xd [n, 1, hw, w]; xl, xr [n, 1, h + 2 hw,
// hw]) and of p_in (pu .. pr, the same with 2 planes), each null for zeros,
// into p_out; then the block's sums of each step → sums [n, m, 2] float64
// (inactive images' rows left as they are).  partials: [n, nblk, TV_S, 2]
// float64 scratch.
extern "C" int mdx_tv_shard_blocked_step(
        const float* x, const float* p_in, float* p_out, double* partials,
        double* sums, const int* active, const float* weight,
        const float* xu, const float* xd, const float* xl, const float* xr,
        const float* pu, const float* pd, const float* pl, const float* pr,
        int n, int h, int w, int gh, int gw, int row0, int col0, int hw,
        int m, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (m < 1 || m > TV_S || hw < 0 || hw > TV_S)
        return (int)cudaErrorInvalidValue;
    const TvGeo g{h, w, gh, gw, row0, col0, hw};
    const cudaError_t e = tv_blk_launch_step<true>(
        x, p_in, p_out, partials, active, weight, g, TvSlabs{xu, xd, xl, xr},
        TvSlabs{pu, pd, pl, pr}, n, p_in ? 1 : 0, m, st);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid = tv_blk_grid(n, g);
    tv_blk_rank_sums_kernel<<<n, FIN_T, 0, st>>>(partials, grid.x * grid.y,
                                                 active, sums, m);
    return (int)cudaGetLastError();
}

// The stop rule over a launch of kernel 12: the global sums [n, m, 2] (the
// blocks' sums added over the tile group) walked from step a; size is the
// image's gh * gw.
extern "C" int mdx_tv_shard_blocked_finalize(
        const double* sums, const float* weight, float* e0, float* e_prev,
        int* active, int* iters, int* base, int n, int a, int m, float eps,
        float size, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (m < 1 || m > TV_S) return (int)cudaErrorInvalidValue;
    tv_blk_finalize_kernel<<<n, FIN_T, 0, st>>>(
        sums, 1, m, weight, e0, e_prev, active, iters, base, a, m, eps, size);
    return (int)cudaGetLastError();
}

// Kernel 12's output after the loop: out [n, h, w] of the block from each
// image's count and base, p_a in p_even with its slabs eu .. er (a / ms
// even) or p_odd with ou .. or; x's slabs as for the step.
extern "C" int mdx_tv_shard_blocked_rebuild(
        const float* x, const float* p_even, const float* p_odd,
        const int* iters, const int* base, const float* weight, float* out,
        const float* xu, const float* xd, const float* xl, const float* xr,
        const float* eu, const float* ed, const float* el, const float* er,
        const float* ou, const float* od, const float* ol, const float* orr,
        int n, int h, int w, int gh, int gw, int row0, int col0, int hw,
        int ms, void* stream) {
    if (ms < 1 || ms > TV_S || hw < 0 || hw > TV_S)
        return (int)cudaErrorInvalidValue;
    return (int)tv_blk_launch_rebuild<true>(
        x, p_even, p_odd, iters, base, weight, out,
        TvGeo{h, w, gh, gw, row0, col0, hw}, TvSlabs{xu, xd, xl, xr},
        TvSlabs{eu, ed, el, er}, TvSlabs{ou, od, ol, orr}, n, ms,
        static_cast<cudaStream_t>(stream));
}
