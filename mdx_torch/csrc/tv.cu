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
// pallas_kernels.py _tv_band_step) is the same iteration on one row block
// of a spatially-sharded image (mdx_torch/parallel/tv_sp.py).  The step
// kernel takes the block's halo rows (TvHalo): the previous block's last p0
// row for the divergence at row 0, and the next block's first x, p0 and p1
// rows, from which the last row's forward difference gets the next row of
// out; null rows are zeros, and glast (the block holds the global bottom
// row) zeroes that difference, as at the dense image's edge.  With no rows
// and glast = 1 it is one iteration of the whole image (the dense solve's
// form before the blocked kernels, a launch pair per iteration).  Per
// iteration mdx_tv_shard_step runs the step and sums the block's partials in
// a fixed order to [N, 2] float64; the caller adds those over the row
// blocks (torch.distributed) and mdx_tv_shard_finalize applies the stop
// rule that the dense finalize applies (one __device__ function for both)
// to the global sums.  The TPU kernel's per-band snapshot of the halo rows
// (its bands ran in order and wrote in place) is not needed: the step reads
// p_in and writes p_out.  Bound: memory, 24 bytes a pixel an iteration plus
// four rows.
//
// On a 2-D grid of tiles (mdx/parallel/tv_sp.py with col_axis, an XLA body
// on the TPU: its banded kernel is 1-D only) the same step takes column
// halos too: the left tile's last p1 column (the divergence at column 0)
// and the right tile's first x, p0 and p1 columns, from which the last
// column's forward difference gets the next column of out; grlast (the
// tile holds the global right column) zeroes that difference.  Two corners
// enter: the right tile's row 0 of out needs p0 from the tile above it
// (up-right), and the next row's out at column 0 needs p1 from the tile
// below the left one (down-left).  The caller exchanges rows first and then
// the columns of the row-extended state, so lf_p1 holds h + 1 values (row h
// from the tile below the left one) and rt_p0 holds h + 1 (index 0 from the
// tile above the right one): the corners come with the columns, no diagonal
// message and no second launch.  Dense and row-block calls pass null column
// halos and grlast = 1, which is the code they ran before.
#include "common.cuh"

namespace {

constexpr int TT = 32;        // tile edge
constexpr int TROWS = 8;      // block is 32 x 8 threads, 4 rows each
constexpr int NT = TT * TROWS;
constexpr int FIN_T = 256;

// The rows next to the array that the stencil reads: [n, w] each, null for
// zeros.  glast: the array's last row is the image's bottom row.  The
// columns next to it (2-D tiles), null for zeros: lf_p1 [n, h + 1] (rows
// 0 .. h), rt_x and rt_p1 [n, h], rt_p0 [n, h + 1] (rows -1 .. h - 1).
// grlast: the array's last column is the image's right column.
struct TvHalo {
    const float* up_p0;
    const float* dn_x;
    const float* dn_p0;
    const float* dn_p1;
    int glast;
    const float* lf_p1;
    const float* rt_x;
    const float* rt_p0;
    const float* rt_p1;
    int grlast;
};

// d = -(p0 + p1) + (p0 above) + (p1 left), in the plain version's order
__device__ __forceinline__ float tv_dval(float p0c, float p1c, float above,
                                         float left) {
    float d = -(p0c + p1c);
    d = d + above;
    d = d + left;
    return d;
}

__device__ __forceinline__ float row_at(const float* __restrict__ r, int j) {
    return r ? r[j] : 0.0f;
}

__device__ __forceinline__ float tv_d(const float* __restrict__ p0,
                                      const float* __restrict__ p1, int i,
                                      int j, int w,
                                      const float* __restrict__ up,
                                      const float* __restrict__ lf) {
    const size_t k = (size_t)i * w + j;
    return tv_dval(p0[k], p1[k],
                   i > 0 ? p0[k - w] : row_at(up, j),
                   j > 0 ? p1[k - 1] : row_at(lf, i));
}

__global__ void __launch_bounds__(NT)
tv_step_kernel(const float* __restrict__ x, const float* __restrict__ p_in,
               float* __restrict__ p_out, float* __restrict__ out,
               double* __restrict__ partials, const int* __restrict__ active,
               const float* __restrict__ weight, int h, int w, TvHalo halo) {
    __shared__ double sh[NT];
    const int img = blockIdx.z;
    if (!active[img]) return;  // uniform over the block

    const size_t plane = (size_t)h * w;
    const float* xi = x + img * plane;
    const float* p0 = p_in + img * 2 * plane;
    const float* p1 = p0 + plane;
    float* q0 = p_out + img * 2 * plane;
    float* q1 = q0 + plane;
    float* oi = out + img * plane;
    const size_t ro = (size_t)img * w;
    const float* up = halo.up_p0 ? halo.up_p0 + ro : nullptr;
    const float* dnx = halo.dn_x ? halo.dn_x + ro : nullptr;
    const float* dn0 = halo.dn_p0 ? halo.dn_p0 + ro : nullptr;
    const float* dn1 = halo.dn_p1 ? halo.dn_p1 + ro : nullptr;
    const size_t co = (size_t)img * h;
    const float* lf = halo.lf_p1 ? halo.lf_p1 + co + img : nullptr;
    const float* rtx = halo.rt_x ? halo.rt_x + co : nullptr;
    const float* rt0 = halo.rt_p0 ? halo.rt_p0 + co + img : nullptr;
    const float* rt1 = halo.rt_p1 ? halo.rt_p1 + co : nullptr;
    const float wgt = weight[img];
    const float tau = 0.25f;

    double sd = 0.0, sn = 0.0;
    const int j = blockIdx.x * TT + threadIdx.x;
    for (int r = 0; r < TT / TROWS; ++r) {
        const int i = blockIdx.y * TT + threadIdx.y + r * TROWS;
        if (i >= h || j >= w) continue;
        const size_t k = (size_t)i * w + j;
        const float d = tv_d(p0, p1, i, j, w, up, lf);
        const float o = xi[k] + d;
        float gy;
        if (i < h - 1) {
            gy = (xi[k + w] + tv_d(p0, p1, i + 1, j, w, up, lf)) - o;
        } else if (halo.glast) {
            gy = 0.0f;
        } else {  // the next block's first row of out
            const float ddn = tv_dval(row_at(dn0, j), row_at(dn1, j), p0[k],
                                      j > 0 ? row_at(dn1, j - 1)
                                            : row_at(lf, h));
            gy = (row_at(dnx, j) + ddn) - o;
        }
        float gx;
        if (j < w - 1) {
            gx = (xi[k + 1] + tv_d(p0, p1, i, j + 1, w, up, lf)) - o;
        } else if (halo.grlast) {
            gx = 0.0f;
        } else {  // the right tile's first column of out (rt_p0 from row -1)
            const float drt = tv_dval(row_at(rt0, i + 1), row_at(rt1, i),
                                      row_at(rt0, i), p1[k]);
            gx = (row_at(rtx, i) + drt) - o;
        }
        const float norm = sqrtf(gy * gy + gx * gx);
        sd += (double)(d * d);
        sn += (double)norm;
        const float scale = norm * tau / wgt + 1.0f;
        q0[k] = (p0[k] - tau * gy) / scale;
        q1[k] = (p1[k] - tau * gx) / scale;
        oi[k] = o;
    }
    sd = mdx::block_sum<double, NT>(sd, sh);
    sn = mdx::block_sum<double, NT>(sn, sh);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
        const size_t blk = (size_t)img * gridDim.x * gridDim.y
                           + blockIdx.y * gridDim.x + blockIdx.x;
        partials[2 * blk] = sd;
        partials[2 * blk + 1] = sn;
    }
}

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

// The stop rule of tv_chambolle_xla on an image's global sums, shared by the
// dense (blocked) finalize and the sharded one.
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

// The block's sums of an active image → sums[img] (float64 [n, 2]).
__global__ void __launch_bounds__(FIN_T)
tv_block_sums_kernel(const double* __restrict__ partials, int nblk,
                     const int* __restrict__ active,
                     double* __restrict__ sums) {
    __shared__ double sh[FIN_T];
    const int img = blockIdx.x;
    if (!active[img]) return;
    double a, b;
    tv_sum_partials(partials + (size_t)img * nblk * 2, nblk, 2, sh, a, b);
    if (threadIdx.x != 0) return;
    sums[2 * img] = a;
    sums[2 * img + 1] = b;
}

// The stop rule on the global sums, one thread per image.
__global__ void tv_shard_finalize_kernel(const double* __restrict__ sums,
                                         const float* __restrict__ weight,
                                         float* __restrict__ e0,
                                         float* __restrict__ e_prev,
                                         int* __restrict__ active,
                                         int* __restrict__ iters, int n,
                                         int first, float eps, float size) {
    const int img = blockIdx.x * blockDim.x + threadIdx.x;
    if (img >= n || !active[img]) return;
    tv_stop_rule(img, sums[2 * img], sums[2 * img + 1], weight, e0, e_prev,
                 active, iters, first, eps, size);
}


// ---- the blocked dense solve (kernel T) ----------------------------------

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

// One window's state: the thread's cells (row ty + BY * u, column
// tx + BX * v of the window) in registers, p0, p1 and out shared.
struct TvWin {
    float* p0;
    float* p1;
    float* o;
    double* wsum;           // [TV_S][BNWARP][2]
    int gi0, gj0;           // the window's origin in the image
    int h, w;
    float wgt;
};

// Load x of the thread's cells into xr and the dual p (null: p = 0) into
// the window; zeros outside the image.  Sets the in-image and owned masks.
__device__ __forceinline__ void tv_blk_load(
        const TvWin& win, const float* __restrict__ x,
        const float* __restrict__ p, float (&xr)[BR][BC], unsigned& inimg,
        unsigned& owned) {
    const size_t plane = (size_t)win.h * win.w;
    inimg = 0u;
    owned = 0u;
#pragma unroll
    for (int u = 0; u < BR; ++u) {
#pragma unroll
        for (int v = 0; v < BC; ++v) {
            const int r = threadIdx.y + BY * u, c = threadIdx.x + BX * v;
            const int gi = win.gi0 + r, gj = win.gj0 + c;
            const int q = r * BW + c;
            const int bit = u * BC + v;
            const bool in = gi >= 0 && gi < win.h && gj >= 0 && gj < win.w;
            const size_t g = (size_t)gi * win.w + gj;
            xr[u][v] = in ? x[g] : 0.0f;
            win.p0[q] = in && p ? p[g] : 0.0f;
            win.p1[q] = in && p ? p[plane + g] : 0.0f;
            if (in) inimg |= 1u << bit;
            if (in && r >= TV_S && r < BW - TV_S && c >= TV_S && c < BW - TV_S)
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
    // (ii) the differences of out, the norm and the update of p on the
    // image's cells where out below and to the right is still valid
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
            const float gy = win.gi0 + r < win.h - 1 ? win.o[q + BW] - o
                                                      : 0.0f;
            const float gx = win.gj0 + c < win.w - 1 ? win.o[q + 1] - o
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

__device__ __forceinline__ TvWin tv_blk_window(float* sm, int h, int w,
                                               float wgt) {
    TvWin win;
    win.p0 = sm;
    win.p1 = sm + BW * BW;
    win.o = sm + 2 * BW * BW;
    win.wsum = reinterpret_cast<double*>(sm + 3 * BW * BW);
    win.gi0 = blockIdx.y * BT - TV_S;
    win.gj0 = blockIdx.x * BT - TV_S;
    win.h = h;
    win.w = w;
    win.wgt = wgt;
    return win;
}

// m <= TV_S iterations from p_a (p_in; null at a = 0) on the active
// images: writes p_{a+m} of the owned tiles to p_out and each step's partial
// sums to partials [n, nblk, TV_S, 2].
__global__ void __launch_bounds__(BNT, 3)
tv_blk_step_kernel(const float* __restrict__ x, const float* __restrict__ p_in,
                   float* __restrict__ p_out, double* __restrict__ partials,
                   const int* __restrict__ active,
                   const float* __restrict__ weight, int h, int w, int m) {
    extern __shared__ __align__(16) float tv_sm[];
    const int img = blockIdx.z;
    if (!active[img]) return;  // uniform over the block
    const size_t plane = (size_t)h * w;
    const TvWin win = tv_blk_window(tv_sm, h, w, weight[img]);
    float xr[BR][BC];
    unsigned inimg, owned;
    tv_blk_load(win, x + img * plane,
                p_in ? p_in + img * 2 * plane : nullptr, xr, inimg, owned);
    for (int k = 0; k < m; ++k) tv_blk_step<true>(win, k, xr, inimg, owned);

    float* q0 = p_out + img * 2 * plane;
#pragma unroll
    for (int u = 0; u < BR; ++u) {
#pragma unroll
        for (int v = 0; v < BC; ++v) {
            if (!(owned >> (u * BC + v) & 1u)) continue;
            const int r = threadIdx.y + BY * u, c = threadIdx.x + BX * v;
            const size_t g = (size_t)(win.gi0 + r) * w + (win.gj0 + c);
            q0[g] = win.p0[r * BW + c];
            q0[plane + g] = win.p1[r * BW + c];
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

// The stop rule over a launch's m steps, one block per active image: the
// base a of the launch is recorded, the steps' energies walked in order
// until the image stops.
__global__ void __launch_bounds__(FIN_T)
tv_blk_finalize_kernel(const double* __restrict__ partials, int nblk,
                       const float* __restrict__ weight,
                       float* __restrict__ e0, float* __restrict__ e_prev,
                       int* __restrict__ active, int* __restrict__ iters,
                       int* __restrict__ base, int a, int m, float eps,
                       float size) {
    __shared__ double sh[FIN_T];
    __shared__ int still;
    const int img = blockIdx.x;
    if (!active[img]) return;
    if (threadIdx.x == 0) base[img] = a;
    const double* pi = partials + (size_t)img * nblk * TV_S * 2;
    for (int k = 0; k < m; ++k) {
        double sd, sn;
        tv_sum_partials(pi + 2 * k, nblk, 2 * TV_S, sh, sd, sn);
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
// (p_even for even a / TV_S, p_odd for odd; zeros at a = 0), r = t - 1 - a
// steps, then the divergence on the owned tile.
__global__ void __launch_bounds__(BNT)
tv_blk_rebuild_kernel(const float* __restrict__ x,
                      const float* __restrict__ p_even,
                      const float* __restrict__ p_odd,
                      const int* __restrict__ iters,
                      const int* __restrict__ base,
                      const float* __restrict__ weight,
                      float* __restrict__ out, int h, int w) {
    extern __shared__ __align__(16) float tv_sm[];
    const int img = blockIdx.z;
    const size_t plane = (size_t)h * w;
    const int a = base[img];
    const int r_steps = iters[img] - 1 - a;
    const float* p = a == 0 ? nullptr
                            : ((a / TV_S) % 2 ? p_odd : p_even)
                                  + img * 2 * plane;
    const TvWin win = tv_blk_window(tv_sm, h, w, weight[img]);
    float xr[BR][BC];
    unsigned inimg, owned;
    tv_blk_load(win, x + img * plane, p, xr, inimg, owned);
    for (int k = 0; k < r_steps; ++k)
        tv_blk_step<false>(win, k, xr, inimg, owned);
    float* oi = out + img * plane;
#pragma unroll
    for (int u = 0; u < BR; ++u) {
#pragma unroll
        for (int v = 0; v < BC; ++v) {
            if (!(owned >> (u * BC + v) & 1u)) continue;
            const int r = threadIdx.y + BY * u, c = threadIdx.x + BX * v;
            const int q = r * BW + c;
            const float d = tv_dval(win.p0[q], win.p1[q], win.p0[q - BW],
                                    win.p1[q - 1]);
            oi[(size_t)(win.gi0 + r) * w + (win.gj0 + c)] = xr[u][v] + d;
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

dim3 tv_blk_grid(int n, int h, int w) {
    return dim3((w + BT - 1) / BT, (h + BT - 1) / BT, n);
}

}  // namespace

// One Chambolle iteration on a row block or tile (kernel 12): the step
// with the block's halo rows (each [n, w] or null for zeros) and halo
// columns (lf_p1, rt_p0 [n, h + 1], rt_x, rt_p1 [n, h], or null), then the
// block's sums of each active image into sums [n, 2] float64 (inactive
// images' rows are left as they are).  partials: [n, nblk, 2] float64
// scratch.
extern "C" int mdx_tv_shard_step(const float* x, const float* p_in,
                                 float* p_out, float* out, double* partials,
                                 double* sums, const int* active,
                                 const float* weight, const float* up_p0,
                                 const float* dn_x, const float* dn_p0,
                                 const float* dn_p1, const float* lf_p1,
                                 const float* rt_x, const float* rt_p0,
                                 const float* rt_p1, int n, int h, int w,
                                 int glast, int grlast, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((w + TT - 1) / TT, (h + TT - 1) / TT, n);
    const TvHalo halo{up_p0, dn_x, dn_p0, dn_p1, glast,
                      lf_p1, rt_x, rt_p0, rt_p1, grlast};
    tv_step_kernel<<<grid, dim3(TT, TROWS), 0, st>>>(x, p_in, p_out, out,
                                                      partials, active,
                                                      weight, h, w, halo);
    tv_block_sums_kernel<<<n, FIN_T, 0, st>>>(partials, grid.x * grid.y,
                                              active, sums);
    return (int)cudaGetLastError();
}

// The stop rule on the global sums [n, 2] (the blocks' sums added over the
// row blocks); size is the global H * W.
extern "C" int mdx_tv_shard_finalize(const double* sums, const float* weight,
                                     float* e0, float* e_prev, int* active,
                                     int* iters, int n, int first, float eps,
                                     float size, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    tv_shard_finalize_kernel<<<(n + 127) / 128, 128, 0, st>>>(
        sums, weight, e0, e_prev, active, iters, n, first, eps, size);
    return (int)cudaGetLastError();
}

// The iterations one launch of kernel T runs (TV_S), for the wrapper's
// partials and ping-pong buffers.
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
    const cudaError_t e = tv_blk_smem_attr(
        reinterpret_cast<const void*>(tv_blk_step_kernel));
    if (e != cudaSuccess) return (int)e;
    const dim3 grid = tv_blk_grid(n, h, w);
    tv_blk_step_kernel<<<grid, dim3(BX, BY), BSMEM, st>>>(
        x, a == 0 ? nullptr : p_in, p_out, partials, active, weight, h, w, m);
    tv_blk_finalize_kernel<<<n, FIN_T, 0, st>>>(
        partials, grid.x * grid.y, weight, e0, e_prev, active, iters, base, a,
        m, eps, (float)h * (float)w);
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
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t e = tv_blk_smem_attr(
        reinterpret_cast<const void*>(tv_blk_rebuild_kernel));
    if (e != cudaSuccess) return (int)e;
    tv_blk_rebuild_kernel<<<tv_blk_grid(n, h, w), dim3(BX, BY), BSMEM, st>>>(
        x, p_even, p_odd, iters, base, weight, out, h, w);
    return (int)cudaGetLastError();
}
