// TV denoise, Chambolle dual ascent (skimage denoise_tv_chambolle /
// mdx.ops.tv.tv_chambolle_xla): step tau = 1/4, per-image weight,
// E = (sum d^2 + w * sum |grad out|) / HW, stop per image when
// |E_prev - E| < eps * E_0 or after max_iter iterations.
//
// Replaces the TPU kernel mdx/ops/pallas_kernels.py tv_chambolle_tpu /
// _tv_kernel, which keeps one image's whole solve (x, out, p0, p1) in VMEM.
// That state is 4 MB at 512^2 and does not fit one SM's 227 KB of shared
// memory, so the solve runs as one launch pair per iteration over all
// images, driven by the caller:
//   1. tv_step_kernel: one block per 32x32 tile.  Reads x and p, writes out
//      and the next p (ping-pong buffers), and one pair of partial sums
//      (sum d^2, sum |grad out|) per block.  Blocks of images that have
//      stopped return at once.
//   2. tv_finalize_kernel: one block per image.  Sums the partials in a
//      fixed order to E (all sums in float64, rounded once to float32, as
//      the plain version does) and applies the tv_chambolle_xla stop rule:
//      still = |e_prev - e| >= eps * e0, active &= still,
//      e_prev = where(active, e, e_prev); counts the image's iterations.
// No float atomics, so the stop decisions are the same on every run.
// Bound: memory.  Each iteration reads x, p0, p1 and writes out, p0, p1
// (24 bytes a pixel; the stencil neighbours hit L1/L2).  At 512^2 the
// launch pair per iteration costs a few microseconds of overhead; a
// persistent cooperative kernel or a CUDA graph would remove it.
//
// TPU kernel 12 (mdx/parallel/tv_sp.py _tv_sharded_banded, whose body is
// pallas_kernels.py _tv_band_step) is the same iteration on one row block
// of a spatially-sharded image (mdx_torch/parallel/tv_sp.py).  The step
// kernel takes the block's halo rows (TvHalo): the previous block's last p0
// row for the divergence at row 0, and the next block's first x, p0 and p1
// rows, from which the last row's forward difference gets the next row of
// out; null rows are zeros, and glast (the block holds the global bottom
// row) zeroes that difference, as at the dense image's edge.  The dense
// solve passes no rows and glast = 1, which is the code it ran before.  Per
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

// The image's (sum d^2, sum |grad out|) from its blocks' partials, in a
// fixed order; every thread of the block gets them.
__device__ __forceinline__ void tv_sum_partials(
        const double* __restrict__ partials, int nblk, int img, double* sh,
        double& a, double& b) {
    const double* pi = partials + (size_t)img * nblk * 2;
    a = 0.0;
    b = 0.0;
    for (int k = threadIdx.x; k < nblk; k += FIN_T) {
        a += pi[2 * k];
        b += pi[2 * k + 1];
    }
    a = mdx::block_sum<double, FIN_T>(a, sh);
    b = mdx::block_sum<double, FIN_T>(b, sh);
}

// The stop rule of tv_chambolle_xla on an image's global sums, shared by the
// dense finalize and the sharded one.
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

__global__ void __launch_bounds__(FIN_T)
tv_finalize_kernel(const double* __restrict__ partials, int nblk,
                   const float* __restrict__ weight, float* __restrict__ e0,
                   float* __restrict__ e_prev, int* __restrict__ active,
                   int* __restrict__ iters, int first, float eps, float size) {
    __shared__ double sh[FIN_T];
    const int img = blockIdx.x;
    if (!active[img]) return;
    double a, b;
    tv_sum_partials(partials, nblk, img, sh, a, b);
    if (threadIdx.x != 0) return;
    tv_stop_rule(img, a, b, weight, e0, e_prev, active, iters, first, eps,
                 size);
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
    tv_sum_partials(partials, nblk, img, sh, a, b);
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

}  // namespace

// One Chambolle iteration over all active images: step, then finalize.
// p_in/p_out: [n, 2, h, w]; partials: [n, nblk, 2] float64 with
// nblk = ceil(w/32) * ceil(h/32); first = 1 for the initial step (p = 0).
extern "C" int mdx_tv_iteration(const float* x, const float* p_in,
                                float* p_out, float* out, double* partials,
                                const float* weight, float* e0, float* e_prev,
                                int* active, int* iters, int n, int h, int w,
                                int first, float eps, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((w + TT - 1) / TT, (h + TT - 1) / TT, n);
    const TvHalo dense{nullptr, nullptr, nullptr, nullptr, 1,
                       nullptr, nullptr, nullptr, nullptr, 1};
    tv_step_kernel<<<grid, dim3(TT, TROWS), 0, st>>>(x, p_in, p_out, out,
                                                      partials, active,
                                                      weight, h, w, dense);
    tv_finalize_kernel<<<n, FIN_T, 0, st>>>(partials, grid.x * grid.y, weight,
                                            e0, e_prev, active, iters, first,
                                            eps, (float)h * (float)w);
    return (int)cudaGetLastError();
}

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
