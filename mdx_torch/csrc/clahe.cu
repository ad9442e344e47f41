// Whole-image CLAHE (skimage equalize_adapthist semantics, numerically the
// mdx.ops.clahe.clahe_xla formulation): q = min(floor(clip(x,0,1)*256), 255);
// one 256-bin histogram per t x t tile of the (bottom/right reflect-padded)
// image; clip at max(clip_limit * t^2, 1) and spread the excess evenly;
// CDF to a LUT; bilinear remap of each pixel from its 4 tile LUTs.
//
// Replaces the TPU kernel mdx/ops/pallas_kernels.py clahe_tpu /
// _clahe_kernel, which does the histograms and the remap as 0/1-selector
// and interpolation-matrix matmuls on the MXU because gathers and scatters
// serialise there.  A GPU gathers and does integer shared-memory atomics
// natively, so:
//   1. clahe_lut_kernel: a warp per (image, tile), 8 tiles a block.  Each
//      lane adds t^2/32 pixels to the warp's 256-bin histogram in shared
//      memory (integer atomics: exact and order-free), loading 8 of them
//      before their atomics so the loads overlap.  Then each lane owns
//      8 consecutive bins: the excess over the clip limit is the lanes'
//      8-bin sums added by a shuffle butterfly, the CDF is each lane's
//      serial run over its 8 bins plus the exclusive scan of the lane
//      totals (5 shuffle steps).  Float32 sums in that fixed order (the
//      plain version's torch.sum and torch.cumsum are orders of their own).
//      The LUT goes to [N, gy, gx, 256] f32 as two float4 stores a lane.
//   2. clahe_remap_kernel: every pixel between the same four tile centres
//      (a cell, about t x t pixels) blends the same four LUTs.  A block
//      takes K = 64/t cells across (1 <= K <= 14) and walks 4 cell rows
//      down (measured against walks of 8 and 16 on an H100: more blocks in
//      flight beat fewer LUT reloads); the LUTs they need sit in a ring of
//      three LUT rows in shared memory (each a contiguous run of K + 1 LUTs
//      of the grid), and each pixel gathers its four values there: each
//      LUT row read once a walk, ~6 B a pixel of LUT traffic at t = 16 (a
//      remap reading whole LUTs once per cell row would read 10, the
//      per-pixel gathers of the first port four 32-byte sectors a pixel,
//      mostly from L2).  The next LUT row (cp.async) and the next cell
//      row's pixels load while a cell row computes.  A row's weight and
//      tile index come from a table the block fills once a cell row, a
//      column's from registers, so a pixel costs its bin, four
//      shared-memory reads and the blend.  The pixel's expression (fy, fx,
//      the clamps, the blend's order) is that of clahe_xla.  A pixel whose
//      clamped tile indices are not its block's gathers from the grid in
//      device memory instead: that needs float rounding of fy or fx to
//      disagree with the integer cell bounds, which no extent up to 65536
//      and no t up to 4096 does (tests/test_torch_clahe_sched.py checks),
//      so the path only keeps larger inputs exact and in bounds.
// Bound: memory; x is read twice, the LUT grid written once and read
// about once, out written once.
//
// The sharded CLAHE of mdx_torch/parallel/clahe_sp.py uses two more entries:
//   * mdx_clahe_luts: the LUT stage above alone, on one row block whose
//     extents are multiples of t (its reflect index is then the identity),
//     so the local LUTs get the dense op's exact clip and scan;
//   * mdx_clahe_remap_ext (TPU kernel 11, mdx/parallel/clahe_sp.py
//     _remap_ext_pallas -> pallas_kernels.py _clahe_remap_kernel): the
//     bilinear remap of a block against its halo-extended LUT grid
//     [N, gy+2, gx+2, 256] (the neighbours' edge LUT rows, or copies of the
//     block's own at the image border).  y0 = floor(f) + 1 in extended
//     coordinates, w = f - floor(f), no clamp: the clamping lives in the
//     halo contents.  The TPU kernel does this as banded bf16-split
//     matmuls over 3-row LUT windows because the MXU cannot gather; here one
//     thread per pixel does 4 gathers, in the exact expression of
//     _remap_ext_xla.  Bound: memory (x read, out written, the LUT grid read
//     once; at 512 x 2048 rows of a shard with t = 16 the grid is 4.5 MB
//     against 8.4 MB of pixels, and it stays in the 50 MB L2).
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int NBINS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int LUT_WARPS = 8;             // tiles of a LUT-stage block
constexpr int CH = 8;                    // loads a lane keeps in flight
constexpr int RW = 64, RH = 4;           // remap threads across and down
constexpr int MAX_CELLS = 14;            // cells across a remap block
constexpr int WALK = 4;                  // cell rows a remap block walks
constexpr int MAX_ROWS = 64;             // rows of a remap block's table

__global__ void __launch_bounds__(32 * LUT_WARPS)
clahe_lut_kernel(const float* __restrict__ x, const float* __restrict__ clip,
                 float* __restrict__ lut, int h, int w, int t, int gy,
                 int gx) {
    __shared__ __align__(16) unsigned int hist[LUT_WARPS][NBINS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int img = blockIdx.z, ty = blockIdx.y;
    const int tx = blockIdx.x * LUT_WARPS + warp;
    if (tx >= gx) return;                // a whole warp; no block barrier
    unsigned int* hw = hist[warp];
    uint4* own = reinterpret_cast<uint4*>(hw) + 2 * lane;  // bins 8l..8l+7
    own[0] = make_uint4(0u, 0u, 0u, 0u);
    own[1] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();

    // the lane's pixels k = lane + 32 u of the tile, CH at a time: their
    // loads all in flight before their atomics; (r, c) of k stepped by
    // (32 / t, 32 % t) with one carry, no division a pixel
    const float* xi = x + (size_t)img * h * w;
    const bool interior = (ty + 1) * t <= h && (tx + 1) * t <= w;
    const int npx = t * t, dr = 32 / t, dc = 32 % t;
    int r = lane / t, c = lane % t;
    for (int k0 = lane; k0 < npx; k0 += 32 * CH) {
        float val[CH];
#pragma unroll
        for (int u = 0; u < CH; ++u) {
            if (k0 + 32 * u < npx) {
                const int gi = interior ? ty * t + r
                                        : mdx::refl_idx(ty * t + r, h);
                const int gj = interior ? tx * t + c
                                        : mdx::refl_idx(tx * t + c, w);
                val[u] = xi[(size_t)gi * w + gj];
            }
            r += dr;
            c += dc;
            if (c >= t) {
                c -= t;
                ++r;
            }
        }
#pragma unroll
        for (int u = 0; u < CH; ++u)
            if (k0 + 32 * u < npx) {
                const float v = fminf(fmaxf(val[u], 0.0f), 1.0f);
                atomicAdd(&hw[min((int)(v * (float)NBINS), NBINS - 1)], 1u);
            }
    }
    __syncwarp();

    const uint4 h0 = own[0], h1 = own[1];
    const float hb[8] = {(float)h0.x, (float)h0.y, (float)h0.z, (float)h0.w,
                         (float)h1.x, (float)h1.y, (float)h1.z, (float)h1.w};
    const float npix = (float)(t * t);
    const float clim = fmaxf(clip[img] * npix, 1.0f);
    float excess = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) excess = excess + fmaxf(hb[j] - clim, 0.0f);
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
        excess = excess + __shfl_xor_sync(FULL, excess, o);
    const float redist = excess / (float)NBINS;
    float cdf[8];
    float run = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        run = run + (fminf(hb[j], clim) + redist);
        cdf[j] = run;
    }
    float incl = run;                    // inclusive scan of lane totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl = up + incl;
    }
    float before = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) before = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) cdf[j] = before + cdf[j];
    const float cdf0 = __shfl_sync(FULL, cdf[0], 0);
    const float denom = fmaxf(__shfl_sync(FULL, cdf[7], 31) - cdf0, 1e-12f);
    float4* dst = reinterpret_cast<float4*>(
        lut + (((size_t)img * gy + ty) * gx + tx) * NBINS) + 2 * lane;
    dst[0] = make_float4((cdf[0] - cdf0) / denom, (cdf[1] - cdf0) / denom,
                         (cdf[2] - cdf0) / denom, (cdf[3] - cdf0) / denom);
    dst[1] = make_float4((cdf[4] - cdf0) / denom, (cdf[5] - cdf0) / denom,
                         (cdf[6] - cdf0) / denom, (cdf[7] - cdf0) / denom);
}

// The four LUT values of bin q at tiles (y0|y1, x0|x1) from the grid in
// device memory.
__device__ __forceinline__ void gather4(const float* __restrict__ L, int gx,
                                        int y0, int y1, int x0, int x1,
                                        int q, float& v00, float& v01,
                                        float& v10, float& v11) {
    v00 = L[((size_t)y0 * gx + x0) * NBINS + q];
    v01 = L[((size_t)y0 * gx + x1) * NBINS + q];
    v10 = L[((size_t)y1 * gx + x0) * NBINS + q];
    v11 = L[((size_t)y1 * gx + x1) * NBINS + q];
}

// Cells: cell row cy (-1 .. gy-1) holds the pixel rows whose floor(fy) is
// cy, rows [cy*t + t/2, (cy+1)*t + t/2); likewise columns.  Block
// (bx, by): cells bx*k - 1 .. bx*k + k - 2 across, walking the cell rows
// by*WALK - 1 .. by*WALK + WALK - 2 down.  A cell row reads the LUT rows
// y0 = clamp(cy) and y1 = min(y0 + 1, gy - 1) over the clamped LUT
// columns its cells touch: those rows sit in a ring of three shared-memory
// slots (row r in slot r % 3, k + 1 LUTs each, dynamic shared memory), and
// while a cell row computes, the next LUT row copies into its slot
// (cp.async) and, for t <= 32, each thread loads its next cell row's
// pixels (one column, at most CH rows) into registers.  So each LUT row is
// read once a walk and a cell row's loads are in flight while the one
// before it computes.  A row's weight and tile index come from a table
// (two, by parity of the cell row; t <= MAX_ROWS), a column's from
// registers; each pixel finds its bin and gathers four values from shared
// memory.
__global__ void __launch_bounds__(RW * RH)
clahe_remap_kernel(const float* __restrict__ x, const float* __restrict__ lut,
                   float* __restrict__ out, int h, int w, int t, int gy,
                   int gx, int k) {
    extern __shared__ float4 s_dyn[];
    __shared__ float s_wy[2][MAX_ROWS];
    __shared__ int s_row_in[2][MAX_ROWS];
    const int img = blockIdx.z;
    const int cx0 = (int)blockIdx.x * k - 1;
    const int c_lo = max(0, cx0 * t + t / 2);
    const int c_hi = min(w, (cx0 + k) * t + t / 2);
    const int cy_lo = (int)blockIdx.y * WALK - 1;
    const int cy_hi = min(cy_lo + WALK, gy);
    if (c_lo >= c_hi) return;                      // the whole block
    const int lx0 = min(max(cx0, 0), gx - 1);
    const int lx1 = min(min(max(cx0 + k - 1, 0), gx - 1) + 1, gx - 1);
    const int n4 = (lx1 - lx0 + 1) * (NBINS / 4);  // float4s of a LUT row
    const float* L = lut + (size_t)img * gy * gx * NBINS;
    const float* xi = x + (size_t)img * h * w;
    float* oi = out + (size_t)img * h * w;
    const int tid = threadIdx.y * RW + threadIdx.x;
    const float tf = (float)t;
    auto slot = [&](int row) { return s_dyn + (size_t)(row % 3) * n4; };
    auto fetch_row = [&](int row) {                // cp.async into its slot
        const float4* src = reinterpret_cast<const float4*>(
            L + ((size_t)row * gx + lx0) * NBINS);
        float4* dst = slot(row);
        for (int e = tid; e < n4; e += RW * RH)
            __pipeline_memcpy_async(dst + e, src + e, sizeof(float4));
        __pipeline_commit();
    };
    auto rows_of = [&](int cy, int& r_lo, int& r_hi) {
        r_lo = max(0, cy * t + t / 2);
        r_hi = min(h, (cy + 1) * t + t / 2);
    };
    auto fill_table = [&](int cy) {                // rows of cell row cy
        int r_lo, r_hi;
        rows_of(cy, r_lo, r_hi);
        const int ly0 = min(max(cy, 0), gy - 1), par = (cy - cy_lo) & 1;
        if (r_hi - r_lo <= MAX_ROWS && tid < r_hi - r_lo) {
            const float fy = ((float)(r_lo + tid) + 0.5f) / tf - 0.5f;
            const int y0 = min(max((int)floorf(fy), 0), gy - 1);
            s_wy[par][tid] = fminf(fmaxf(fy - (float)y0, 0.0f), 1.0f);
            s_row_in[par][tid] = y0 == ly0;
        }
    };
    // a column's tile indices, weight and shared-memory offsets
    struct Col {
        int x0, x1, a, b;
        float wx, owx;
        bool in;
    };
    auto column = [&](int j) {
        Col c;
        const float fx = ((float)j + 0.5f) / tf - 0.5f;
        c.x0 = min(max((int)floorf(fx), 0), gx - 1);
        c.x1 = min(c.x0 + 1, gx - 1);
        c.wx = fminf(fmaxf(fx - (float)c.x0, 0.0f), 1.0f);
        c.owx = 1.0f - c.wx;
        c.in = c.x0 >= lx0 && c.x1 <= lx1;
        c.a = (c.x0 - lx0) * NBINS;
        c.b = (c.x1 - lx0) * NBINS;
        return c;
    };
    // one pixel (i, j) of a cell row (its LUT rows ly0, ly1 in the slots
    // s0, s1; its table par) from its x value
    auto pixel = [&](int i, int j, float xval, const Col& c, const float* s0,
                     const float* s1, int ly0, int par, int r_lo,
                     bool table) {
        const float v = fminf(fmaxf(xval, 0.0f), 1.0f);
        const int q = min((int)(v * (float)NBINS), NBINS - 1);
        float wy = 0.0f, v00, v01, v10, v11;
        int y0 = ly0;
        bool in = false;
        if (table) {
            wy = s_wy[par][i - r_lo];
            in = c.in && s_row_in[par][i - r_lo];
        }
        if (!in) {                       // rows past MAX_ROWS, or rounding
            const float fy = ((float)i + 0.5f) / tf - 0.5f;
            y0 = min(max((int)floorf(fy), 0), gy - 1);
            wy = fminf(fmaxf(fy - (float)y0, 0.0f), 1.0f);
            in = c.in && y0 == ly0;
        }
        if (in) {
            v00 = s0[c.a + q]; v01 = s0[c.b + q];
            v10 = s1[c.a + q]; v11 = s1[c.b + q];
        } else {
            gather4(L, gx, y0, min(y0 + 1, gy - 1), c.x0, c.x1, q, v00, v01,
                    v10, v11);
        }
        oi[(size_t)i * w + j] = (1.0f - wy) * (c.owx * v00 + c.wx * v01)
                                + wy * (c.owx * v10 + c.wx * v11);
    };

    // one column a thread and at most CH rows a cell row: the next cell
    // row's pixels load while this one computes
    const bool fast = c_hi - c_lo <= RW && t <= RH * CH;
    const int jf = c_lo + threadIdx.x;
    const bool has_col = jf < c_hi;
    const Col cf = column(jf);
    auto load_x = [&](int cy, float (&dst)[CH]) {
        int r_lo, r_hi;
        rows_of(cy, r_lo, r_hi);
#pragma unroll
        for (int u = 0; u < CH; ++u) {
            const int i = r_lo + threadIdx.y + RH * u;
            if (has_col && i < r_hi) dst[u] = __ldg(xi + (size_t)i * w + jf);
        }
    };
    // the LUT rows of the walk: first .. last; the first two now
    const int first = min(max(cy_lo, 0), gy - 1);
    const int last = min(min(max(cy_hi - 1, 0), gy - 1) + 1, gy - 1);
    int have = min(first + 1, last);               // the ring's last row
    for (int row = first; row <= have; ++row) fetch_row(row);
    fill_table(cy_lo);
    float xv[CH];
    if (fast) load_x(cy_lo, xv);
    __pipeline_wait_prior(0);
    __syncthreads();

    for (int cy = cy_lo; cy < cy_hi; ++cy) {
        const int ly1 = min(min(max(cy, 0), gy - 1) + 1, gy - 1);
        // the next LUT row's slot, (ly1 + 1) % 3, is neither ly0's nor
        // ly1's, and its last reader finished before the last barrier
        const bool fetch = have == ly1 && have < last && cy + 1 < cy_hi;
        if (fetch) fetch_row(++have);
        float xn[CH];
        if (fast && cy + 1 < cy_hi) load_x(cy + 1, xn);
        int r_lo, r_hi;
        rows_of(cy, r_lo, r_hi);
        const bool table = r_hi - r_lo <= MAX_ROWS;
        const int ly0 = min(max(cy, 0), gy - 1), par = (cy - cy_lo) & 1;
        const float* s0 = reinterpret_cast<const float*>(slot(ly0));
        const float* s1 = reinterpret_cast<const float*>(slot(ly1));
        if (fast) {
            if (has_col) {
#pragma unroll
                for (int u = 0; u < CH; ++u) {
                    const int i = r_lo + threadIdx.y + RH * u;
                    if (i >= r_hi) break;
                    pixel(i, jf, xv[u], cf, s0, s1, ly0, par, r_lo, table);
                }
            }
        } else {
            for (int j = c_lo + threadIdx.x; j < c_hi; j += RW) {
                const Col c = column(j);
                for (int i = r_lo + threadIdx.y; i < r_hi; i += RH)
                    pixel(i, j, __ldg(xi + (size_t)i * w + j), c, s0, s1, ly0,
                          par, r_lo, table);
            }
        }
        if (cy + 1 < cy_hi) fill_table(cy + 1);
        __pipeline_wait_prior(0);
        __syncthreads();
        if (fast) {
#pragma unroll
            for (int u = 0; u < CH; ++u) xv[u] = xn[u];
        }
    }
}

int cells_per_block(int t) { return min(max(64 / t, 1), MAX_CELLS); }

__global__ void __launch_bounds__(256)
clahe_remap_ext_kernel(const float* __restrict__ x,
                       const float* __restrict__ lut_ext,
                       float* __restrict__ out, int h, int w, int t, int gye,
                       int gxe) {
    const int img = blockIdx.z;
    const int i = blockIdx.y * blockDim.y + threadIdx.y;
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= h || j >= w) return;
    const size_t o = (size_t)img * h * w + (size_t)i * w + j;
    const float v = fminf(fmaxf(x[o], 0.0f), 1.0f);
    const int q = min((int)(v * (float)NBINS), NBINS - 1);

    const float tf = (float)t;
    const float fy = ((float)i + 0.5f) / tf - 0.5f;
    const float fx = ((float)j + 0.5f) / tf - 0.5f;
    const float fly = floorf(fy), flx = floorf(fx);
    const int y0 = (int)fly + 1;
    const int x0 = (int)flx + 1;
    const float wy = fy - fly;
    const float wx = fx - flx;

    const float* L = lut_ext + (size_t)img * gye * gxe * NBINS;
    const float v00 = L[((size_t)y0 * gxe + x0) * NBINS + q];
    const float v01 = L[((size_t)y0 * gxe + x0 + 1) * NBINS + q];
    const float v10 = L[((size_t)(y0 + 1) * gxe + x0) * NBINS + q];
    const float v11 = L[((size_t)(y0 + 1) * gxe + x0 + 1) * NBINS + q];
    out[o] = (1.0f - wy) * ((1.0f - wx) * v00 + wx * v01)
             + wy * ((1.0f - wx) * v10 + wx * v11);
}

}  // namespace

// lut: [n, ceil(h/t), ceil(w/t), 256] f32, the per-tile LUTs of x.
extern "C" int mdx_clahe_luts(const float* x, const float* clip, float* lut,
                              int n, int h, int w, int t, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int gy = (h + t - 1) / t, gx = (w + t - 1) / t;
    const dim3 grid((gx + LUT_WARPS - 1) / LUT_WARPS, gy, n);
    clahe_lut_kernel<<<grid, 32 * LUT_WARPS, 0, st>>>(x, clip, lut, h, w, t,
                                                      gy, gx);
    return (int)cudaGetLastError();
}

// lut_ext: [n, ceil(h/t) + 2, ceil(w/t) + 2, 256] f32, the halo-extended
// LUT grid of the block x [n, h, w].
extern "C" int mdx_clahe_remap_ext(const float* x, const float* lut_ext,
                                   float* out, int n, int h, int w, int t,
                                   void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int gye = (h + t - 1) / t + 2, gxe = (w + t - 1) / t + 2;
    dim3 block(32, 8);
    dim3 grid((w + 31) / 32, (h + 7) / 8, n);
    clahe_remap_ext_kernel<<<grid, block, 0, st>>>(x, lut_ext, out, h, w, t,
                                                   gye, gxe);
    return (int)cudaGetLastError();
}

// lut: scratch [n, ceil(h/t), ceil(w/t), 256] f32, allocated by the caller.
extern "C" int mdx_clahe(const float* x, const float* clip, float* lut,
                         float* out, int n, int h, int w, int t,
                         void* stream) {
    const int rc = mdx_clahe_luts(x, clip, lut, n, h, w, t, stream);
    if (rc != 0) return rc;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int gy = (h + t - 1) / t, gx = (w + t - 1) / t;
    const int k = cells_per_block(t);
    const dim3 grid((gx + 1 + k - 1) / k, (gy + 1 + WALK - 1) / WALK, n);
    const size_t smem = (size_t)3 * (k + 1) * NBINS * sizeof(float);
    clahe_remap_kernel<<<grid, dim3(RW, RH), smem, st>>>(x, lut, out, h, w,
                                                          t, gy, gx, k);
    return (int)cudaGetLastError();
}
