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
//   1. clahe_lut_kernel: one block per (image, tile).  Integer histogram in
//      shared memory (integer atomics are exact and order-free), then one
//      thread clips, spreads and scans the 256 bins in order; the LUT goes
//      to [N, gy, gx, 256] f32.
//   2. clahe_remap_kernel: one thread per output pixel, 4 LUT gathers (the
//      LUTs of one image are 256 KB at 512^2 and stay in L2) and the blend
//      in the exact form of clahe_xla.
// Bound: memory; the image is read twice and written once.  The serial
// 256-bin scan per tile is the next thing to parallelise.
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
#include "common.cuh"

namespace {

constexpr int NBINS = 256;

__global__ void __launch_bounds__(NBINS)
clahe_lut_kernel(const float* __restrict__ x, const float* __restrict__ clip,
                 float* __restrict__ lut, int h, int w, int t, int gy,
                 int gx) {
    __shared__ unsigned int hist[NBINS];
    __shared__ float cdf[NBINS];
    const int img = blockIdx.z, ty = blockIdx.y, tx = blockIdx.x;
    const int tid = threadIdx.x;
    const float* xi = x + (size_t)img * h * w;

    hist[tid] = 0u;
    __syncthreads();
    for (int k = tid; k < t * t; k += NBINS) {
        const int gi = mdx::refl_idx(ty * t + k / t, h);
        const int gj = mdx::refl_idx(tx * t + k % t, w);
        const float v = fminf(fmaxf(xi[(size_t)gi * w + gj], 0.0f), 1.0f);
        const int q = min((int)(v * (float)NBINS), NBINS - 1);
        atomicAdd(&hist[q], 1u);
    }
    __syncthreads();

    if (tid == 0) {
        const float npix = (float)(t * t);
        const float clim = fmaxf(clip[img] * npix, 1.0f);
        float excess = 0.0f;
        for (int b = 0; b < NBINS; ++b)
            excess = excess + fmaxf((float)hist[b] - clim, 0.0f);
        const float redist = excess / (float)NBINS;
        float run = 0.0f;
        for (int b = 0; b < NBINS; ++b) {
            run = run + (fminf((float)hist[b], clim) + redist);
            cdf[b] = run;
        }
    }
    __syncthreads();

    const float cdf0 = cdf[0];
    const float denom = fmaxf(cdf[NBINS - 1] - cdf0, 1e-12f);
    const size_t tile = ((size_t)img * gy + ty) * gx + tx;
    lut[tile * NBINS + tid] = (cdf[tid] - cdf0) / denom;
}

__global__ void __launch_bounds__(256)
clahe_remap_kernel(const float* __restrict__ x, const float* __restrict__ lut,
                   float* __restrict__ out, int h, int w, int t, int gy,
                   int gx) {
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
    const int y0 = min(max((int)floorf(fy), 0), gy - 1);
    const int x0 = min(max((int)floorf(fx), 0), gx - 1);
    const int y1 = min(y0 + 1, gy - 1);
    const int x1 = min(x0 + 1, gx - 1);
    const float wy = fminf(fmaxf(fy - (float)y0, 0.0f), 1.0f);
    const float wx = fminf(fmaxf(fx - (float)x0, 0.0f), 1.0f);

    const float* L = lut + (size_t)img * gy * gx * NBINS;
    const float v00 = L[((size_t)y0 * gx + x0) * NBINS + q];
    const float v01 = L[((size_t)y0 * gx + x1) * NBINS + q];
    const float v10 = L[((size_t)y1 * gx + x0) * NBINS + q];
    const float v11 = L[((size_t)y1 * gx + x1) * NBINS + q];
    out[o] = (1.0f - wy) * ((1.0f - wx) * v00 + wx * v01)
             + wy * ((1.0f - wx) * v10 + wx * v11);
}

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
    clahe_lut_kernel<<<dim3(gx, gy, n), NBINS, 0, st>>>(x, clip, lut, h, w, t,
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
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int gy = (h + t - 1) / t, gx = (w + t - 1) / t;
    clahe_lut_kernel<<<dim3(gx, gy, n), NBINS, 0, st>>>(x, clip, lut, h, w, t,
                                                        gy, gx);
    dim3 block(32, 8);
    dim3 grid((w + 31) / 32, (h + 7) / 8, n);
    clahe_remap_kernel<<<grid, block, 0, st>>>(x, lut, out, h, w, t, gy, gx);
    return (int)cudaGetLastError();
}
