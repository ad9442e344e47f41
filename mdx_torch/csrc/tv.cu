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
#include "common.cuh"

namespace {

constexpr int TT = 32;        // tile edge
constexpr int TROWS = 8;      // block is 32 x 8 threads, 4 rows each
constexpr int NT = TT * TROWS;
constexpr int FIN_T = 256;

__device__ __forceinline__ float tv_d(const float* __restrict__ p0,
                                      const float* __restrict__ p1, int i,
                                      int j, int w) {
    const size_t k = (size_t)i * w + j;
    float d = -(p0[k] + p1[k]);
    d = d + (i > 0 ? p0[k - w] : 0.0f);
    d = d + (j > 0 ? p1[k - 1] : 0.0f);
    return d;
}

__global__ void __launch_bounds__(NT)
tv_step_kernel(const float* __restrict__ x, const float* __restrict__ p_in,
               float* __restrict__ p_out, float* __restrict__ out,
               double* __restrict__ partials, const int* __restrict__ active,
               const float* __restrict__ weight, int h, int w) {
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
    const float wgt = weight[img];
    const float tau = 0.25f;

    double sd = 0.0, sn = 0.0;
    const int j = blockIdx.x * TT + threadIdx.x;
    for (int r = 0; r < TT / TROWS; ++r) {
        const int i = blockIdx.y * TT + threadIdx.y + r * TROWS;
        if (i >= h || j >= w) continue;
        const size_t k = (size_t)i * w + j;
        const float d = tv_d(p0, p1, i, j, w);
        const float o = xi[k] + d;
        const float gy = i < h - 1 ? (xi[k + w] + tv_d(p0, p1, i + 1, j, w)) - o
                                   : 0.0f;
        const float gx = j < w - 1 ? (xi[k + 1] + tv_d(p0, p1, i, j + 1, w)) - o
                                   : 0.0f;
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

__global__ void __launch_bounds__(FIN_T)
tv_finalize_kernel(const double* __restrict__ partials, int nblk,
                   const float* __restrict__ weight, float* __restrict__ e0,
                   float* __restrict__ e_prev, int* __restrict__ active,
                   int* __restrict__ iters, int first, float eps, float size) {
    __shared__ double sh[FIN_T];
    const int img = blockIdx.x;
    if (!active[img]) return;
    const double* pi = partials + (size_t)img * nblk * 2;
    double a = 0.0, b = 0.0;
    for (int k = threadIdx.x; k < nblk; k += FIN_T) {
        a += pi[2 * k];
        b += pi[2 * k + 1];
    }
    a = mdx::block_sum<double, FIN_T>(a, sh);
    b = mdx::block_sum<double, FIN_T>(b, sh);
    if (threadIdx.x != 0) return;
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
    tv_step_kernel<<<grid, dim3(TT, TROWS), 0, st>>>(x, p_in, p_out, out,
                                                      partials, active,
                                                      weight, h, w);
    tv_finalize_kernel<<<n, FIN_T, 0, st>>>(partials, grid.x * grid.y, weight,
                                            e0, e_prev, active, iters, first,
                                            eps, (float)h * (float)w);
    return (int)cudaGetLastError();
}
