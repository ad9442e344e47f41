// Unsharp mask: clip(x + (x - blur) * amount, 0, 1), blur = a 25-tap
// separable Gaussian with per-image taps on an edge (clamp) pad, along H
// first, then along W on the intermediate, taps in ascending order.
//
// Replaces the TPU kernel mdx/ops/pallas_kernels.py unsharp_tpu /
// _unsharp_kernel (one whole image in VMEM per grid step).  Here one block
// computes a 32x32 output tile from a 56x56 clamped halo in shared memory:
// the row pass writes a 32x56 intermediate to shared memory and the column
// pass reads it, so the blurred image never goes to device memory.  The
// taps come from the plain _gauss_taps on the device.
// Bound: 2 x 25 multiply-adds per pixel per pass against one read and one
// write of the image; the halo loads (3.1x the tile) hit L2.  Compute on
// the SM's FP32 pipes, far below its peak at this size; the next step is
// more outputs per thread and vectorised loads.
#include "common.cuh"

namespace {

constexpr int UT = 32;            // output tile edge
constexpr int UR = 12;            // tap radius (_GAUSS_MAX_RADIUS)
constexpr int NTAP = 2 * UR + 1;
constexpr int US = UT + 2 * UR;   // halo tile edge

__global__ void __launch_bounds__(256)
unsharp_kernel(const float* __restrict__ x, const float* __restrict__ taps,
               const float* __restrict__ amount, float* __restrict__ out,
               int h, int w) {
    __shared__ float s[US][US + 1];
    __shared__ float r[UT][US + 1];
    __shared__ float tp[NTAP];

    const int img = blockIdx.z;
    const int i0 = blockIdx.y * UT;
    const int j0 = blockIdx.x * UT;
    const size_t plane = (size_t)h * w;
    const float* xi = x + img * plane;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nth = blockDim.x * blockDim.y;

    if (tid < NTAP) tp[tid] = taps[img * NTAP + tid];
    for (int k = tid; k < US * US; k += nth) {
        const int a = k / US, b = k % US;
        const int gi = mdx::clamp_idx(i0 + a - UR, h);
        const int gj = mdx::clamp_idx(j0 + b - UR, w);
        s[a][b] = xi[(size_t)gi * w + gj];
    }
    __syncthreads();

    // along H: rows i0..i0+31, every halo column
    for (int k = tid; k < UT * US; k += nth) {
        const int a = k / US, b = k % US;
        float acc = tp[0] * s[a][b];
        for (int t = 1; t < NTAP; ++t) acc = acc + tp[t] * s[a + t][b];
        r[a][b] = acc;
    }
    __syncthreads();

    // along W on the intermediate, then the unsharp combine
    const float amt = amount[img];
    for (int k = tid; k < UT * UT; k += nth) {
        const int a = k / UT, c = k % UT;
        const int i = i0 + a, j = j0 + c;
        if (i >= h || j >= w) continue;
        float blur = tp[0] * r[a][c];
        for (int t = 1; t < NTAP; ++t) blur = blur + tp[t] * r[a][c + t];
        const float xv = s[a + UR][c + UR];
        const float o = xv + (xv - blur) * amt;
        out[img * plane + (size_t)i * w + j] = fminf(fmaxf(o, 0.0f), 1.0f);
    }
}

}  // namespace

extern "C" int mdx_unsharp(const float* x, const float* taps,
                           const float* amount, float* out, int n, int h,
                           int w, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((w + UT - 1) / UT, (h + UT - 1) / UT, n);
    unsharp_kernel<<<grid, dim3(32, 8), 0, st>>>(x, taps, amount, out, h, w);
    return (int)cudaGetLastError();
}
