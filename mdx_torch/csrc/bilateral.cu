// Bilateral filter: a d x d window (d odd, d <= 9) on a numpy "reflect"
// pad (edge not repeated), per-image sigma_color and sigma_space,
//   w(dy,dx) = exp(-(dy^2+dx^2) * inv_2ss2d2) * exp(-(x - s)^2 * inv_2sc2),
//   inv_2sc2 = 1/(2 sc^2), inv_2ss2d2 = 1/(2 ss^2 d^2),
//   out = sum(w * s) / (sum(w) + 1e-10),
// with num and den accumulated window-ascending (dy, then dx), each weight
// and product rounded in the order of the plain version
// (mdx_torch.ops.bilateral.bilateral_plain): (-k) * inv then exp for the
// spatial weight, computed once per image; x - s, then the square, then
// the scale and exp; then w * s.  With --fmad=false the kernel and the
// plain version round the same way.
//
// Replaces both TPU bilateral kernels of mdx/ops/pallas_kernels.py:
// bilateral_tpu / _bilateral_kernel (one whole reflect-padded image in
// VMEM per grid step, <= 1024^2) and bilateral_banded_tpu /
// _bilateral_band_kernel (row bands of a snapshot built in XLA, > 1024^2).
// The TPU needs the band split because VMEM holds a whole image only up to
// 1024^2; here one kernel serves every size: one block per 32x32 output
// tile with its r-halo of the reflect-padded image in shared memory
// (40x40 floats at d = 9), the halo indices reflected in the kernel.
// Bound: operations, not bytes.  Each pixel reads 4 bytes and writes 4,
// against d^2 exps and about 7 d^2 other float operations (d = 5: 25 exps
// and ~200 operations for 8 bytes).  The d^2 spatial weights are computed
// once per block into shared memory; every range weight needs its own
// accurate expf (not __expf, whose error is far above the plain version's
// rounding).  Next steps, later: more outputs per thread, and the halo
// loads as 16-byte vectors.
#include "common.cuh"

namespace {

constexpr int BT = 32;       // output tile edge
constexpr int BROWS = 8;     // block is 32 x 8 threads, 4 rows each

template <int R>
__global__ void __launch_bounds__(BT * BROWS)
bilateral_kernel(const float* __restrict__ x, const float* __restrict__ sc,
                 const float* __restrict__ ss, float* __restrict__ out,
                 int h, int w) {
    constexpr int D = 2 * R + 1;
    constexpr int S = BT + 2 * R;
    __shared__ float s[S][S + 1];
    __shared__ float sw[D * D];

    const int img = blockIdx.z;
    const int i0 = blockIdx.y * BT;
    const int j0 = blockIdx.x * BT;
    const size_t plane = (size_t)h * w;
    const float* xi = x + img * plane;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nth = blockDim.x * blockDim.y;

    for (int k = tid; k < S * S; k += nth) {
        const int a = k / S, b = k % S;
        const int gi = mdx::refl_idx(i0 + a - R, h);
        const int gj = mdx::refl_idx(j0 + b - R, w);
        s[a][b] = xi[(size_t)gi * w + gj];
    }
    if (tid < D * D) {
        const float ssv = ss[img];
        const float inv_2ss2d2 = 1.0f / (((2.0f * ssv) * ssv) * (float)(D * D));
        const int dy = tid / D - R, dx = tid % D - R;
        sw[tid] = expf(-(float)(dx * dx + dy * dy) * inv_2ss2d2);
    }
    const float scv = sc[img];
    const float inv_2sc2 = 1.0f / ((2.0f * scv) * scv);
    __syncthreads();

    const int c = threadIdx.x;
    const int j = j0 + c;
    for (int a = threadIdx.y; a < BT; a += BROWS) {
        const int i = i0 + a;
        if (i >= h || j >= w) continue;
        const float xv = s[a + R][c + R];
        float num = 0.0f, den = 0.0f;
#pragma unroll
        for (int dy = 0; dy < D; ++dy) {
#pragma unroll
            for (int dx = 0; dx < D; ++dx) {
                const float sv = s[a + dy][c + dx];
                const float diff = xv - sv;
                const float iw = expf(-(diff * diff) * inv_2sc2);
                const float wgt = sw[dy * D + dx] * iw;
                num = num + wgt * sv;
                den = den + wgt;
            }
        }
        out[img * plane + (size_t)i * w + j] = num / (den + 1e-10f);
    }
}

}  // namespace

// x, out: [n, h, w]; sc, ss: [n] (sigma_color, sigma_space); d odd, 1..9.
extern "C" int mdx_bilateral(const float* x, const float* sc, const float* ss,
                             float* out, int n, int h, int w, int d,
                             void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((w + BT - 1) / BT, (h + BT - 1) / BT, n);
    dim3 block(BT, BROWS);
    switch (d) {
        case 1: bilateral_kernel<0><<<grid, block, 0, st>>>(x, sc, ss, out, h, w); break;
        case 3: bilateral_kernel<1><<<grid, block, 0, st>>>(x, sc, ss, out, h, w); break;
        case 5: bilateral_kernel<2><<<grid, block, 0, st>>>(x, sc, ss, out, h, w); break;
        case 7: bilateral_kernel<3><<<grid, block, 0, st>>>(x, sc, ss, out, h, w); break;
        case 9: bilateral_kernel<4><<<grid, block, 0, st>>>(x, sc, ss, out, h, w); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
