// Bilateral filter: a d x d window (d odd, d <= 9) on a numpy "reflect"
// pad (edge not repeated), per-image sigma_color and sigma_space,
//   w(dy,dx) = exp(-(dy^2+dx^2) * inv_2ss2d2) * exp(-(x - s)^2 * inv_2sc2),
//   inv_2sc2 = 1/(2 sc^2), inv_2ss2d2 = 1/(2 ss^2 d^2),
//   out = sum(w * s) / (sum(w) + 1e-10),
// with num and den accumulated window-ascending (dy, then dx), each weight
// and product rounded in the order of the plain version
// (mdx_torch.ops.bilateral.bilateral_plain): (-k) * inv then exp for the
// spatial weight; x - s, then the square, then the scale and exp; then the
// spatial weight times the range weight; then w * s.  With --fmad=false the
// kernel and the plain version round the same way.
//
// Replaces both TPU bilateral kernels of mdx/ops/pallas_kernels.py:
// bilateral_tpu / _bilateral_kernel (one whole reflect-padded image in
// VMEM per grid step, <= 1024^2) and bilateral_banded_tpu /
// _bilateral_band_kernel (row bands of a snapshot built in XLA, > 1024^2).
// Here one kernel serves every size.
//
// Bound on this card (times: NVIDIA H100 80GB HBM3, 700 W, d = 5, sigmas
// 0.05): instructions, not bytes.  A pixel moves 8 bytes; a tap issues ~19
// instructions, of which the accurate expf (not __expf, whose error is far
// above the plain version's rounding) is ~8.  The design:
// - one block per 32 x 32 output tile with its R-halo in shared memory,
//   the d^2 spatial weights computed once a block;
// - interior tiles index without reflection; only border tiles reflect
//   (two integer remainders an element), which took 1.28 ms to 1.14 at
//   16 x 2048^2.
// The pair identity (wgt_{-o}(p) = wgt_o(p - o) bit for bit, one
// exponential a pixel pair) was built and measured in several forms (weight
// maps in shared memory; warp strips with shuffles): each was slower than
// this form at 32 x 512^2 (the best, 64-row strips, by 11 %) and at most
// 2 % faster at 16 x 2048^2.  Halving the exponentials saves at most ~1/4
// of a tap, and the maps' stores or the strips' shuffles, window shifts
// and idle edge lanes take that back (PERF.md, section 6).
#include "common.cuh"

namespace {

constexpr int BW = 32;                  // tile columns: a warp's lanes
constexpr int NT = 256;                 // threads a block

template <bool REFL>
__device__ __forceinline__ float pad_at(const float* xi, int i, int j,
                                        int h, int w) {
    if (REFL) {
        i = mdx::refl_idx(i, h);
        j = mdx::refl_idx(j, w);
    }
    return xi[(size_t)i * w + j];
}

// The tile's halo of the padded image, rows i0 - R .. i0 + BW + R - 1 and
// columns j0 - R .. j0 + BW + R - 1, into s (pitch BW + 2R).
template <int R, bool REFL>
__device__ void load_halo(float* s, const float* xi, int h, int w, int i0,
                          int j0) {
    constexpr int HC = BW + 2 * R;
    for (int k = threadIdx.x; k < HC * HC; k += NT) {
        const int a = k / HC, b = k % HC;
        s[k] = pad_at<REFL>(xi, i0 + a - R, j0 + b - R, h, w);
    }
}

// The spatial weights of the d x d window into sw (window order), and the
// image's inv_2sc2.
template <int R>
__device__ float spatial_weights(float* sw, const float* sc, const float* ss,
                                 int img) {
    constexpr int D = 2 * R + 1;
    if (threadIdx.x < D * D) {
        const float ssv = ss[img];
        const float inv_2ss2d2 = 1.0f / (((2.0f * ssv) * ssv) * (float)(D * D));
        const int dy = threadIdx.x / D - R, dx = threadIdx.x % D - R;
        sw[threadIdx.x] = expf(-(float)(dx * dx + dy * dy) * inv_2ss2d2);
    }
    const float scv = sc[img];
    return 1.0f / ((2.0f * scv) * scv);
}

// One 32 x 32 tile: every weight's exponential a pixel, from the tile's
// halo in shared memory.
template <int R, bool REFL>
__device__ void tile(float* s, float* sw, const float* xi, float* oi,
                            const float* sc, const float* ss, int img, int h,
                            int w, int i0, int j0) {
    constexpr int D = 2 * R + 1;
    constexpr int HC = BW + 2 * R;
    load_halo<R, REFL>(s, xi, h, w, i0, j0);
    const float inv_2sc2 = spatial_weights<R>(sw, sc, ss, img);
    __syncthreads();

    const int c = threadIdx.x % BW;
    const int j = j0 + c;
    for (int a = threadIdx.x / BW; a < BW; a += NT / BW) {
        const int i = i0 + a;
        if (i >= h || j >= w) continue;
        const float xv = s[(a + R) * HC + c + R];
        float num = 0.0f, den = 0.0f;
#pragma unroll
        for (int pos = 0; pos < D * D; ++pos) {
            const int dy = pos / D - R, dx = pos % D - R;
            const float sv = s[(a + dy + R) * HC + c + dx + R];
            const float diff = xv - sv;
            const float wgt = sw[pos] * expf(-(diff * diff) * inv_2sc2);
            num = num + wgt * sv;
            den = den + wgt;
        }
        oi[(size_t)i * w + j] = num / (den + 1e-10f);
    }
}

template <int R>
__global__ void __launch_bounds__(NT)
bilateral_kernel(const float* __restrict__ x, const float* __restrict__ sc,
                 const float* __restrict__ ss, float* __restrict__ out, int h,
                 int w) {
    constexpr int D = 2 * R + 1;
    __shared__ float s[(BW + 2 * R) * (BW + 2 * R)];
    __shared__ float sw[D * D];
    const int img = blockIdx.z;
    const int i0 = blockIdx.y * BW, j0 = blockIdx.x * BW;
    const size_t plane = (size_t)h * w;
    const bool interior = i0 >= R && j0 >= R && i0 + BW + R <= h
                          && j0 + BW + R <= w;
    if (interior)
        tile<R, false>(s, sw, x + img * plane, out + img * plane, sc, ss,
                       img, h, w, i0, j0);
    else
        tile<R, true>(s, sw, x + img * plane, out + img * plane, sc, ss,
                      img, h, w, i0, j0);
}

template <int R>
int launch(const float* x, const float* sc, const float* ss, float* out,
           int n, int h, int w, cudaStream_t st) {
    dim3 grid((w + BW - 1) / BW, (h + BW - 1) / BW, n);
    bilateral_kernel<R><<<grid, NT, 0, st>>>(x, sc, ss, out, h, w);
    return (int)cudaGetLastError();
}

}  // namespace

// x, out: [n, h, w]; sc, ss: [n] (sigma_color, sigma_space); d odd, 1..9.
extern "C" int mdx_bilateral(const float* x, const float* sc, const float* ss,
                             float* out, int n, int h, int w, int d,
                             void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (d) {
        case 1: return launch<0>(x, sc, ss, out, n, h, w, st);
        case 3: return launch<1>(x, sc, ss, out, n, h, w, st);
        case 5: return launch<2>(x, sc, ss, out, n, h, w, st);
        case 7: return launch<3>(x, sc, ss, out, n, h, w, st);
        case 9: return launch<4>(x, sc, ss, out, n, h, w, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
