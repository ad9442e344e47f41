// Haar (db1) BayesShrink wavelet denoise of [N, H, W] float32: a levels-deep
// separable analysis (along H, then along W), per image and detail band the
// threshold t = s^2 / sqrt(max(mean(band^2) - s^2, eps)), soft or hard
// shrink per image, then the synthesis (along W, then along H).
//
// Replaces the TPU kernel mdx/ops/pallas_kernels.py wavelet_denoise_tpu /
// _wavelet_denoise_kernel, which keeps one whole image in VMEM per grid
// step (and carries a transpose bridge only because Mosaic rejects
// lane-splitting reshapes).  Here nothing of that layout remains:
//   * Haar is local: a level-k coefficient depends only on its aligned
//     2^k x 2^k block of pixels.  So a block holding a 2^m x 2^m tile
//     (m <= 5: 4 KB of shared memory) runs levels 1..m in shared memory,
//     in place, one thread per 2x2 quad, reading no neighbour.
//   * BayesShrink couples each band across the whole image, so the denoise
//     is three launches per stage: analysis (coefficients in shared
//     memory, float64 partial sums of band^2 per block), a fixed-order
//     reduce of those sums into the thresholds, and synthesis, which
//     recomputes the analysis from x (reading x again costs 4 B a pixel;
//     a coefficient scratch would cost 8) and shrinks and inverts it.
//   * The levels past m run the same three launches on the tile-level LL
//     image [N, H/2^m, W/2^m] (16x16 at 512^2, 64x64 at 2048^2); its
//     synthesis output is the denoised LL that the stage below puts back
//     into each tile before inverting.  The wrapper
//     (mdx_torch.kernels.wavelet_denoise) orders the stages.
// Rounding: the taps are the float32 values of the plain version
// (mdx_torch/ops/wavelet.py, _f32 of the PyWavelets constants) and every
// coefficient is the same rounded product-then-sum (--fmad=false), so the
// transforms match the plain version bit for bit.  Both versions square
// each coefficient in float32, sum per image and band in float64, divide
// in float64 and round once, so the thresholds agree too; the sums run in
// a fixed order, so a run repeats exactly.
// Bound: memory.  The function reads x once and writes out once (8 B a
// pixel); the kernel moves 12 (x twice, out once) plus the small LL images.
#include "common.cuh"

namespace {

constexpr int MAX_M = 5;                 // tile levels: a 32 x 32 tile
constexpr int MAX_T = 1 << MAX_M;
constexpr int NT = 256;                  // threads of every block
constexpr float C = 0.70710677f;         // float32(1/sqrt(2))
constexpr float EPS = 1.1920928955078125e-07f;  // float32 machine epsilon

// One analysis level on the 2x2 quads at stride st of a T x T tile in
// place: ll at (r, c), lh at (r, c+st), hl at (r+st, c), hh at (r+st, c+st).
// dwt2's order: along H (rows r, r+st), then along W.
__device__ __forceinline__ void haar_fwd(float* s, int T, int r, int c,
                                         int st, float& lh, float& hl,
                                         float& hh) {
    const float p00 = s[r * T + c], p01 = s[r * T + c + st];
    const float p10 = s[(r + st) * T + c], p11 = s[(r + st) * T + c + st];
    const float a0 = C * p00 + C * p10, d0 = C * p10 - C * p00;
    const float a1 = C * p01 + C * p11, d1 = C * p11 - C * p01;
    lh = C * a1 - C * a0;
    hl = C * d0 + C * d1;
    hh = C * d1 - C * d0;
    s[r * T + c] = C * a0 + C * a1;
    s[r * T + c + st] = lh;
    s[(r + st) * T + c] = hl;
    s[(r + st) * T + c + st] = hh;
}

// The inverse of haar_fwd on shrunk details; idwt2's order: along W, then
// along H.  even = lo1*a + hi1*d = C*a - C*d, odd = lo0*a + hi0*d.
__device__ __forceinline__ void haar_inv(float* s, int T, int r, int c,
                                         int st, float ll, float lh,
                                         float hl, float hh) {
    const float a0 = C * ll - C * lh, a1 = C * ll + C * lh;
    const float d0 = C * hl - C * hh, d1 = C * hl + C * hh;
    s[r * T + c] = C * a0 - C * d0;
    s[(r + st) * T + c] = C * a0 + C * d0;
    s[r * T + c + st] = C * a1 - C * d1;
    s[(r + st) * T + c + st] = C * a1 + C * d1;
}

// sign(v) * max(|v| - t, 0) (soft) or where(|v| > t, v, 0) (hard).
__device__ __forceinline__ float shrink(float v, float t, bool soft) {
    if (soft) {
        const float r = fmaxf(fabsf(v) - t, 0.0f);
        return v > 0.0f ? r : (v < 0.0f ? -r : 0.0f);
    }
    return fabsf(v) > t ? v : 0.0f;
}

__device__ __forceinline__ void load_tile(const float* __restrict__ x,
                                          float* s, int T, int w,
                                          size_t base) {
    for (int k = threadIdx.x; k < T * T; k += NT)
        s[k] = x[base + (size_t)(k / T) * w + (k % T)];
}

// One block per tile: levels 1..m in shared memory; per level and band the
// block's float64 sum of the squared coefficients into
// partials[img][block][3 * (level - 1) + band]; the tile's level-m LL into
// ll[img][ty][tx]; the finest HH into hh[img][H/2][W/2] when hh is given.
__global__ void __launch_bounds__(NT)
wavelet_analysis_kernel(const float* __restrict__ x, float* __restrict__ ll,
                        double* __restrict__ partials,
                        float* __restrict__ hh_out, int h, int w, int m) {
    __shared__ float s[MAX_T * MAX_T];
    __shared__ double sh[NT];
    const int T = 1 << m;
    const int img = blockIdx.z, ty = blockIdx.y, tx = blockIdx.x;
    const int tiles_x = gridDim.x, nblk = gridDim.x * gridDim.y;
    const size_t base = (size_t)img * h * w + (size_t)ty * T * w
                        + (size_t)tx * T;
    load_tile(x, s, T, w, base);
    __syncthreads();
    double* part = partials + ((size_t)img * nblk + (size_t)ty * tiles_x + tx)
                              * (3 * m);
    for (int lvl = 1; lvl <= m; ++lvl) {
        const int st = 1 << (lvl - 1), q = T >> lvl;
        double slh = 0.0, shl = 0.0, shh = 0.0;
        for (int k = threadIdx.x; k < q * q; k += NT) {
            const int r = (k / q) * 2 * st, c = (k % q) * 2 * st;
            float lh, hl, hh;
            haar_fwd(s, T, r, c, st, lh, hl, hh);
            slh += (double)(lh * lh);
            shl += (double)(hl * hl);
            shh += (double)(hh * hh);
            if (lvl == 1 && hh_out != nullptr) {
                const int half_w = w / 2;
                hh_out[(size_t)img * (h / 2) * half_w
                       + (size_t)(ty * T + r) / 2 * half_w
                       + (tx * T + c) / 2] = hh;
            }
        }
        slh = mdx::block_sum<double, NT>(slh, sh);
        shl = mdx::block_sum<double, NT>(shl, sh);
        shh = mdx::block_sum<double, NT>(shh, sh);
        if (threadIdx.x == 0) {
            part[3 * (lvl - 1) + 0] = slh;
            part[3 * (lvl - 1) + 1] = shl;
            part[3 * (lvl - 1) + 2] = shh;
        }
        // block_sum ends on a barrier: the level's writes are visible
    }
    if (threadIdx.x == 0)
        ll[(size_t)img * gridDim.y * tiles_x + (size_t)ty * tiles_x + tx] =
            s[0];
}

// One block per (band, image): the band's sum over the stage's blocks in a
// fixed order, its mean (float64, rounded once) and the threshold.
__global__ void __launch_bounds__(NT)
wavelet_threshold_kernel(const double* __restrict__ partials,
                         const float* __restrict__ sigma,
                         float* __restrict__ thr, int nblk, int m, int h,
                         int w) {
    __shared__ double sh[NT];
    const int band = blockIdx.x, img = blockIdx.y, nb = 3 * m;
    const double* p = partials + (size_t)img * nblk * nb + band;
    double acc = 0.0;
    for (int k = threadIdx.x; k < nblk; k += NT) acc += p[(size_t)k * nb];
    acc = mdx::block_sum<double, NT>(acc, sh);
    if (threadIdx.x != 0) return;
    const int lvl = band / 3 + 1;
    const double count = (double)(h >> lvl) * (double)(w >> lvl);
    const float dvar = (float)(acc / count);
    const float sg = sigma[img];
    const float nv = sg * sg;
    const float diff = dvar - nv;
    const float clamped = diff < EPS ? EPS : diff;   // torch.clamp_min
    thr[(size_t)img * nb + band] = nv / sqrtf(clamped);
}

// One block per tile: the analysis again, the tile's LL replaced by the
// denoised coarse LL (ll_new, when the stage has one above it), then per
// level from m down to 1 the shrink of the details and the inverse.
__global__ void __launch_bounds__(NT)
wavelet_synthesis_kernel(const float* __restrict__ x,
                         const float* __restrict__ ll_new,
                         const float* __restrict__ thr,
                         const unsigned char* __restrict__ soft,
                         float* __restrict__ out, int h, int w, int m) {
    __shared__ float s[MAX_T * MAX_T];
    const int T = 1 << m;
    const int img = blockIdx.z, ty = blockIdx.y, tx = blockIdx.x;
    const size_t base = (size_t)img * h * w + (size_t)ty * T * w
                        + (size_t)tx * T;
    load_tile(x, s, T, w, base);
    __syncthreads();
    for (int lvl = 1; lvl <= m; ++lvl) {
        const int st = 1 << (lvl - 1), q = T >> lvl;
        for (int k = threadIdx.x; k < q * q; k += NT) {
            float lh, hl, hh;
            haar_fwd(s, T, (k / q) * 2 * st, (k % q) * 2 * st, st, lh, hl,
                     hh);
        }
        __syncthreads();
    }
    if (ll_new != nullptr && threadIdx.x == 0)
        s[0] = ll_new[(size_t)img * gridDim.y * gridDim.x
                      + (size_t)ty * gridDim.x + tx];
    __syncthreads();
    const bool sft = soft[img] != 0;
    const float* t = thr + (size_t)img * 3 * m;
    for (int lvl = m; lvl >= 1; --lvl) {
        const int st = 1 << (lvl - 1), q = T >> lvl;
        const float tlh = t[3 * (lvl - 1)], thl = t[3 * (lvl - 1) + 1];
        const float thh = t[3 * (lvl - 1) + 2];
        for (int k = threadIdx.x; k < q * q; k += NT) {
            const int r = (k / q) * 2 * st, c = (k % q) * 2 * st;
            haar_inv(s, T, r, c, st, s[r * T + c],
                     shrink(s[r * T + c + st], tlh, sft),
                     shrink(s[(r + st) * T + c], thl, sft),
                     shrink(s[(r + st) * T + c + st], thh, sft));
        }
        __syncthreads();
    }
    for (int k = threadIdx.x; k < T * T; k += NT)
        out[base + (size_t)(k / T) * w + (k % T)] = s[k];
}

}  // namespace

// x: [n, h, w]; ll: [n, h/2^m, w/2^m]; partials: [n, tiles, 3m] float64;
// hh: [n, h/2, w/2] or null.  h and w divisible by 2^m, 1 <= m <= 5.
extern "C" int mdx_wavelet_analysis(const float* x, float* ll,
                                    double* partials, float* hh, int n,
                                    int h, int w, int m, void* stream) {
    if (m < 1 || m > MAX_M) return (int)cudaErrorInvalidValue;
    const int T = 1 << m;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid(w / T, h / T, n);
    wavelet_analysis_kernel<<<grid, NT, 0, st>>>(x, ll, partials, hh, h, w,
                                                 m);
    return (int)cudaGetLastError();
}

// thr: [n, 3m] from partials [n, nblk, 3m] and sigma [n].
extern "C" int mdx_wavelet_thresholds(const double* partials,
                                      const float* sigma, float* thr, int n,
                                      int nblk, int m, int h, int w,
                                      void* stream) {
    if (m < 1 || m > MAX_M) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    wavelet_threshold_kernel<<<dim3(3 * m, n), NT, 0, st>>>(
        partials, sigma, thr, nblk, m, h, w);
    return (int)cudaGetLastError();
}

// out: [n, h, w] from x, thr [n, 3m], soft [n] (bool) and ll_new
// [n, h/2^m, w/2^m] or null.
extern "C" int mdx_wavelet_synthesis(const float* x, const float* ll_new,
                                     const float* thr,
                                     const unsigned char* soft, float* out,
                                     int n, int h, int w, int m,
                                     void* stream) {
    if (m < 1 || m > MAX_M) return (int)cudaErrorInvalidValue;
    const int T = 1 << m;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid(w / T, h / T, n);
    wavelet_synthesis_kernel<<<grid, NT, 0, st>>>(x, ll_new, thr, soft, out,
                                                  h, w, m);
    return (int)cudaGetLastError();
}
