// Unsharp mask: clip(x + (x - blur) * amount, 0, 1), blur = a 25-tap
// separable Gaussian with per-image taps on an edge (clamp) pad, along H
// first, then along W on the intermediate, taps in ascending order, each
// product and each sum rounded on its own (the plain version,
// mdx_torch.ops.filters.unsharp_mask_plain; NaN propagates through the
// clip as torch.clamp's does).
//
// Replaces the TPU kernels mdx/ops/pallas_kernels.py unsharp_tpu /
// _unsharp_kernel (one whole image in VMEM per grid step, taps masked, not
// skipped) and unsharp_banded_tpu (row bands of images above 1024^2): one
// kernel serves every size.
//
// Bound on this card: bytes (one read and one write of the image, 8 B a
// pixel; the float32 work is a few dozen operations a pixel).  What held
// the first design back was the work around the bytes: all 25 taps
// multiplied, 16 of them zeros at the bench radius 1.0; a row pass over the
// whole 56-column halo of a 32-column tile; two shared-memory loads a tap.
// This design:
// - The support comes from the taps: a block finds the span R of its
//   image's non-zero taps (0..12) and a block-uniform switch runs a body
//   templated on R, so the loops unroll over 2R + 1 taps.  Skipping a zero
//   tap is exact where the pixel it multiplies is finite (0 * v is +-0 and
//   acc +- 0 is acc, up to the sign of a zero).  The plain version spreads
//   a non-finite pixel over 12 pixels (0 * inf is NaN), so the block also
//   checks the ring between its R-halo and its 12-halo, and the values it
//   loads; where any is not finite (__syncthreads_or) it runs the same body
//   at R = 12, the plain version's 25 taps.
// - Register sliding windows: a 64 x 128 tile.  Along H a warp takes 32
//   neighbouring columns of a strip of 16 rows; each lane walks down its
//   column with the strip's 16 + 2R inputs in registers (coalesced 128-byte
//   rows, each input loaded once a strip) and writes the intermediate to
//   shared memory.  Along W a lane holds one row's 32 + 2R intermediate
//   values in registers and replaces them by its 32 outputs (the rows of a
//   warp sit at an odd pitch, so its loads hit 32 banks).  The blur goes
//   back to shared memory and a coalesced pass reads x and writes out.
// - The row pass's extra columns cost 2R / 128 (6 % at R = 4).
// - Interior blocks (the 12-halo inside the image) index without clamps;
//   only border blocks clamp.  A warp's 32 neighbouring floats are one
//   128-byte row already, so the loads stay scalar.
#include "common.cuh"

namespace {

constexpr int UR = 12;                  // tap radius (_GAUSS_MAX_RADIUS)
constexpr int NTAP = 2 * UR + 1;
constexpr int TH = 64;                  // output tile rows
constexpr int TW = 128;                 // output tile columns
constexpr int SH = 16;                  // rows of a strip in the row pass
constexpr int NT = 256;                 // threads a block
constexpr int RP = TW + 2 * UR + 1;     // pitch of the intermediate (odd)
constexpr int CHUNKS = (TW + 2 * UR + 31) / 32;
constexpr int STRIPS = TH / SH;
static_assert((TH / 32) * (TW / 32) == NT / 32,
              "the column pass takes a warp per 32 rows x 32 columns");

struct Tile {
    const float* xi;
    int h, w, i0, j0;
};

template <bool CLAMP>
__device__ __forceinline__ float load(const Tile& t, int i, int j) {
    if (CLAMP) {
        i = mdx::clamp_idx(i, t.h);
        j = mdx::clamp_idx(j, t.w);
    }
    return __ldg(t.xi + (size_t)i * t.w + j);
}

// The taps at offsets -R .. R: in registers up to R = 6, read from shared
// memory (a broadcast) above, which keeps the R = 12 path within the
// registers of three blocks an SM.
template <int R>
struct Taps {
    static constexpr bool REG = R <= 6;
    float v[REG ? 2 * R + 1 : 1];
    const float* s;
    __device__ explicit Taps(const float* tp_s) : s(tp_s + UR - R) {
        if constexpr (REG) {
#pragma unroll
            for (int q = 0; q <= 2 * R; ++q) v[q] = s[q];
        }
    }
    __device__ float operator()(int q) const {
        if constexpr (REG) return v[q];
        else return s[q];
    }
};

// Whether a value of the ring between the tile's R-halo and its 12-halo
// (clamped) is not finite.
template <int R>
__device__ bool ring_bad(const Tile& t) {
    constexpr int B = UR - R;           // the ring's width
    constexpr int W12 = TW + 2 * UR;
    bool bad = false;
    if constexpr (B > 0) {
#pragma unroll 4
        for (int k = threadIdx.x; k < 2 * B * W12; k += NT) {  // above, below
            const int b = k / W12, c = k % W12;
            const int i = b < B ? t.i0 - UR + b : t.i0 + TH + R + (b - B);
            bad |= !isfinite(load<true>(t, i, t.j0 - UR + c));
        }
#pragma unroll 4
        for (int k = threadIdx.x; k < (TH + 2 * R) * 2 * B; k += NT) {
            const int a = k / (2 * B), b = k % (2 * B);     // left, right
            const int j = b < B ? t.j0 - UR + b : t.j0 + TW + R + (b - B);
            bad |= !isfinite(load<true>(t, t.i0 - R + a, j));
        }
    }
    return bad;
}

// Along H at radius R: r[a][c] = the blur along H at image row i0 + a and
// image column j0 - R + c (clamped), c < TW + 2R.  Returns whether a value
// it read is not finite.
template <int R, bool CLAMP>
__device__ bool rows_pass(const Tile& t, const float* tp_s,
                          float (*r)[RP]) {
    constexpr int NC = TW + 2 * R;
    constexpr int NW = SH + 2 * R;
    const Taps<R> tp(tp_s);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    bool bad = false;
    for (int item = warp; item < CHUNKS * STRIPS; item += NT / 32) {
        const int c = (item % CHUNKS) * 32 + lane;
        const int a0 = (item / CHUNKS) * SH;
        if (c >= NC) continue;
        const int j = t.j0 - R + c;
        float win[NW];
#pragma unroll
        for (int m = 0; m < NW; ++m) {
            win[m] = load<CLAMP>(t, t.i0 + a0 - R + m, j);
            bad |= !isfinite(win[m]);
        }
#pragma unroll
        for (int k = 0; k < SH; ++k) {
            float acc = tp(0) * win[k];
#pragma unroll
            for (int q = 1; q <= 2 * R; ++q) acc = acc + tp(q) * win[k + q];
            r[a0 + k][c] = acc;
        }
    }
    return bad;
}

// Along W at radius R: warp w takes rows (w % 2) * 32 + lane and output
// columns (w / 2) * 32 .. + 31; the blur replaces r[a][0 .. TW).
template <int R>
__device__ void cols_pass(const float* tp_s, float (*r)[RP]) {
    constexpr int NW = 32 + 2 * R;
    const Taps<R> tp(tp_s);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int a = (warp % (TH / 32)) * 32 + lane;
    const int c0 = (warp / (TH / 32)) * 32;
    float win[NW];
#pragma unroll
    for (int m = 0; m < NW; ++m) win[m] = r[a][c0 + m];
#pragma unroll
    for (int k = 0; k < 32; ++k) {      // win[k] is not read after output k
        float acc = tp(0) * win[k];
#pragma unroll
        for (int q = 1; q <= 2 * R; ++q) acc = acc + tp(q) * win[k + q];
        win[k] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 32; ++k) r[a][c0 + k] = win[k];
}

// The blur of the tile at radius R into r[0 .. TH)[0 .. TW); false where a
// value within 12 of the tile is not finite (the caller then runs R = 12).
template <int R, bool CLAMP>
__device__ bool try_blur(const Tile& t, const float* tp_s, float (*r)[RP]) {
    bool bad = ring_bad<R>(t);
    bad |= rows_pass<R, CLAMP>(t, tp_s, r);
    if (__syncthreads_or(bad) && R < UR) return false;
    cols_pass<R>(tp_s, r);
    return true;
}

template <bool CLAMP>
__device__ bool blur_at(int R, const Tile& t, const float* tp_s,
                        float (*r)[RP]) {
    switch (R) {
        case 0: return try_blur<0, CLAMP>(t, tp_s, r);
        case 1: return try_blur<1, CLAMP>(t, tp_s, r);
        case 2: return try_blur<2, CLAMP>(t, tp_s, r);
        case 3: return try_blur<3, CLAMP>(t, tp_s, r);
        case 4: return try_blur<4, CLAMP>(t, tp_s, r);
        case 5: return try_blur<5, CLAMP>(t, tp_s, r);
        case 6: return try_blur<6, CLAMP>(t, tp_s, r);
        case 7: return try_blur<7, CLAMP>(t, tp_s, r);
        case 8: return try_blur<8, CLAMP>(t, tp_s, r);
        case 9: return try_blur<9, CLAMP>(t, tp_s, r);
        case 10: return try_blur<10, CLAMP>(t, tp_s, r);
        case 11: return try_blur<11, CLAMP>(t, tp_s, r);
        default: return try_blur<UR, CLAMP>(t, tp_s, r);
    }
}

__global__ void __launch_bounds__(NT, 3)
unsharp_kernel(const float* __restrict__ x, const float* __restrict__ taps,
               const float* __restrict__ amount, float* __restrict__ out,
               int h, int w) {
    __shared__ float r[TH][RP];
    __shared__ float tp_s[NTAP];

    const int img = blockIdx.z;
    const size_t plane = (size_t)h * w;
    const Tile t{x + img * plane, h, w, (int)blockIdx.y * TH,
                 (int)blockIdx.x * TW};
    if (threadIdx.x < NTAP) tp_s[threadIdx.x] = taps[img * NTAP + threadIdx.x];
    __syncthreads();
    int R = 0;                          // the span of the non-zero taps
    for (int q = 0; q < NTAP; ++q)
        if (tp_s[q] != 0.0f) R = max(R, abs(q - UR));   // NaN counts
    const bool interior = t.i0 >= UR && t.j0 >= UR && t.i0 + TH + UR <= h
                          && t.j0 + TW + UR <= w;
    const bool done = interior ? blur_at<false>(R, t, tp_s, r)
                               : blur_at<true>(R, t, tp_s, r);
    if (!done) {
        __syncthreads();
        if (interior) try_blur<UR, false>(t, tp_s, r);
        else try_blur<UR, true>(t, tp_s, r);
    }
    __syncthreads();

    // the combine, EB pixels a thread at a time, their loads issued first
    constexpr int EB = 8;
    const float amt = amount[img];
    for (int g = 0; g < TH * TW / NT; g += EB) {
        float xv[EB];
#pragma unroll
        for (int u = 0; u < EB; ++u) {
            const int k = (g + u) * NT + threadIdx.x;
            const int i = t.i0 + k / TW, j = t.j0 + k % TW;
            xv[u] = i < h && j < w ? __ldg(t.xi + (size_t)i * w + j) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < EB; ++u) {
            const int k = (g + u) * NT + threadIdx.x;
            const int a = k / TW, c = k % TW;
            const int i = t.i0 + a, j = t.j0 + c;
            if (i >= h || j >= w) continue;
            const float o = xv[u] + (xv[u] - r[a][c]) * amt;
            out[img * plane + (size_t)i * w + j] =
                o != o ? o : fminf(fmaxf(o, 0.0f), 1.0f);
        }
    }
}

}  // namespace

extern "C" int mdx_unsharp(const float* x, const float* taps,
                           const float* amount, float* out, int n, int h,
                           int w, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
    unsharp_kernel<<<grid, NT, 0, st>>>(x, taps, amount, out, h, w);
    return (int)cudaGetLastError();
}
