// Haar (db1) BayesShrink wavelet denoise of [N, H, W] float32: a levels-deep
// separable analysis (along H, then along W), per image and detail band the
// threshold t = s^2 / sqrt(max(mean(band^2) - s^2, eps)), soft or hard
// shrink per image, then the synthesis (along W, then along H).
//
// Replaces the TPU kernel mdx/ops/pallas_kernels.py wavelet_denoise_tpu /
// _wavelet_denoise_kernel, which keeps one whole image in VMEM per grid
// step (and carries a transpose bridge only because Mosaic rejects
// lane-splitting reshapes).  Nothing of that layout remains:
//   * Haar is local: a level-k coefficient depends only on its aligned
//     2^k x 2^k block of pixels.  A stage of m <= 5 levels works on
//     2^m x 2^m tiles.  Each thread loads one P x P patch (P = 4; P = 2
//     when m = 1) as P vector rows and runs the first log2(P) levels in
//     registers, with no shared memory and no barrier.
//   * The lanes of a tile number its patches in Z order (Morton: bit 2j of
//     the lane is x, bit 2j+1 is y, at level log2(P) + 1 + j).  The 2 x 2
//     group of a level's LL values is then a group of 4, 16 or 64 aligned
//     lanes; its lanes swap the values by __shfl_xor_sync and every lane
//     computes the same four coefficients.  Level 5 of a 32 x 32 tile spans
//     its two warps: that one exchange goes through shared memory, behind
//     one barrier.  A 256-thread block covers a 128-pixel-wide row of
//     tiles; an analysis block of a 5-level stage walks four such rows (128
//     x 128 pixels), loading the next row's patches while it computes the
//     current one, so its fixed cost below comes once a 128 x 128 region.
//   * BayesShrink couples each band across the whole image.  Each thread
//     sums its coefficients' squares in float64 registers, per level and
//     band (a coefficient shared by a lane group is counted by its first
//     lane).  A warp reduce-scatter (recursive halving over the padded band
//     count, 16 shuffles instead of 75 at m = 5) and one barrier give the
//     block's sums, which go to partials[img][band][block].  The last block
//     of each image, found by a ticket (__threadfence, then an integer
//     atomicAdd on a per-image counter), sums that image's partials in
//     block order (lane-strided, then a fixed shuffle tree), so the result
//     does not depend on which block ends last, and writes the band means
//     mean(band^2), each rounded once to float32.  No float atomics: two
//     runs are bit-equal.
//   * The synthesis launch derives the thresholds from those means and the
//     per-image sigma (so a sigma estimated between the launches, the MAD
//     of the finest HH that the first analysis writes out, needs no launch
//     of its own), recomputes the forward levels from x keeping each
//     detail in registers, puts the coarser stage's denoised LL in place of
//     the tile's LL, and inverts level by level, each lane taking its own
//     quadrant (no exchange on the way back).
//   * The levels past 5 run as further stages on the tile-level LL image
//     [N, H/2^m, W/2^m]; the wrapper (mdx_torch.kernels.wavelet_denoise)
//     orders them: analysis down the stages, synthesis back up, two
//     launches a stage, one workspace for every temporary.
// Rounding: the taps are the float32 values of the plain version
// (mdx_torch/ops/wavelet.py, _f32 of the PyWavelets constants) and every
// coefficient is the same rounded product-then-sum (--fmad=false), so the
// transforms match the plain version bit for bit.  Both versions square
// each coefficient in float32, sum per image and band in float64, divide
// in float64 and round once, so the thresholds agree too (to the last ulp
// of a float64 sum taken in another order).
// Bound: memory.  The function reads x once and writes out once (8 B a
// pixel); the kernels move 12 (x twice, out once) plus the small LL images
// and, when sigma is estimated, the finest HH (1 B a pixel).
#include "common.cuh"

namespace {

constexpr int NT = 256;                  // threads of every block
constexpr int NWARP = NT / 32;
constexpr int REGION_W = 128;            // pixels across a block's tiles
constexpr unsigned FULL = 0xffffffffu;
constexpr float C = 0.70710677f;         // float32(1/sqrt(2))
constexpr float EPS = 1.1920928955078125e-07f;  // float32 machine epsilon

// The layout of a stage of M levels.
template <int M>
struct Geo {
    static constexpr int R = M >= 2 ? 2 : 1;          // levels in registers
    static constexpr int P = 1 << R;                  // patch side
    static constexpr int G = 1 << (2 * (M - R));      // lanes of a tile
    static constexpr int T = 1 << M;                  // tile side
    static constexpr int TBX = REGION_W / T;          // tiles across a block
    static constexpr int TBY = NT / G / TBX;          // tiles down a block
    static constexpr int NB = 3 * M;                  // detail bands
    static constexpr int NB2 = NB <= 4 ? 4 : (NB <= 8 ? 8 : 16);
    // rows of tiles an analysis block walks (one a synthesis block): at
    // m = 5 four, so a block's fixed cost (its sums' reduction, the
    // partials store, the ticket) comes once a 128 x 128 region
    static constexpr int LOOP = M == 5 ? 4 : 1;
};

struct Quad {
    float ll, lh, hl, hh;
};

// One analysis step on a 2 x 2 block (p_rc: row r, column c).  dwt2's
// order: along H (rows), then along W.
__device__ __forceinline__ Quad fwd(float p00, float p01, float p10,
                                    float p11) {
    const float a0 = C * p00 + C * p10, d0 = C * p10 - C * p00;
    const float a1 = C * p01 + C * p11, d1 = C * p11 - C * p01;
    return {C * a0 + C * a1, C * a1 - C * a0, C * d0 + C * d1,
            C * d1 - C * d0};
}

// The inverse of fwd at quadrant (by, bx); idwt2's order: along W, then
// along H.  even = lo1*a + hi1*d = C*a - C*d, odd = lo0*a + hi0*d.
__device__ __forceinline__ float inv_at(float ll, float lh, float hl,
                                        float hh, bool by, bool bx) {
    const float a = bx ? C * ll + C * lh : C * ll - C * lh;
    const float d = bx ? C * hl + C * hh : C * hl - C * hh;
    return by ? C * a + C * d : C * a - C * d;
}

// sign(v) * max(|v| - t, 0) (soft) or where(|v| > t, v, 0) (hard).
__device__ __forceinline__ float shrink(float v, float t, bool soft) {
    if (soft) {
        const float r = fmaxf(fabsf(v) - t, 0.0f);
        return v > 0.0f ? r : (v < 0.0f ? -r : 0.0f);
    }
    return fabsf(v) > t ? v : 0.0f;
}

// Where a thread's patch lies in the block's row of tiles ``row`` (in
// units of TBY tile rows): lane g of tile (tx, ty), its patch's top left
// pixel (y0, x0), and whether the tile is inside the image.
template <int M>
struct Place {
    int g, tb, tx, ty, y0, x0;
    bool inside;
    __device__ __forceinline__ Place(int tiles_x, int tiles_y, int row) {
        using Gm = Geo<M>;
        tb = threadIdx.x / Gm::G;
        g = threadIdx.x % Gm::G;
        tx = blockIdx.x * Gm::TBX + tb % Gm::TBX;
        ty = row * Gm::TBY + tb / Gm::TBX;
        const int px = (g & 1) | ((g >> 1) & 2) | ((g >> 2) & 4);
        const int py = ((g >> 1) & 1) | ((g >> 2) & 2) | ((g >> 3) & 4);
        x0 = tx * Gm::T + px * Gm::P;
        y0 = ty * Gm::T + py * Gm::P;
        inside = tx < tiles_x && ty < tiles_y;
    }
};

// The patch as P rows of P floats (zeros outside the image, whose lanes
// still take part in every exchange).
template <int P>
__device__ __forceinline__ void load_patch(const float* __restrict__ src,
                                           int w, bool inside,
                                           float (&v)[P][P]) {
#pragma unroll
    for (int r = 0; r < P; ++r) {
        if constexpr (P == 4) {
            const float4 q = inside ? __ldg(reinterpret_cast<const float4*>(
                                          src + (size_t)r * w))
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
            v[r][0] = q.x; v[r][1] = q.y; v[r][2] = q.z; v[r][3] = q.w;
        } else {
            const float2 q = inside ? __ldg(reinterpret_cast<const float2*>(
                                          src + (size_t)r * w))
                                    : make_float2(0.f, 0.f);
            v[r][0] = q.x; v[r][1] = q.y;
        }
    }
}

template <int P>
__device__ __forceinline__ void store_patch(float* __restrict__ dst, int w,
                                            const float (&v)[P][P]) {
#pragma unroll
    for (int r = 0; r < P; ++r) {
        if constexpr (P == 4)
            *reinterpret_cast<float4*>(dst + (size_t)r * w) =
                make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
        else
            *reinterpret_cast<float2*>(dst + (size_t)r * w) =
                make_float2(v[r][0], v[r][1]);
    }
}

// Level log2(P) + 1 + j on the lane group's LL values: the four values of
// the 2 x 2 group (swapped by shuffles within a warp; through shared memory
// s4 across the two warps of a 32 x 32 tile), then the analysis step, the
// same in every lane of the group.
__device__ __forceinline__ Quad level_up(float v, int g, int tb, int j,
                                         float (*s4)[4]) {
    const int xm = 1 << (2 * j), ym = xm << 1;
    const bool bx = (g & xm) != 0, by = (g & ym) != 0;
    float p00, p01, p10, p11;
    if (ym < 32) {
        const float vx = __shfl_xor_sync(FULL, v, xm);
        const float vy = __shfl_xor_sync(FULL, v, ym);
        const float vxy = __shfl_xor_sync(FULL, v, xm | ym);
        p00 = bx ? (by ? vxy : vx) : (by ? vy : v);
        p01 = bx ? (by ? vy : v) : (by ? vxy : vx);
        p10 = bx ? (by ? vx : vxy) : (by ? v : vy);
        p11 = bx ? (by ? v : vy) : (by ? vx : vxy);
    } else {
        if ((g & (xm - 1)) == 0) s4[tb][(by ? 2 : 0) + (bx ? 1 : 0)] = v;
        __syncthreads();
        p00 = s4[tb][0]; p01 = s4[tb][1]; p10 = s4[tb][2]; p11 = s4[tb][3];
    }
    return fwd(p00, p01, p10, p11);
}

// Warp reduce-scatter of NB2 per-lane sums: at offset O = 16, 8, ... each
// lane keeps HALF of its slots and adds its partner's copy of them (one
// template level a step, so every index is a constant and the sums stay
// in registers); then a butterfly over the lanes that share a slot.  Lane
// l ends with the warp's sum of slot l / (32 / NB2).  A fixed data flow:
// the order never changes.
template <int NB2, int HALF, int O>
struct Scatter {
    static __device__ __forceinline__ void run(double (&v)[NB2], int lane) {
        const bool upper = (lane & O) != 0;
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
            const double send = upper ? v[i] : v[i + HALF];
            const double keep = upper ? v[i + HALF] : v[i];
            v[i] = keep + __shfl_xor_sync(FULL, send, O);
        }
        Scatter<NB2, HALF / 2, O / 2>::run(v, lane);
    }
};

template <int NB2, int O>
struct Scatter<NB2, 0, O> {
    static __device__ __forceinline__ void run(double (&)[NB2], int) {}
};

template <int NB2>
__device__ __forceinline__ double warp_reduce_scatter(double (&v)[NB2],
                                                      int lane) {
    Scatter<NB2, NB2 / 2, 16>::run(v, lane);
    double r = v[0];
#pragma unroll
    for (int o = 16 / NB2; o >= 1; o >>= 1) r = r + __shfl_xor_sync(FULL, r, o);
    return r;
}

__device__ __forceinline__ double warp_sum(double r) {
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) r = r + __shfl_xor_sync(FULL, r, o);
    return r;
}

// Levels 1..M of one thread's patch v at pl: the squares of its
// coefficients into sums (float64, per level and band; a coefficient that
// a lane group shares by its first lane), its finest HH into hh_out and
// its tile's level-M LL into ll (each when given).  s4: the shared slots of
// the level-5 exchange.
template <int M>
__device__ __forceinline__ void analyse_patch(
    const float (&v)[Geo<M>::P][Geo<M>::P], const Place<M>& pl,
    double (&sums)[Geo<M>::NB2], float (*s4)[4], float* __restrict__ ll,
    float* __restrict__ hh_out, int img, int h, int w) {
    using Gm = Geo<M>;
    constexpr int Q = Gm::P / 2;
    const int tiles_x = w >> M, tiles_y = h >> M;
    float l1[Q][Q];
    float hh1[Q][Q];
#pragma unroll
    for (int qr = 0; qr < Q; ++qr)
#pragma unroll
        for (int qc = 0; qc < Q; ++qc) {
            const Quad q = fwd(v[2 * qr][2 * qc], v[2 * qr][2 * qc + 1],
                               v[2 * qr + 1][2 * qc], v[2 * qr + 1][2 * qc + 1]);
            l1[qr][qc] = q.ll;
            hh1[qr][qc] = q.hh;
            sums[0] += (double)(q.lh * q.lh);
            sums[1] += (double)(q.hl * q.hl);
            sums[2] += (double)(q.hh * q.hh);
        }
    if (hh_out != nullptr && pl.inside) {
        float* dst = hh_out + (size_t)img * (h / 2) * (w / 2)
                     + (size_t)(pl.y0 / 2) * (w / 2) + pl.x0 / 2;
#pragma unroll
        for (int qr = 0; qr < Q; ++qr) {
            if constexpr (Q == 2)
                *reinterpret_cast<float2*>(dst + (size_t)qr * (w / 2)) =
                    make_float2(hh1[qr][0], hh1[qr][1]);
            else
                dst[0] = hh1[0][0];
        }
    }
    float cur = l1[0][0];
    if constexpr (Gm::R == 2) {
        const Quad q = fwd(l1[0][0], l1[0][1], l1[1][0], l1[1][1]);
        cur = q.ll;
        sums[3] += (double)(q.lh * q.lh);
        sums[4] += (double)(q.hl * q.hl);
        sums[5] += (double)(q.hh * q.hh);
    }
#pragma unroll
    for (int j = 0; j < M - Gm::R; ++j) {
        const Quad q = level_up(cur, pl.g, pl.tb, j, s4);
        cur = q.ll;
        if ((pl.g & ((4 << (2 * j)) - 1)) == 0) {   // the group's first lane
            const int b = 3 * (Gm::R + j);
            sums[b] += (double)(q.lh * q.lh);
            sums[b + 1] += (double)(q.hl * q.hl);
            sums[b + 2] += (double)(q.hh * q.hh);
        }
    }
    if (ll != nullptr && pl.inside && pl.g == 0)
        ll[(size_t)img * tiles_y * tiles_x + (size_t)pl.ty * tiles_x + pl.tx] =
            cur;
}

// One block per LOOP rows of 128-pixel-wide rows of tiles of a stage of M
// levels, the next row's patches loading while the current row computes:
// levels 1..M; each band's float64 sum of squares per block into
// partials[img][band][block]; the last block of the image (ticket[img])
// writes the band means dvar[img][band]; the tiles' level-M LL into
// ll[img][ty][tx] (when given); the finest HH into hh[img][H/2][W/2]
// (when given).
template <int M>
__global__ void __launch_bounds__(NT)
wavelet_analysis_kernel(const float* __restrict__ x, float* __restrict__ ll,
                        double* __restrict__ partials,
                        float* __restrict__ dvar, int* __restrict__ ticket,
                        float* __restrict__ hh_out, int h, int w) {
    using Gm = Geo<M>;
    constexpr int P = Gm::P, LOOP = Gm::LOOP;
    __shared__ float s4[2][4][4];       // one per parity of the row walked
    __shared__ double s_part[NWARP][Gm::NB];
    __shared__ int s_last;
    const int img = blockIdx.z;
    const int tiles_x = w >> M, tiles_y = h >> M;
    const float* xi = x + (size_t)img * h * w;
    Place<M> pl(tiles_x, tiles_y, blockIdx.y * LOOP);
    float v[P][P];
    load_patch<P>(xi + (size_t)pl.y0 * w + pl.x0, w, pl.inside, v);
    double sums[Gm::NB2];
#pragma unroll
    for (int i = 0; i < Gm::NB2; ++i) sums[i] = 0.0;
#pragma unroll
    for (int it = 0; it < LOOP; ++it) {
        if (it + 1 < LOOP) {
            const Place<M> pn(tiles_x, tiles_y, blockIdx.y * LOOP + it + 1);
            float vn[P][P];
            load_patch<P>(xi + (size_t)pn.y0 * w + pn.x0, w, pn.inside, vn);
            analyse_patch<M>(v, pl, sums, s4[it & 1], ll, hh_out, img, h, w);
            pl = pn;
#pragma unroll
            for (int r = 0; r < P; ++r)
#pragma unroll
                for (int c = 0; c < P; ++c) v[r][c] = vn[r][c];
        } else {
            analyse_patch<M>(v, pl, sums, s4[it & 1], ll, hh_out, img, h, w);
        }
    }

    // the block's sums: warps, then the warps in order
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int SPAN = 32 / Gm::NB2;
    const double r = warp_reduce_scatter<Gm::NB2>(sums, lane);
    if (lane % SPAN == 0 && lane / SPAN < Gm::NB) s_part[warp][lane / SPAN] = r;
    __syncthreads();
    const int nblk = gridDim.x * gridDim.y;
    double* pimg = partials + (size_t)img * Gm::NB * nblk;
    if (threadIdx.x < Gm::NB) {
        double acc = 0.0;
#pragma unroll
        for (int k = 0; k < NWARP; ++k) acc += s_part[k][threadIdx.x];
        pimg[(size_t)threadIdx.x * nblk + blockIdx.y * gridDim.x + blockIdx.x] =
            acc;
        __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(&ticket[img], 1) == nblk - 1;
    __syncthreads();
    if (!s_last) return;

    // the image's last block: each band's sum over the blocks in block
    // order, its mean (float64, rounded once)
    __threadfence();
    for (int b = warp; b < Gm::NB; b += NWARP) {
        const double* p = pimg + (size_t)b * nblk;
        double acc = 0.0;
#pragma unroll 8
        for (int k = lane; k < nblk; k += 32) acc += __ldcg(p + k);
        acc = warp_sum(acc);
        if (lane == 0) {
            const int lvl = b / 3 + 1;
            const double count = (double)(h >> lvl) * (double)(w >> lvl);
            dvar[(size_t)img * Gm::NB + b] = (float)(acc / count);
        }
    }
}

// One block per 128-pixel-wide row of tiles: the thresholds from the band
// means and sigma, the forward levels again (each detail kept in
// registers), the tile's LL replaced by the denoised coarse LL (ll_new,
// when the stage has one above it), then per level from M down to 1 the
// shrink of the details and the inverse.
template <int M>
__global__ void __launch_bounds__(NT)
wavelet_synthesis_kernel(const float* __restrict__ x,
                         const float* __restrict__ ll_new,
                         const float* __restrict__ dvar,
                         const float* __restrict__ sigma,
                         const unsigned char* __restrict__ soft,
                         float* __restrict__ out, int h, int w) {
    using Gm = Geo<M>;
    constexpr int P = Gm::P, Q = P / 2, NJ = M - Gm::R;
    __shared__ float s4[4][4];
    __shared__ float s_thr[Gm::NB];
    const int img = blockIdx.z;
    const int tiles_x = w >> M, tiles_y = h >> M;
    const Place<M> pl(tiles_x, tiles_y, blockIdx.y);
    const size_t off = (size_t)img * h * w + (size_t)pl.y0 * w + pl.x0;
    float v[P][P];
    load_patch<P>(x + off, w, pl.inside, v);
    if (threadIdx.x < Gm::NB) {
        const float sg = sigma[img];
        const float nv = sg * sg;
        const float diff = dvar[(size_t)img * Gm::NB + threadIdx.x] - nv;
        const float clamped = diff < EPS ? EPS : diff;   // torch.clamp_min
        s_thr[threadIdx.x] = nv / sqrtf(clamped);
    }
    __syncthreads();

    Quad d1[Q][Q];
#pragma unroll
    for (int qr = 0; qr < Q; ++qr)
#pragma unroll
        for (int qc = 0; qc < Q; ++qc)
            d1[qr][qc] = fwd(v[2 * qr][2 * qc], v[2 * qr][2 * qc + 1],
                             v[2 * qr + 1][2 * qc], v[2 * qr + 1][2 * qc + 1]);
    Quad d2 = d1[0][0];
    float cur = d1[0][0].ll;
    if constexpr (Gm::R == 2) {
        d2 = fwd(d1[0][0].ll, d1[0][1].ll, d1[1][0].ll, d1[1][1].ll);
        cur = d2.ll;
    }
    Quad dj[NJ > 0 ? NJ : 1];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        dj[j] = level_up(cur, pl.g, pl.tb, j, s4);
        cur = dj[j].ll;
    }
    if (ll_new != nullptr && pl.inside)
        cur = ll_new[(size_t)img * tiles_y * tiles_x
                     + (size_t)pl.ty * tiles_x + pl.tx];

    const bool sft = soft[img] != 0;
#pragma unroll
    for (int j = NJ - 1; j >= 0; --j) {
        const int xm = 1 << (2 * j), b = 3 * (Gm::R + j);
        cur = inv_at(cur, shrink(dj[j].lh, s_thr[b], sft),
                     shrink(dj[j].hl, s_thr[b + 1], sft),
                     shrink(dj[j].hh, s_thr[b + 2], sft),
                     (pl.g & (xm << 1)) != 0, (pl.g & xm) != 0);
    }
    float l1[Q][Q];
    if constexpr (Gm::R == 2) {
        const float lh = shrink(d2.lh, s_thr[3], sft);
        const float hl = shrink(d2.hl, s_thr[4], sft);
        const float hh = shrink(d2.hh, s_thr[5], sft);
#pragma unroll
        for (int qr = 0; qr < Q; ++qr)
#pragma unroll
            for (int qc = 0; qc < Q; ++qc)
                l1[qr][qc] = inv_at(cur, lh, hl, hh, qr != 0, qc != 0);
    } else {
        l1[0][0] = cur;
    }
#pragma unroll
    for (int qr = 0; qr < Q; ++qr)
#pragma unroll
        for (int qc = 0; qc < Q; ++qc) {
            const float lh = shrink(d1[qr][qc].lh, s_thr[0], sft);
            const float hl = shrink(d1[qr][qc].hl, s_thr[1], sft);
            const float hh = shrink(d1[qr][qc].hh, s_thr[2], sft);
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int c = 0; c < 2; ++c)
                    v[2 * qr + r][2 * qc + c] =
                        inv_at(l1[qr][qc], lh, hl, hh, r != 0, c != 0);
        }
    if (pl.inside) store_patch<P>(out + off, w, v);
}

// loop: the rows of tiles a block walks (Geo<M>::LOOP for the analysis,
// 1 for the synthesis)
template <int M>
dim3 stage_grid(int n, int h, int w, int loop) {
    using Gm = Geo<M>;
    const int tiles_x = w >> M, tiles_y = h >> M;
    return dim3((tiles_x + Gm::TBX - 1) / Gm::TBX,
                (tiles_y + Gm::TBY * loop - 1) / (Gm::TBY * loop), n);
}

template <int M>
int analysis(const float* x, float* ll, double* partials, float* dvar,
             int* ticket, float* hh, int n, int h, int w, int nblk,
             cudaStream_t st) {
    const dim3 grid = stage_grid<M>(n, h, w, Geo<M>::LOOP);
    if ((int)(grid.x * grid.y) != nblk) return (int)cudaErrorInvalidValue;
    wavelet_analysis_kernel<M><<<grid, NT, 0, st>>>(x, ll, partials, dvar,
                                                    ticket, hh, h, w);
    return (int)cudaGetLastError();
}

template <int M>
int synthesis(const float* x, const float* ll_new, const float* dvar,
              const float* sigma, const unsigned char* soft, float* out,
              int n, int h, int w, cudaStream_t st) {
    wavelet_synthesis_kernel<M><<<stage_grid<M>(n, h, w, 1), NT, 0, st>>>(
        x, ll_new, dvar, sigma, soft, out, h, w);
    return (int)cudaGetLastError();
}

}  // namespace

// One stage's analysis.  x: [n, h, w]; ll: [n, h/2^m, w/2^m] or null;
// partials: [n, 3m, nblk] float64 (nblk: the stage's blocks, as
// mdx_torch.kernels computes them; checked); dvar: [n, 3m]; ticket: [n]
// int, zero on entry: the first zero_tickets ints from ticket on are
// cleared first (one memset for every stage's counters); hh: [n, h/2, w/2]
// or null.  h and w divisible by 2^m, 1 <= m <= 5.
extern "C" int mdx_wavelet_analysis(const float* x, float* ll,
                                    double* partials, float* dvar,
                                    int* ticket, int zero_tickets, float* hh,
                                    int n, int h, int w, int m, int nblk,
                                    void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (zero_tickets > 0) {
        const cudaError_t e = cudaMemsetAsync(
            ticket, 0, (size_t)zero_tickets * sizeof(int), st);
        if (e != cudaSuccess) return (int)e;
    }
    switch (m) {
        case 1: return analysis<1>(x, ll, partials, dvar, ticket, hh, n, h, w, nblk, st);
        case 2: return analysis<2>(x, ll, partials, dvar, ticket, hh, n, h, w, nblk, st);
        case 3: return analysis<3>(x, ll, partials, dvar, ticket, hh, n, h, w, nblk, st);
        case 4: return analysis<4>(x, ll, partials, dvar, ticket, hh, n, h, w, nblk, st);
        case 5: return analysis<5>(x, ll, partials, dvar, ticket, hh, n, h, w, nblk, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// One stage's synthesis: out [n, h, w] from x, the band means dvar [n, 3m],
// sigma [n], soft [n] (bool) and ll_new [n, h/2^m, w/2^m] or null.
extern "C" int mdx_wavelet_synthesis(const float* x, const float* ll_new,
                                     const float* dvar, const float* sigma,
                                     const unsigned char* soft, float* out,
                                     int n, int h, int w, int m,
                                     void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (m) {
        case 1: return synthesis<1>(x, ll_new, dvar, sigma, soft, out, n, h, w, st);
        case 2: return synthesis<2>(x, ll_new, dvar, sigma, soft, out, n, h, w, st);
        case 3: return synthesis<3>(x, ll_new, dvar, sigma, soft, out, n, h, w, st);
        case 4: return synthesis<4>(x, ll_new, dvar, sigma, soft, out, n, h, w, st);
        case 5: return synthesis<5>(x, ll_new, dvar, sigma, soft, out, n, h, w, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
