// Box statistics of the metric pass: (std(sqrt(lv7)), mean(lv16), std(lv16))
// per image, lv = max(E[x^2] - E[x]^2, 0) over 7x7 and 16x16 SciPy
// uniform_filter windows (mirror pad, left-heavy even window).
//
// Replaces the TPU kernel mdx/ops/pallas_kernels.py box_stats_tpu /
// _box_stats_kernel / _k_sep_box, which keeps one whole padded image in
// VMEM.  A 512^2 image does not fit one SM's shared memory, so the maps are
// made per tile and never stored: one pass over x.
//   1. box_fused_kernel: one block per 32x32 output tile, a 47x47 halo of
//      the mirror-padded image in shared memory (pad 8 before, 7 after; the
//      7-window reads it at offset 5).  Row sums, x1/size, column sums,
//      x1/size: the order of mdx.ops.filters.box_filter, so each pixel's
//      sqrt(lv7) (a) and lv16 (b) are the plain version's float32 values.
//      They are reduced in registers and a fixed shared-memory tree to four
//      float64 partials per block: sum a, sum a^2, sum b, sum b^2.  A
//      thread sums 4 neighbouring windows (4 rows in the row pass, 4
//      columns in the column pass) from taps it loads once, each window
//      still in box_filter's order.
//   2. box_finalize_kernel: one block per image sums its blocks' partials
//      in a fixed order and forms mean = sum / n and the population
//      variance sum^2 / n - mean^2 in float64, each result rounded to
//      float32 once.  Float64 leaves a relative error of about
//      1e-16 * mean^2 / var, far inside KERNEL_TOL's 1e-6 (the two-sweep
//      form, the maps recomputed in a second read of x for centred
//      deviations, would be the answer to a breach; none is measured).
// No float atomics, and the blocks depend only on the image size, so the
// result is the same on every run.
// Bound: operations (the 7x7 and 16x16 sums of x and x^2 both ways, about
// 130 float32 operations a pixel) against one read of x; two launches,
// no maps in device memory (the design before read and wrote about five
// image-sized float32 passes in five launches).  On an H100 the kernel is
// bound by its instructions, not bytes: the 4-window blocking took 0.165
// to 0.142 ms at 32 x 512^2, and finding each padded row's and column's
// source index once (the mirror's integer remainders only at the image's
// edges) instead of per cell took it to 0.108 (PERF.md).
#include "common.cuh"

namespace {

constexpr int BT = 32;          // output tile edge
constexpr int SP = BT + 15;     // padded tile edge: 8 before, 7 after
// row stride of the shared arrays: 49 = 17 (mod 32), so the column pass's
// 32 lanes, one per row, read 32 different banks
constexpr int LD = SP + 2;
constexpr int BOX_T = 256;      // threads of a tile block (32 x 8)
constexpr int RED_T = 256;      // threads of the finalize block
constexpr int RR = 4;           // rows a thread sums in the row pass
constexpr int CC = 4;           // columns a thread sums in the column pass

// The mirror-padded source index (mdx::sym_idx) of i, which is i itself
// inside the image.
__device__ __forceinline__ int pad_idx(int i, int n) {
    return (unsigned)i < (unsigned)n ? i : mdx::sym_idx(i, n);
}

// Each window sum in box_filter's order (the first tap, then the others
// one by one), for n outputs whose windows start at v[i], i < n: the
// taps are loaded once for all of them.
template <int N, int TAPS>
__device__ __forceinline__ void window_sums(const float (&v)[N + TAPS - 1],
                                            float (&acc)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        float a = v[i];
#pragma unroll
        for (int t = 1; t < TAPS; ++t) a = a + v[i + t];
        acc[i] = a;
    }
}

__global__ void __launch_bounds__(BOX_T)
box_fused_kernel(const float* __restrict__ x, double* __restrict__ partials,
                 int h, int w) {
    __shared__ float s[SP][LD];
    __shared__ float r16[BT][LD];
    __shared__ float r16q[BT][LD];
    __shared__ float r7[BT][LD];
    __shared__ float r7q[BT][LD];
    __shared__ double sh[BOX_T];

    const int img = blockIdx.z;
    const int i0 = blockIdx.y * BT;
    const int j0 = blockIdx.x * BT;
    const size_t plane = (size_t)h * w;
    const float* xi = x + img * plane;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;

    // the padded tile: a thread's two source columns once, then a source
    // row per padded row (the mirror only at the image's edges)
    const int b1 = threadIdx.x + 32;
    const int gj0 = pad_idx(j0 + (int)threadIdx.x - 8, w);
    const int gj1 = b1 < SP ? pad_idx(j0 + b1 - 8, w) : 0;
    for (int a = threadIdx.y; a < SP; a += BOX_T / 32) {
        const float* row = xi + (size_t)pad_idx(i0 + a - 8, h) * w;
        s[a][threadIdx.x] = row[gj0];
        if (b1 < SP) s[a][b1] = row[gj1];
    }
    __syncthreads();

    const float inv16 = (float)(1.0 / 16.0);
    const float inv7 = (float)(1.0 / 7.0);
    // row pass (along H) over every padded column: RR output rows a thread
    for (int k = tid; k < (BT / RR) * SP; k += BOX_T) {
        const int a0 = (k / SP) * RR, b = k % SP;
        float v[RR + 15], q[RR + 15];
#pragma unroll
        for (int t = 0; t < RR + 15; ++t) {
            v[t] = s[a0 + t][b];
            q[t] = v[t] * v[t];
        }
        float m16[RR], q16[RR];
        window_sums<RR, 16>(v, m16);
        window_sums<RR, 16>(q, q16);
        float v7[RR + 6], q7[RR + 6];
#pragma unroll
        for (int t = 0; t < RR + 6; ++t) {
            v7[t] = v[t + 5];
            q7[t] = q[t + 5];
        }
        float m7[RR], qq7[RR];
        window_sums<RR, 7>(v7, m7);
        window_sums<RR, 7>(q7, qq7);
#pragma unroll
        for (int i = 0; i < RR; ++i) {
            r16[a0 + i][b] = m16[i] * inv16;
            r16q[a0 + i][b] = q16[i] * inv16;
            r7[a0 + i][b] = m7[i] * inv7;
            r7q[a0 + i][b] = qq7[i] * inv7;
        }
    }
    __syncthreads();

    // column pass (along W): lane = output row, CC output columns a
    // thread; the local variances and their float64 sums
    const int a = threadIdx.x, c0 = threadIdx.y * CC;
    float m[CC], mq[CC], m7[CC], m7q[CC];
    {
        float v[CC + 15];
#pragma unroll
        for (int t = 0; t < CC + 15; ++t) v[t] = r16[a][c0 + t];
        window_sums<CC, 16>(v, m);
#pragma unroll
        for (int t = 0; t < CC + 15; ++t) v[t] = r16q[a][c0 + t];
        window_sums<CC, 16>(v, mq);
    }
    {
        float v[CC + 6];
#pragma unroll
        for (int t = 0; t < CC + 6; ++t) v[t] = r7[a][c0 + 5 + t];
        window_sums<CC, 7>(v, m7);
#pragma unroll
        for (int t = 0; t < CC + 6; ++t) v[t] = r7q[a][c0 + 5 + t];
        window_sums<CC, 7>(v, m7q);
    }
    double sa = 0.0, saa = 0.0, sb = 0.0, sbb = 0.0;
#pragma unroll
    for (int i = 0; i < CC; ++i) {
        if (i0 + a >= h || j0 + c0 + i >= w) continue;
        const float mm = m[i] * inv16, mmq = mq[i] * inv16;
        const float v16 = fmaxf(mmq - mm * mm, 0.0f);
        const float n7 = m7[i] * inv7, n7q = m7q[i] * inv7;
        const double v7s = (double)sqrtf(fmaxf(n7q - n7 * n7, 0.0f));
        sa += v7s;
        saa += v7s * v7s;
        sb += (double)v16;
        sbb += (double)v16 * (double)v16;
    }
    sa = mdx::block_sum<double, BOX_T>(sa, sh);
    saa = mdx::block_sum<double, BOX_T>(saa, sh);
    sb = mdx::block_sum<double, BOX_T>(sb, sh);
    sbb = mdx::block_sum<double, BOX_T>(sbb, sh);
    if (tid == 0) {
        const size_t blk = (size_t)img * gridDim.x * gridDim.y
                           + blockIdx.y * gridDim.x + blockIdx.x;
        double* p = partials + 4 * blk;
        p[0] = sa;
        p[1] = saa;
        p[2] = sb;
        p[3] = sbb;
    }
}

// The image's four sums over its blocks in a fixed order → out [n, 3]:
// std(sqrt(lv7)), mean(lv16), std(lv16) (population std).
__global__ void __launch_bounds__(RED_T)
box_finalize_kernel(const double* __restrict__ partials,
                    float* __restrict__ out, int hw, int nblk) {
    __shared__ double sh[RED_T];
    const double* p = partials + (size_t)blockIdx.x * nblk * 4;
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    for (int k = threadIdx.x; k < nblk; k += RED_T) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += p[4 * k + e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
        acc[e] = mdx::block_sum<double, RED_T>(acc[e], sh);
    if (threadIdx.x != 0) return;
    const double mean_a = acc[0] / hw, mean_b = acc[2] / hw;
    const double var_a = fmax(acc[1] / hw - mean_a * mean_a, 0.0);
    const double var_b = fmax(acc[3] / hw - mean_b * mean_b, 0.0);
    float* o = out + blockIdx.x * 3;
    o[0] = (float)sqrt(var_a);
    o[1] = (float)mean_b;
    o[2] = (float)sqrt(var_b);
}

}  // namespace

// partials: [n, nblk, 4] float64 scratch with nblk = ceil(h/32) *
// ceil(w/32); out: [n, 3].  Both allocated by the caller.
extern "C" int mdx_box_stats(const float* x, double* partials, float* out,
                             int n, int h, int w, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((w + BT - 1) / BT, (h + BT - 1) / BT, n);
    box_fused_kernel<<<grid, dim3(32, BOX_T / 32), 0, st>>>(x, partials, h,
                                                            w);
    box_finalize_kernel<<<n, RED_T, 0, st>>>(partials, out, h * w,
                                             grid.x * grid.y);
    return (int)cudaGetLastError();
}
