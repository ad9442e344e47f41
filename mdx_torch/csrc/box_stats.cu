// Box statistics of the metric pass: (std(sqrt(lv7)), mean(lv16), std(lv16))
// per image, lv = max(E[x^2] - E[x]^2, 0) over 7x7 and 16x16 SciPy
// uniform_filter windows (mirror pad, left-heavy even window).
//
// Replaces the TPU kernel mdx/ops/pallas_kernels.py box_stats_tpu /
// _box_stats_kernel / _k_sep_box, which keeps one whole padded image in
// VMEM.  A 512^2 image does not fit one SM's shared memory, so here:
//   1. box_maps_kernel: one block per 32x32 output tile, a 47x47 halo of
//      the mirror-padded image in shared memory (pad 8 before, 7 after;
//      the 7-window reads it at offset 5).  Row sums, x1/size, column
//      sums, x1/size: the order of mdx.ops.filters.box_filter.  Writes the
//      sqrt(lv7) and lv16 maps.
//   2. box_reduce_kernel: one block per image, two-pass (centred) mean and
//      population std of both maps, per-thread partials summed in a fixed
//      tree (no float atomics: the result is the same on every run).
// Bound: memory.  Pass 1 reads the image once (halo re-reads hit L2) and
// writes two maps; pass 2 reads the maps twice.  About 5 full-image f32
// passes of device memory traffic per image; fusing pass 2's first sweep
// into pass 1 is the next step.
#include "common.cuh"

namespace {

constexpr int BT = 32;          // output tile edge
constexpr int SP = BT + 15;     // padded tile edge: 8 before, 7 after
constexpr int RED_T = 1024;     // threads of the reduction block

__global__ void __launch_bounds__(256)
box_maps_kernel(const float* __restrict__ x, float* __restrict__ lv7s,
                float* __restrict__ lv16, int h, int w) {
    __shared__ float s[SP][SP + 1];
    __shared__ float r16[BT][SP + 1];
    __shared__ float r16q[BT][SP + 1];
    __shared__ float r7[BT][SP + 1];
    __shared__ float r7q[BT][SP + 1];

    const int img = blockIdx.z;
    const int i0 = blockIdx.y * BT;
    const int j0 = blockIdx.x * BT;
    const size_t plane = (size_t)h * w;
    const float* xi = x + img * plane;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nth = blockDim.x * blockDim.y;

    for (int k = tid; k < SP * SP; k += nth) {
        const int a = k / SP, b = k % SP;
        const int gi = mdx::sym_idx(i0 + a - 8, h);
        const int gj = mdx::sym_idx(j0 + b - 8, w);
        s[a][b] = xi[(size_t)gi * w + gj];
    }
    __syncthreads();

    const float inv16 = (float)(1.0 / 16.0);
    const float inv7 = (float)(1.0 / 7.0);
    // row pass (along H) over every padded column
    for (int k = tid; k < BT * SP; k += nth) {
        const int a = k / SP, b = k % SP;
        float v = s[a][b];
        float acc = v, accq = v * v;
        for (int t = 1; t < 16; ++t) {
            v = s[a + t][b];
            acc = acc + v;
            accq = accq + v * v;
        }
        r16[a][b] = acc * inv16;
        r16q[a][b] = accq * inv16;
        v = s[a + 5][b];
        acc = v;
        accq = v * v;
        for (int t = 1; t < 7; ++t) {
            v = s[a + 5 + t][b];
            acc = acc + v;
            accq = accq + v * v;
        }
        r7[a][b] = acc * inv7;
        r7q[a][b] = accq * inv7;
    }
    __syncthreads();

    // column pass (along W) and the local variances
    for (int k = tid; k < BT * BT; k += nth) {
        const int a = k / BT, c = k % BT;
        const int i = i0 + a, j = j0 + c;
        if (i >= h || j >= w) continue;
        float m = r16[a][c], mq = r16q[a][c];
        for (int t = 1; t < 16; ++t) {
            m = m + r16[a][c + t];
            mq = mq + r16q[a][c + t];
        }
        m = m * inv16;
        mq = mq * inv16;
        const float v16 = fmaxf(mq - m * m, 0.0f);
        float m7 = r7[a][c + 5], m7q = r7q[a][c + 5];
        for (int t = 1; t < 7; ++t) {
            m7 = m7 + r7[a][c + 5 + t];
            m7q = m7q + r7q[a][c + 5 + t];
        }
        m7 = m7 * inv7;
        m7q = m7q * inv7;
        const float v7 = fmaxf(m7q - m7 * m7, 0.0f);
        const size_t o = img * plane + (size_t)i * w + j;
        lv7s[o] = sqrtf(v7);
        lv16[o] = v16;
    }
}

__global__ void __launch_bounds__(RED_T)
box_reduce_kernel(const float* __restrict__ lv7s,
                  const float* __restrict__ lv16, float* __restrict__ out,
                  int hw) {
    __shared__ double sh[RED_T];
    const int img = blockIdx.x;
    const float* a = lv7s + (size_t)img * hw;
    const float* b = lv16 + (size_t)img * hw;
    const int tid = threadIdx.x;

    double sa = 0.0, sb = 0.0;
    for (int k = tid; k < hw; k += RED_T) {
        sa += a[k];
        sb += b[k];
    }
    const float mean7 = (float)(mdx::block_sum<double, RED_T>(sa, sh) / hw);
    const float mean16 = (float)(mdx::block_sum<double, RED_T>(sb, sh) / hw);

    double qa = 0.0, qb = 0.0;
    for (int k = tid; k < hw; k += RED_T) {
        const float da = a[k] - mean7;
        const float db = b[k] - mean16;
        qa += (double)(da * da);
        qb += (double)(db * db);
    }
    const double va = mdx::block_sum<double, RED_T>(qa, sh) / hw;
    const double vb = mdx::block_sum<double, RED_T>(qb, sh) / hw;
    if (tid == 0) {
        out[img * 3 + 0] = (float)sqrt(va);
        out[img * 3 + 1] = mean16;
        out[img * 3 + 2] = (float)sqrt(vb);
    }
}

}  // namespace

extern "C" int mdx_box_stats(const float* x, float* lv7s, float* lv16,
                             float* out, int n, int h, int w, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((w + BT - 1) / BT, (h + BT - 1) / BT, n);
    box_maps_kernel<<<grid, dim3(32, 8), 0, st>>>(x, lv7s, lv16, h, w);
    box_reduce_kernel<<<n, RED_T, 0, st>>>(lv7s, lv16, out, h * w);
    return (int)cudaGetLastError();
}
