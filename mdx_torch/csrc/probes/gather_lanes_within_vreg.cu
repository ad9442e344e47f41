// in [8, 128] -> out [8, 128]: each row reversed.  One warp a row, the row
// 4 to a lane, gathered by shuffles.
#include "probe.cuh"

__global__ void __launch_bounds__(32) k(const float* __restrict__ in,
                                        float* __restrict__ out) {
    const int r = blockIdx.x, lane = threadIdx.x;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = in[r * 128 + lane + 32 * q];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        out[r * 128 + c] = probe::warp_gather<4>(v, 127 - c);
    }
}

MDX_PROBE_ENTRY(k, 8, 32)
