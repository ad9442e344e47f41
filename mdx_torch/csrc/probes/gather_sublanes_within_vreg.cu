// in [8, 128] -> out [8, 128]: the rows reversed.  A column's 8 values lie
// on 8 lanes of a warp (4 columns a warp), gathered by one shuffle.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    const int lane = threadIdx.x % 32;
    const int c = (blockIdx.x * 8 + threadIdx.x / 32) * 4 + lane / 8;
    const int r = lane % 8;
    const float v = in[r * 128 + c];
    out[r * 128 + c] = __shfl_sync(probe::FULL, v, (lane & ~7) | (7 - r));
}

MDX_PROBE_ENTRY(k, 4, 256)
