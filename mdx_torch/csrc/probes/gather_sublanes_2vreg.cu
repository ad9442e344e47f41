// in [16, 256] -> out [16, 256]: the rows reversed.  A column's 16 values
// lie on 16 lanes of a warp (2 columns a warp), gathered by one shuffle.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    const int lane = threadIdx.x % 32;
    const int c = (blockIdx.x * 8 + threadIdx.x / 32) * 2 + lane / 16;
    const int r = lane % 16;
    const float v = in[r * 256 + c];
    out[r * 256 + c] = __shfl_sync(probe::FULL, v, (lane & ~15) | (15 - r));
}

MDX_PROBE_ENTRY(k, 16, 256)
