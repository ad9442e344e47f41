// in [256, 512] -> out [512, 256]: the transpose, through 32 x 32 tiles in
// shared memory padded to 33 columns (no bank conflicts on the column
// reads), coalesced on both sides.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    __shared__ float tile[32][33];
    const int bx = blockIdx.x * 32, by = blockIdx.y * 32;
    const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
    for (int r = ty; r < 32; r += 8) tile[r][tx] = in[(by + r) * 512 + bx + tx];
    __syncthreads();
#pragma unroll
    for (int r = ty; r < 32; r += 8) out[(bx + r) * 256 + by + tx] = tile[tx][r];
}

MDX_PROBE_ENTRY(k, dim3(16, 8), dim3(32, 8))
