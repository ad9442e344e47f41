// in [256, 512] -> out [256, 256]: out = in[:, ::2] + in[:, 1::2], through
// shared memory (the TPU probe bridged the column de-interleave through two
// transposes): a 32 x 64 input tile, padded to 65 columns, read back as
// column pairs.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    __shared__ float tile[32][65];
    const int bx = blockIdx.x * 64, by = blockIdx.y * 32;
    const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
    for (int r = ty; r < 32; r += 8) {
        tile[r][tx] = in[(by + r) * 512 + bx + tx];
        tile[r][tx + 32] = in[(by + r) * 512 + bx + 32 + tx];
    }
    __syncthreads();
#pragma unroll
    for (int r = ty; r < 32; r += 8)
        out[(by + r) * 256 + bx / 2 + tx] = tile[r][2 * tx] + tile[r][2 * tx + 1];
}

MDX_PROBE_ENTRY(k, dim3(8, 8), dim3(32, 8))
