// in [256, 512] -> out [256, 512]: the row's halves interleaved,
// out[i][2j] = in[i][j], out[i][2j + 1] = in[i][256 + j], through shared
// memory (the TPU probe bridged it through transposes): 32 x 32 tiles of
// both halves, padded to 33, written back as 64 interleaved columns.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    __shared__ float a[32][33], b[32][33];
    const int bx = blockIdx.x * 32, by = blockIdx.y * 32;
    const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
    for (int r = ty; r < 32; r += 8) {
        a[r][tx] = in[(by + r) * 512 + bx + tx];
        b[r][tx] = in[(by + r) * 512 + 256 + bx + tx];
    }
    __syncthreads();
#pragma unroll
    for (int r = ty; r < 32; r += 8) {
        float* o = out + (by + r) * 512 + 2 * bx;
        o[tx] = (tx % 2 == 0) ? a[r][tx / 2] : b[r][tx / 2];
        o[32 + tx] = (tx % 2 == 0) ? a[r][16 + tx / 2] : b[r][16 + tx / 2];
    }
}

MDX_PROBE_ENTRY(k, dim3(8, 8), dim3(32, 8))
