// in [16, 256] -> out [16, 16]: the transpose of the first 16 x 16 block,
// through one tile of shared memory padded to 17 columns.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    __shared__ float tile[16][17];
    const int tx = threadIdx.x, ty = threadIdx.y;
    tile[ty][tx] = in[ty * 256 + tx];
    __syncthreads();
    out[ty * 16 + tx] = tile[tx][ty];
}

MDX_PROBE_ENTRY(k, 1, dim3(16, 16))
