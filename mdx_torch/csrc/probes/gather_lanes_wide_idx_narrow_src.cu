// in [8, 512] -> out [8, 512]: out[r][c] = in[r][c % 128], a 128-entry
// table a row read by 512 indices, through shared memory.
#include "probe.cuh"

__global__ void __launch_bounds__(128) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    __shared__ float tab[128];
    const int r = blockIdx.x, t = threadIdx.x;
    tab[t] = in[r * 512 + t];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int c = t + 128 * q;
        out[r * 512 + c] = tab[c & 127];
    }
}

MDX_PROBE_ENTRY(k, 8, 128)
