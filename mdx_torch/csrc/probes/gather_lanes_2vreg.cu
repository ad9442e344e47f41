// in [16, 256] -> out [16, 256]: each row reversed, a row wider than a
// warp's four registers a lane: through shared memory.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    __shared__ float row[256];
    const int r = blockIdx.x, t = threadIdx.x;
    row[t] = in[r * 256 + t];
    __syncthreads();
    out[r * 256 + t] = row[255 - t];
}

MDX_PROBE_ENTRY(k, 16, 256)
