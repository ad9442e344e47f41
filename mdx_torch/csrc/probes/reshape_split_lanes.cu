// in [256, 512] -> out [256, 256]: out[i][j] = in[i][2j] + in[i][2j + 1]
// (a reshape to [256, 256, 2] summed over the last axis): one float2 load
// an output, the lane de-interleave.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    const int g = blockIdx.x * 256 + threadIdx.x;
    const float2 v = reinterpret_cast<const float2*>(in)[g];
    out[g] = v.x + v.y;
}

MDX_PROBE_ENTRY(k, 256, 256)
