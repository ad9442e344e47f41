// in [256, 512] -> out [256, 512]: the row's halves interleaved,
// out[i][2j] = in[i][j], out[i][2j + 1] = in[i][256 + j]: one float2 store
// an output pair, the lane interleave.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    const int g = blockIdx.x * 256 + threadIdx.x;     // pair (i, j)
    const int i = g / 256, j = g % 256;
    reinterpret_cast<float2*>(out)[g] =
        make_float2(in[i * 512 + j], in[i * 512 + 256 + j]);
}

MDX_PROBE_ENTRY(k, 256, 256)
