// in [256, 512] -> out [256, 256]: out = in[:, ::2] + in[:, 1::2], as two
// stride-2 scalar loads an output (the strided slices as written).
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    const int g = blockIdx.x * 256 + threadIdx.x;
    const int i = g / 256, j = g % 256;
    out[g] = in[i * 512 + 2 * j] + in[i * 512 + 2 * j + 1];
}

MDX_PROBE_ENTRY(k, 256, 256)
