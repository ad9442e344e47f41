// in [256, 512] -> out [256, 512]: the two halves of the rows interleaved,
// out[2i] = in[128 + i], out[2i + 1] = in[i]: whole rows copied as float4.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    const int g = blockIdx.x * 256 + threadIdx.x;     // float4 of the output
    const int o = g / 128, j4 = g % 128;
    const int src = (o % 2 == 0) ? 128 + o / 2 : o / 2;
    reinterpret_cast<float4*>(out)[g] =
        reinterpret_cast<const float4*>(in)[src * 128 + j4];
}

MDX_PROBE_ENTRY(k, 128, 256)
