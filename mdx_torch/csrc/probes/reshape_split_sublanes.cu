// in [256, 512] -> out [128, 512]: out[i] = in[2i] + in[2i + 1] (a reshape
// to [128, 2, 512] summed over the middle axis): two rows read as float4.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    const int g = blockIdx.x * 256 + threadIdx.x;     // float4 of the output
    const int i = g / 128, j4 = g % 128;
    const float4* src = reinterpret_cast<const float4*>(in);
    const float4 a = src[(2 * i) * 128 + j4], b = src[(2 * i + 1) * 128 + j4];
    reinterpret_cast<float4*>(out)[g] =
        make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

MDX_PROBE_ENTRY(k, 64, 256)
