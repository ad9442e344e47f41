// in [8, 256] (a 256-entry table a row) -> out [8, 512]: out[r][c] =
// in[r][c % 256], gathered as two 128-entry halves in shared memory and a
// select on the index's high bit (the TPU probe's split-LUT form).
#include "probe.cuh"

__global__ void __launch_bounds__(128) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    __shared__ float lo[128], hi[128];
    const int r = blockIdx.x, t = threadIdx.x;
    lo[t] = in[r * 256 + t];
    hi[t] = in[r * 256 + 128 + t];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int c = t + 128 * q, idx = c & 255, l = idx & 127;
        out[r * 512 + c] = idx >= 128 ? hi[l] : lo[l];
    }
}

MDX_PROBE_ENTRY(k, 8, 128)
