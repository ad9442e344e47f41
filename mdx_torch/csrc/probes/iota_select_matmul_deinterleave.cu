// in v [256, 512] -> out [256, 256] = v @ S_e + v @ S_o, S_e[j][q] =
// (j == 2q), S_o[j][q] = (j == 2q + 1): the column de-interleave as two
// products with selection matrices built from indices in the kernel.  A
// tiled float32 product on the SIMT cores: 16 x 16 output tiles, 16-deep
// slices of v in shared memory (padded to 17), S from the indices.  It is
// exact: one term of each sum is non-zero and the arange values (below
// 2^17) are integers.  A TF32 tensor-core product would keep 10 bits of
// mantissa and round values above 2048 by up to 1/2048 of their size, far
// past the check's rtol 1e-5: on Hopper that is the twin of the TPU's
// one-pass bf16 matmul (the CLAHE remap incident), so this probe stays in
// float32.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    __shared__ float vt[16][17];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int i = blockIdx.y * 16 + ty, q = blockIdx.x * 16 + tx;
    float e = 0.0f, o = 0.0f;
    for (int k0 = 0; k0 < 512; k0 += 16) {
        vt[ty][tx] = in[i * 512 + k0 + tx];
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
            const int j = k0 + kk;
            e += vt[ty][kk] * (j == 2 * q ? 1.0f : 0.0f);
            o += vt[ty][kk] * (j == 2 * q + 1 ? 1.0f : 0.0f);
        }
        __syncthreads();
    }
    out[i * 256 + q] = e + o;
}

MDX_PROBE_ENTRY(k, dim3(16, 16), dim3(16, 16))
