// in v [256, 512] -> out [256, 256] = v @ S_e + v @ S_o, S_e[j][q] =
// (j == 2q), S_o[j][q] = (j == 2q + 1): the column de-interleave as two
// products with selection matrices.  Column q of S_e keeps one term of row
// i of v, v[i][2q], and column q of S_o one, v[i][2q + 1], so a thread
// reads only those: one float4 load (v[i][2q .. 2q + 3], coalesced across
// the warp) gives the kept terms of outputs q and q + 1, written as one
// float2.  No shared memory, no loop over the 512-deep products (their
// other 510 terms are zeros).  It is exact, and equal to the full product:
// the arange values (below 2^17) are integers, and each sum has one
// non-zero term.  A TF32 tensor-core product would keep 10 bits of
// mantissa and round values above 2048 by up to 1/2048 of their size, far
// past the check's rtol 1e-5: on Hopper that is the twin of the TPU's
// one-pass bf16 matmul (the CLAHE remap incident), so this probe stays in
// float32.
#include "probe.cuh"

__global__ void __launch_bounds__(256) k(const float* __restrict__ in,
                                         float* __restrict__ out) {
    const int t = blockIdx.x * 256 + threadIdx.x;   // [256 rows][128 pairs]
    const int i = t >> 7, q = (t & 127) * 2;
    const float4 v = reinterpret_cast<const float4*>(in + i * 512)[q >> 1];
    const float e0 = v.x * 1.0f, o0 = v.y * 1.0f;   // S_e[2q][q], S_o[2q+1][q]
    const float e1 = v.z * 1.0f, o1 = v.w * 1.0f;
    reinterpret_cast<float2*>(out + i * 256)[q >> 1] = make_float2(e0 + o0,
                                                                   e1 + o1);
}

MDX_PROBE_ENTRY(k, 128, 256)
