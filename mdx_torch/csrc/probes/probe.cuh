// Shared by the capability probes of mdx_torch/tools/probe_nvcc.py, the
// Hopper counterpart of the TPU probe tools/probe_mosaic.py (_run, one
// single-block pallas_call around each of 18 one-op bodies).  Each probe is
// one .cu with one kernel on fixed float32 shapes (the TPU probe's arange
// inputs) and the plain C entry mdx_probe(in, out, stream), built into its
// own library by its own nvcc, so a probe that nvcc or ptxas refuses breaks
// no other.  A probe is a data movement in the form a Hopper kernel would
// use for it: gathers within a warp's lanes by __shfl_sync, wider gathers
// and the transposes through padded shared memory, lane interleaves and
// de-interleaves as float2 loads and stores.
#pragma once
#include <cuda_runtime.h>

namespace probe {

constexpr unsigned FULL = 0xffffffffu;

// Element s of a row of 32 * R floats that a warp holds R to a lane (lane l
// holds elements l, l + 32, ...): R shuffles from lane s % 32, one select.
template <int R>
__device__ __forceinline__ float warp_gather(const float (&v)[R], int s) {
    float r = 0.0f;
#pragma unroll
    for (int q = 0; q < R; ++q) {
        const float t = __shfl_sync(FULL, v[q], s & 31);
        if ((s >> 5) == q) r = t;
    }
    return r;
}

}  // namespace probe

// The C entry of a probe: launch `kernel` on grid x block, return the launch
// error (0 when it was taken).
#define MDX_PROBE_ENTRY(kernel, grid, block)                                 \
    extern "C" int mdx_probe(const float* in, float* out, void* stream) {   \
        kernel<<<(grid), (block), 0, static_cast<cudaStream_t>(stream)>>>(  \
            in, out);                                                        \
        return (int)cudaGetLastError();                                      \
    }
