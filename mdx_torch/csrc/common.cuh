// Shared helpers for the mdx_torch CUDA kernels.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC  (mdx_torch/kernels/_build.py)
// --fmad=false keeps every a*b+c as a rounded multiply then a rounded add,
// the order PyTorch's separate elementwise kernels use, so a kernel and its
// plain PyTorch version agree to the last bit wherever their sums run in
// the same order.
#pragma once

#include <cuda_runtime.h>

namespace mdx {

// jnp.pad(mode="symmetric") / SciPy "reflect" source index (edge repeated:
// ... 1 0 | 0 1 ... n-1 | n-1 n-2 ...), for a pad of any width: the
// extension is periodic with period 2n, as numpy's.
__device__ __forceinline__ int sym_idx(int i, int n) {
    const int p = 2 * n;
    i %= p;
    if (i < 0) i += p;
    return i < n ? i : p - 1 - i;
}

// jnp.pad(mode="reflect") source index (edge not repeated), for a pad of
// any width: period 2n-2 (a single row or column repeats itself).
__device__ __forceinline__ int refl_idx(int i, int n) {
    if (n == 1) return 0;
    const int p = 2 * n - 2;
    i %= p;
    if (i < 0) i += p;
    return i < n ? i : p - i;
}

__device__ __forceinline__ int clamp_idx(int i, int n) {
    return min(max(i, 0), n - 1);
}

// Sum of one value per thread over a block of NT threads, as a fixed
// shared-memory tree: the result does not depend on scheduling.  Every
// thread of the block must call it; all get the sum.
template <typename T, int NT>
__device__ __forceinline__ T block_sum(T v, T* sh) {
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    sh[tid] = v;
    __syncthreads();
#pragma unroll
    for (int s = NT / 2; s > 0; s >>= 1) {
        if (tid < s) sh[tid] += sh[tid + s];
        __syncthreads();
    }
    T r = sh[0];
    __syncthreads();
    return r;
}

}  // namespace mdx
