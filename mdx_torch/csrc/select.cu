// Exact order statistics of each row of x [n, m] by radix selection: for
// each target rank k (1-indexed) the k-th smallest element of every row,
// bit for bit the value torch.sort(x).values[:, k - 1] holds (-0.0 comes
// back as +0.0, an equal number).
//
// Replaces no TPU kernel.  The JAX package finds order statistics by a
// bitwise binary search over the whole row (mdx/ops/quantile.py); the
// port's plain version is a full torch.sort of each row and a gather
// (mdx_torch/ops/quantile.py percentiles_exact, the route of CPU tensors).
// The metric pass reads 2 to 8 order statistics of rows of 0.26 to 4.2 M
// elements, so a sort (four onesweep passes of float keys and int64
// indices, ~108 bytes an element) does far more than the answer needs.
//
// Each element's key is the order-preserving 32-bit image of its float
// (non-negative: bits | sign bit; negative: ~bits; -0.0 takes +0.0's key),
// computed in registers and never stored.  The key is decided in three
// digits of 11, 11 and 10 bits, one launch each (select_pass_kernel<P>):
//   pass P: every block builds a histogram of digit P in shared memory
//     over its chunk of the row, counting only the elements whose key
//     above the digit equals one of the row's slots (the distinct prefixes
//     the targets have so far; pass 0 counts every element), and adds its
//     non-zero bins to the row's histogram in device memory.  The row's
//     last block (a ticket, as kernel 10's) scans each slot's histogram:
//     a target of rank r within its prefix takes the digit d where the
//     count below d is < r and the count up to d is >= r, and r less the
//     count below d as its rank within the longer prefix.  Targets whose
//     prefixes are equal (a rank and its successor nearly always are)
//     share one slot of the next pass.  After pass 2 the key is whole,
//     and the last block writes its float.
// Skew: background, clipping and the exponent bits, which fill most of the
// top digit of values in [0, 1], pile a row into a few bins.  Each lane
// adds each distinct bin of its float4 once, and a warp whose 128 elements
// share one bin adds them with one atomic, so a flat or clipped run does
// not serialise on one shared-memory counter.  (Aggregating every warp by
// __match_any_sync took pass 0 from 0.11 to 0.23 ms at [16, 2048^2].)
// Filter: masks of the slots by their first digit (pass 1) and by their
// first and second digits (pass 2), two shared-memory reads an element.
// Grid: rows x blocks a row, the blocks a row set from the SM count and
// the pass's occupancy so that one wave fills the card whatever the row
// count ([1, 262144] to [16, 4194304]), at least 2048 elements a block.
// Bound: bytes, each row read three times (the digits could be fewer only
// with histograms too large for shared memory); 16-byte loads.  On an H100
// (PERF.md) 0.38 ms at [16, 2048^2] with 8 targets, 0.11-0.16 ms a pass,
// against 0.24 for three reads; torch.sort and its gather took 4.6.
// Launches: one memset of the histograms and tickets, three passes.  No
// float arithmetic and integer counts only, so the result is exact and the
// same on every run.
#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int MAX_T = 16;           // targets a call
constexpr int MIN_CHUNK = 2048;     // the least elements a block reads
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned SIGN = 0x80000000u;

// pass P decides key bits [SHIFT, SHIFT + BITS)
template <int P> struct Digit;
template <> struct Digit<0> { static constexpr int BITS = 11, SHIFT = 21; };
template <> struct Digit<1> { static constexpr int BITS = 11, SHIFT = 10; };
template <> struct Digit<2> { static constexpr int BITS = 10, SHIFT = 0; };

struct Targets {
    int t;                  // targets
    int k[MAX_T];           // their ranks, 1-indexed, 1 <= k <= m
};

// A row's state between passes, written by the row's last block.
struct RowState {
    unsigned prefix[MAX_T];        // each target's key bits decided so far
    int rem[MAX_T];                // its rank among the prefix's elements
    int slot[MAX_T];               // its slot in the next pass
    unsigned slot_prefix[MAX_T];   // the slots' distinct prefixes
    int nslot;
};

__device__ __forceinline__ unsigned key_of(float v) {
    unsigned u = __float_as_uint(v);
    u = u == SIGN ? 0u : u;                       // -0.0 -> +0.0
    return (u & SIGN) ? ~u : (u | SIGN);
}

__device__ __forceinline__ float value_of(unsigned key) {
    return __uint_as_float((key & SIGN) ? (key & ~SIGN) : ~key);
}

// The bin of a key in pass P's block histogram [nslot][2^BITS]: the slot of
// its prefix times 2^BITS plus its digit; -1 where no slot has its prefix.
// top[digit 0] and mid[digit 1] are masks of the slots whose prefix has
// that digit (pass 1: top; pass 2: both, which fix the 22-bit prefix).
template <int P>
__device__ __forceinline__ int bin_of(unsigned key, const unsigned short* top,
                                      const unsigned short* mid) {
    constexpr int B = Digit<P>::BITS, S = Digit<P>::SHIFT;
    const int d = (int)((key >> S) & ((1u << B) - 1));
    if constexpr (P == 0) {
        return d;
    } else {
        unsigned mask = top[key >> Digit<0>::SHIFT];
        if constexpr (P == 2)
            mask &= mid[(key >> Digit<1>::SHIFT) &
                        ((1u << Digit<1>::BITS) - 1)];
        return mask ? ((__ffs(mask) - 1) << B) + d : -1;
    }
}

// Four elements' bins (-1: none) into h.  A warp whose 128 elements all
// fall in one bin (a flat background, a clipped run) adds them with one
// atomic; otherwise each lane adds each distinct bin of its four once.
__device__ __forceinline__ void add4(int* h, int b0, int b1, int b2,
                                     int b3) {
    const bool same = b0 == b1 && b1 == b2 && b2 == b3;
    const int lead = __shfl_sync(FULL, b0, 0);
    if (__all_sync(FULL, same && b0 == lead)) {
        if ((threadIdx.x & 31) == 0 && lead >= 0) atomicAdd(&h[lead], 128);
        return;
    }
    if (b0 >= 0) atomicAdd(&h[b0], 1 + (b1 == b0) + (b2 == b0) + (b3 == b0));
    if (b1 >= 0 && b1 != b0) atomicAdd(&h[b1], 1 + (b2 == b1) + (b3 == b1));
    if (b2 >= 0 && b2 != b0 && b2 != b1) atomicAdd(&h[b2], 1 + (b3 == b2));
    if (b3 >= 0 && b3 != b0 && b3 != b1 && b3 != b2) atomicAdd(&h[b3], 1);
}

// Exclusive prefix sum of one int a thread over the block.
__device__ __forceinline__ int block_exclusive(int v, int* s_warp) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += u;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    int off = 0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) off += w < warp ? s_warp[w] : 0;
    __syncthreads();
    return off + inc - v;
}

// One pass: blockIdx.y a row, blockIdx.x its chunk [x * chunk, + chunk).
// hist: the pass's [n][slots][2^BITS] row histograms (slots 1 in pass 0,
// t after), zero on entry; ticket: [n], zero on entry; state: [n]; out:
// [n][t] (pass 2).
template <int P>
__global__ void __launch_bounds__(NT)
select_pass_kernel(const float* __restrict__ x, int m, long long chunk,
                   int* __restrict__ hist, int* __restrict__ ticket,
                   RowState* __restrict__ state, Targets tg,
                   float* __restrict__ out) {
    constexpr int B = Digit<P>::BITS, NB = 1 << B, PER = NB / NT;
    extern __shared__ int s_hist[];               // [nslot][NB]
    __shared__ unsigned short s_top[1 << Digit<0>::BITS],
        s_mid[1 << Digit<1>::BITS];
    __shared__ unsigned s_prefix[MAX_T];
    __shared__ int s_rem[MAX_T], s_slot[MAX_T], s_digit[MAX_T],
        s_below[MAX_T], s_warp[NWARP];
    __shared__ int s_nslot, s_last;
    const int row = blockIdx.y, tid = threadIdx.x;
    RowState* st = state + row;
    int nslot = 1;
    if constexpr (P > 0) {
        if (tid == 0) s_nslot = st->nslot;
        for (int i = tid; i < (1 << Digit<0>::BITS); i += NT)
            s_top[i] = s_mid[i] = 0;
        __syncthreads();
        nslot = s_nslot;
        if (tid == 0) {
            for (int i = 0; i < nslot; ++i) {
                const unsigned q = st->slot_prefix[i];
                if constexpr (P == 1) {
                    s_top[q] |= 1u << i;
                } else {
                    s_top[q >> Digit<1>::BITS] |= 1u << i;
                    s_mid[q & ((1u << Digit<1>::BITS) - 1)] |= 1u << i;
                }
            }
        }
    }
    for (int i = tid; i < nslot * NB; i += NT) s_hist[i] = 0;
    __syncthreads();

    // the chunk: a scalar head up to 16 bytes' alignment, float4s, a tail
    const float* xr = x + (size_t)row * m;
    const long long lo = (long long)blockIdx.x * chunk;
    const long long hi = min((long long)m, lo + chunk);
    if (lo < hi) {
        const long long mis = ((uintptr_t)(xr + lo) >> 2) & 3;
        const long long a = min(hi, lo + ((4 - mis) & 3));
        const long long nv = (hi - a) >> 2, b = a + 4 * nv;
        // the head and the tail: at most 3 elements each
        for (long long i = lo + tid; i < a; i += NT) {
            const int bin = bin_of<P>(key_of(xr[i]), s_top, s_mid);
            if (bin >= 0) atomicAdd(&s_hist[bin], 1);
        }
        for (long long i = b + tid; i < hi; i += NT) {
            const int bin = bin_of<P>(key_of(xr[i]), s_top, s_mid);
            if (bin >= 0) atomicAdd(&s_hist[bin], 1);
        }
        // every lane of the block runs the same iterations (the warp votes)
        const float4* v4 = reinterpret_cast<const float4*>(xr + a);
        for (long long i0 = 0; i0 < nv; i0 += 4 * NT) {
            float4 v[4];
            bool ok[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const long long i = i0 + u * NT + tid;
                ok[u] = i < nv;
                if (ok[u]) v[u] = __ldg(v4 + i);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                int b0 = -1, b1 = -1, b2 = -1, b3 = -1;
                if (ok[u]) {
                    b0 = bin_of<P>(key_of(v[u].x), s_top, s_mid);
                    b1 = bin_of<P>(key_of(v[u].y), s_top, s_mid);
                    b2 = bin_of<P>(key_of(v[u].z), s_top, s_mid);
                    b3 = bin_of<P>(key_of(v[u].w), s_top, s_mid);
                }
                add4(s_hist, b0, b1, b2, b3);
            }
        }
    }
    __syncthreads();

    // the block's counts into the row's histogram, then the ticket
    const int slots = P == 0 ? 1 : tg.t;
    int* hrow = hist + (size_t)row * slots * NB;
    for (int i = tid; i < nslot * NB; i += NT) {
        const int c = s_hist[i];
        if (c) atomicAdd(&hrow[i], c);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&ticket[row], 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;

    // the row's last block: each target's digit from its slot's histogram
    __threadfence();
    if (tid < tg.t) {
        if constexpr (P == 0) {
            s_prefix[tid] = 0u;
            s_rem[tid] = tg.k[tid];
            s_slot[tid] = 0;
        } else {
            s_prefix[tid] = st->prefix[tid];
            s_rem[tid] = st->rem[tid];
            s_slot[tid] = st->slot[tid];
        }
    }
    __syncthreads();
    for (int s = 0; s < nslot; ++s) {
        int c[PER], sum = 0;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            c[j] = __ldcg(hrow + s * NB + tid * PER + j);
            sum += c[j];
        }
        const int below = block_exclusive(sum, s_warp);
        for (int t = 0; t < tg.t; ++t) {
            const int r = s_rem[t];
            if (s_slot[t] != s || r <= below || r > below + sum) continue;
            int cum = below, j = 0;
            while (r > cum + c[j]) cum += c[j++];
            s_digit[t] = tid * PER + j;
            s_below[t] = cum;
        }
    }
    __syncthreads();
    if constexpr (P == 2) {
        if (tid < tg.t)
            out[(size_t)row * tg.t + tid] =
                value_of((s_prefix[tid] << B) | (unsigned)s_digit[tid]);
    } else {
        if (tid == 0) {
            int ns = 0;
            for (int t = 0; t < tg.t; ++t) {
                const unsigned p = (s_prefix[t] << B) | (unsigned)s_digit[t];
                int s = 0;
                while (s < ns && st->slot_prefix[s] != p) ++s;
                if (s == ns) st->slot_prefix[ns++] = p;
                st->prefix[t] = p;
                st->rem[t] = s_rem[t] - s_below[t];
                st->slot[t] = s;
            }
            st->nslot = ns;
        }
    }
}

// Per device: its SMs and each pass's resident blocks an SM at each
// target count, asked once (0: not yet); the passes' dynamic shared-memory
// limits are raised to the most any target count needs on first use.
constexpr int MAX_DEV = 64;
std::atomic<int> g_sms[MAX_DEV];
std::atomic<int> g_occ[MAX_DEV][3][MAX_T + 1];

template <int P>
size_t smem_bytes(int slots) {
    return (size_t)slots * (1 << Digit<P>::BITS) * sizeof(int);
}

int device_sms(int dev) {
    int sms = dev < MAX_DEV ? g_sms[dev].load(std::memory_order_relaxed) : 0;
    if (sms) return sms;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaFuncSetAttribute(select_pass_kernel<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<1>(MAX_T)) != cudaSuccess ||
        cudaFuncSetAttribute(select_pass_kernel<2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<2>(MAX_T)) != cudaSuccess)
        return 0;
    if (dev < MAX_DEV) g_sms[dev].store(sms, std::memory_order_relaxed);
    return sms;
}

template <int P>
int resident_blocks(int dev, int slots) {
    int occ = dev < MAX_DEV
                  ? g_occ[dev][P][slots].load(std::memory_order_relaxed) : 0;
    if (occ) return occ;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, select_pass_kernel<P>, NT, smem_bytes<P>(slots)) !=
        cudaSuccess)
        return 0;
    if (dev < MAX_DEV) g_occ[dev][P][slots].store(occ,
                                                  std::memory_order_relaxed);
    return occ;
}

// Blocks a row of pass P: one wave of the card over the n rows (at least
// one block a row), each block at least MIN_CHUNK elements; the chunk a
// multiple of 4 elements, so every chunk of an aligned row is aligned.
template <int P>
int launch_pass(const float* x, int n, int m, int* hist, int* ticket,
                RowState* state, const Targets& tg, float* out, int sms,
                int dev, cudaStream_t st) {
    const int slots = P == 0 ? 1 : tg.t;
    const int occ = resident_blocks<P>(dev, slots);
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    long long bpr = (long long)sms * occ / n;
    const long long most = ((long long)m + MIN_CHUNK - 1) / MIN_CHUNK;
    bpr = bpr < 1 ? 1 : (bpr > most ? most : bpr);
    long long chunk = ((long long)m + bpr - 1) / bpr;
    chunk = (chunk + 3) & ~3LL;
    bpr = ((long long)m + chunk - 1) / chunk;
    select_pass_kernel<P><<<dim3((unsigned)bpr, (unsigned)n), NT,
                            smem_bytes<P>(slots), st>>>(
        x, m, chunk, hist, ticket, state, tg, out);
    return (int)cudaGetLastError();
}

// The int32 workspace of a call of t targets over n rows: the zeroed part
// (pass 0's histograms [n][2048], pass 1's [n][t][2048], pass 2's
// [n][t][1024], the tickets [3][n]), then the row states [n].  The wrapper
// asks for its size (mdx_select_workspace_ints) and passes it back.
long long zeroed_ints(int n, int t) {
    return (long long)n * ((1 << Digit<0>::BITS) +
                           (long long)t * ((1 << Digit<1>::BITS) +
                                           (1 << Digit<2>::BITS)) + 3);
}

bool valid_shape(int n, int t) {
    return t >= 1 && t <= MAX_T && n >= 1 && n <= 65535;
}

}  // namespace

// The targets a call takes at most.
extern "C" int mdx_select_max_targets() { return MAX_T; }

// The int32 words of the workspace of a call of t targets over n rows, or
// -1 where the kernel takes no such call (t outside 1..16, n outside
// 1..65535).
extern "C" long long mdx_select_workspace_ints(int n, int t) {
    if (!valid_shape(n, t)) return -1;
    return zeroed_ints(n, t) +
           (long long)n * (long long)(sizeof(RowState) / sizeof(int));
}

// out [n][t] = the ranks[i]-th smallest element of each row of x [n][m]
// (float32, contiguous, 16-byte aligned rows take the vector path), for
// 1 <= t <= 16 ranks, 1 <= ranks[i] <= m, read from host memory as launch
// arguments.  ws: the int32 workspace above, of ws_ints words (refused
// below mdx_select_workspace_ints(n, t)).  Four launches on stream: the
// memset, the three passes.
extern "C" int mdx_select(const float* x, const int* ranks, int t, int* ws,
                          long long ws_ints, float* out, int n, int m,
                          void* stream) {
    if (!valid_shape(n, t) || m < 1 ||
        ws_ints < mdx_select_workspace_ints(n, t))
        return (int)cudaErrorInvalidValue;
    Targets tg;
    tg.t = t;
    for (int i = 0; i < MAX_T; ++i) {
        tg.k[i] = i < t ? ranks[i] : 1;
        if (tg.k[i] < 1 || tg.k[i] > m) return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long zeroed = zeroed_ints(n, t);
    int* h0 = ws;
    int* h1 = h0 + (size_t)n * (1 << Digit<0>::BITS);
    int* h2 = h1 + (size_t)n * t * (1 << Digit<1>::BITS);
    int* tickets = h2 + (size_t)n * t * (1 << Digit<2>::BITS);
    RowState* state = reinterpret_cast<RowState*>(ws + zeroed);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const int sms = device_sms(dev);
    if (sms < 1) {
        e = cudaGetLastError();
        return e != cudaSuccess ? (int)e : (int)cudaErrorInvalidDevice;
    }
    e = cudaMemsetAsync(ws, 0, (size_t)zeroed * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    int rc = launch_pass<0>(x, n, m, h0, tickets, state, tg, out, sms, dev,
                            st);
    if (rc == 0)
        rc = launch_pass<1>(x, n, m, h1, tickets + n, state, tg, out, sms,
                            dev, st);
    if (rc == 0)
        rc = launch_pass<2>(x, n, m, h2, tickets + 2 * n, state, tg, out,
                            sms, dev, st);
    return rc;
}
