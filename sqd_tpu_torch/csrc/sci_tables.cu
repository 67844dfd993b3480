// (C) 2026. Licensed under the Apache License, Version 2.0.
//
// The selected-CI operator's tables, built on the card from one spin's sorted
// string set: the single-excitation gather tables (src, sign) and the
// compacted same-spin Slater-Condon neighbour lists (idx, val).  It replaces
// no TPU kernel: sqd_tpu builds these tables on the host (its native
// sqdcore.cpp) or as XLA ops.  This is the host build of csrc/sqdcore.cpp
// moved onto the card: gather_tables, samespin_candidates and the compaction
// of native.compact_neighbours, with the same candidates in the same order
// and the same f64 arithmetic in the same order, so the tables are the
// host's bit for bit, widths included.
//
// Rounding.  The host library is built by g++ -O3 for x86-64, with no FMA
// and no reassociation: every sum is rounded left to right as written.  This
// file is compiled with --fmad=false, so nvcc contracts no multiply-add
// either, and the expressions below are the host's, term for term.  The
// exact zeros of integrals with symmetry then come out as exact zeros here
// too, and the kept entries and the widths are the same.
//
// Strings are one 64-bit key each (packed width <= 2 words, <= 64 orbitals):
// word 0 in the low half, so the key order is sqdcore's row order (high word
// first), and the binary search below is sqdcore's bsearch_row, step for
// step, which finds the same index even where a set holds a string twice.
//
// What bounds it.  The work is a few million independent binary searches
// (N2/6-31G at 10^6 determinants: 2 x 1000 x 606 same-spin candidates, each
// searched twice, and 2 x 256 x 1000 gather entries, a quarter of them
// searched), each ~10 dependent loads of an 8-byte key, and the outputs,
// ~6 MB there: 2 us of writes at 3.35 TB/s.  Nothing is reused across
// blocks but the key set and the integrals, which stay in L2.  So the
// latency of the searches bounds the kernels, and at these sizes the launch
// and the host's one synchronisation bound the build.
//
// Design:
// * gather: one thread per (pq, j), pq on the grid's y axis; the search in
//   global memory (L2);
// * same-spin: one block per string row, its searches in global memory
//   (L2) as the gather's; thread 0 lists the row's occupied and virtual
//   orbitals and sums its diagonal; the threads take the row's candidates in tiles of
//   kRowThreads in the host's order (diagonal, singles (a, k), doubles
//   (a < b, k < l)), each decoding its candidate from a slot table the host
//   made once per (norb, nelec);
// * two passes over the same candidates.  The count pass keeps a candidate
//   iff it was found in the set and its value is nonzero, and takes the
//   largest kept count over the rows (atomicMax); the host reads both spins'
//   largest counts in one synchronisation and sizes the output.  The fill
//   pass recomputes every candidate, and a block-wide exclusive scan over
//   each tile (a ballot per warp, then the warps' totals) gives each kept
//   entry its slot, in candidate order, in zeroed (n, width) outputs.  No
//   scratch of the full candidate width exists.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kGatherThreads = 256;
constexpr int kRowThreads = 128;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kMaxOrbitals = 64;

// popcount of bits [0, t) of a key, t < 64
__device__ __forceinline__ int popcount_below(u64 s, int t) {
    return __popcll(s & ((1ull << t) - 1ull));
}

// sqdcore's bsearch_row: lower bound, then equality; -1 when absent
__device__ __forceinline__ long long find(const u64* keys, long long n, u64 key) {
    long long lo = 0, hi = n;
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (keys[mid] < key) lo = mid + 1;
        else hi = mid;
    }
    return (lo < n && keys[lo] == key) ? lo : -1;
}

__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const u64* __restrict__ keys, long long n, int norb,
              long long* __restrict__ src, int8_t* __restrict__ sign) {
    const long long j = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
    if (j >= n) return;
    const int pq = blockIdx.y, p = pq / norb, q = pq - p * norb;
    const u64 J = keys[j];
    long long s_idx = 0;
    int8_t s_sign = 0;
    if (p == q) {
        if ((J >> p) & 1ull) {
            s_idx = j;
            s_sign = 1;
        }
    } else if (((J >> p) & 1ull) && !((J >> q) & 1ull)) {
        const u64 I = J ^ (1ull << p) ^ (1ull << q);  // I = J - p + q
        const long long idx = find(keys, n, I);
        if (idx >= 0) {
            // the sign on I: remove q, then add p
            const int s1 = popcount_below(I, q);
            const int s2 = popcount_below(I, p) - (q < p ? 1 : 0);
            s_idx = idx;
            s_sign = ((s1 + s2) & 1) ? -1 : 1;
        }
    }
    const long long at = (long long)pq * n + j;
    src[at] = s_idx;
    sign[at] = s_sign;
}

template <bool kFill>
__global__ void __launch_bounds__(kRowThreads)
samespin_kernel(const u64* __restrict__ keys, long long n, int norb, int nelec,
                const uint32_t* __restrict__ slots, int width_full,
                const double* __restrict__ h1, const double* __restrict__ eri,
                int* __restrict__ most, long long* __restrict__ out_idx,
                double* __restrict__ out_val, int width) {
    __shared__ int occ[kMaxOrbitals], virt[kMaxOrbitals];
    __shared__ double diag_s;
    __shared__ int warp_count[kRowWarps], warp_base[kRowWarps];
    __shared__ int tile_total;
    const long long i = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const u64 J = keys[i];
    const u64 orbitals = norb == 64 ? ~0ull : (1ull << norb) - 1ull;
    // a string of another weight gets no entry, as the host build's inert row
    if (__popcll(J & orbitals) != nelec) return;
    const long long n4 = (long long)norb * norb * norb, n2 = (long long)norb * norb;
#define E(a, b, c, d) eri[(long long)(a) * n4 + (long long)(b) * n2 + (long long)(c) * norb + (d)]
    if (tid == 0) {
        int oc = 0, vc = 0;
        for (int t = 0; t < norb; ++t) {
            if ((J >> t) & 1ull) occ[oc++] = t;
            else virt[vc++] = t;
        }
        // diagonal: h_pp + 1/2 sum_{p,q in J} [(pp|qq) - (pq|qp)]
        double diag = 0.0;
        for (int a = 0; a < nelec; ++a) {
            const int p = occ[a];
            diag += h1[p * norb + p];
            for (int b = 0; b < nelec; ++b) {
                const int q = occ[b];
                diag += 0.5 * (E(p, p, q, q) - E(p, q, q, p));
            }
        }
        diag_s = diag;
    }
    __syncthreads();
    const int singles_end = 1 + nelec * (norb - nelec);
    int kept_count = 0, base = 0;
    for (int c0 = 0; c0 < width_full; c0 += kRowThreads) {
        const int c = c0 + tid;
        bool kept = false;
        long long idx = 0;
        double val = 0.0;
        if (c == 0) {
            idx = i;
            val = diag_s;
            kept = val != 0.0;
        } else if (c < width_full) {
            const uint32_t slot = slots[c];
            const int a = slot & 0xff, b = (slot >> 8) & 0xff;
            const int k = (slot >> 16) & 0xff, l = slot >> 24;
            if (c < singles_end) {
                // singles: I = J - p + q,
                // val = sign * (h_pq + sum_{k in I\q} [(pq|kk) - (pk|kq)])
                const int p = occ[a], q = virt[k];
                const u64 I = J ^ (1ull << p) ^ (1ull << q);
                const long long found = find(keys, n, I);
                if (found >= 0) {
                    double mf = h1[p * norb + q];
                    for (int bb = 0; bb < nelec; ++bb) {
                        const int kk = occ[bb];
                        if (kk == p) continue;
                        mf += E(p, q, kk, kk) - E(p, kk, kk, q);
                    }
                    const int s1 = popcount_below(I, q);
                    const int s2 = popcount_below(I, p) - (q < p ? 1 : 0);
                    idx = found;
                    val = (((s1 + s2) & 1) ? -1.0 : 1.0) * mf;
                    kept = val != 0.0;
                }
            } else {
                // doubles: I = J - p - r + q + s; g is the sign of
                // a+_p a+_r a_s a_q applied to I (sequential parities)
                const int p = occ[a], r = occ[b], q = virt[k], s = virt[l];
                const u64 I = J ^ (1ull << p) ^ (1ull << r) ^ (1ull << q) ^ (1ull << s);
                const long long found = find(keys, n, I);
                if (found >= 0) {
                    u64 x = I;
                    int par = popcount_below(x, q);
                    x ^= 1ull << q;
                    par += popcount_below(x, s);
                    x ^= 1ull << s;
                    par += popcount_below(x, r);
                    x ^= 1ull << r;
                    par += popcount_below(x, p);
                    const double g = (par & 1) ? -1.0 : 1.0;
                    idx = found;
                    val = 0.5 * g * (E(p, q, r, s) + E(r, s, p, q) - E(p, s, r, q) - E(r, q, p, s));
                    kept = val != 0.0;
                }
            }
        }
        if (!kFill) {
            kept_count += kept ? 1 : 0;
            continue;
        }
        // exclusive scan of the tile's kept flags: each kept entry's slot
        const unsigned ballot = __ballot_sync(0xffffffffu, kept);
        if (lane == 0) warp_count[warp] = __popc(ballot);
        __syncthreads();
        if (tid == 0) {
            int run = 0;
            for (int w = 0; w < kRowWarps; ++w) {
                warp_base[w] = run;
                run += warp_count[w];
            }
            tile_total = run;
        }
        __syncthreads();
        if (kept) {
            const int pos = base + warp_base[warp] + __popc(ballot & ((1u << lane) - 1u));
            if (pos < width) {
                out_idx[i * width + pos] = idx;
                out_val[i * width + pos] = val;
            }
        }
        base += tile_total;
        __syncthreads();
    }
#undef E
    if (!kFill) {
        for (int off = 16; off > 0; off >>= 1) kept_count += __shfl_down_sync(0xffffffffu, kept_count, off);
        if (lane == 0) warp_count[warp] = kept_count;
        __syncthreads();
        if (tid == 0) {
            int total = 0;
            for (int w = 0; w < kRowWarps; ++w) total += warp_count[w];
            atomicMax(most, total);
        }
    }
}

}  // namespace

// Each entry point launches on `stream` without synchronising and returns
// cudaGetLastError(); an empty string set launches nothing.

// src (norb^2, n) int64 and sign (norb^2, n) int8, as sqdcore's gather_tables.
extern "C" int sci_gather_tables(const u64* keys, long long n, int norb, long long* src,
                                 int8_t* sign, void* stream) {
    if (n == 0) return 0;
    const dim3 grid((unsigned)((n + kGatherThreads - 1) / kGatherThreads), norb * norb);
    gather_kernel<<<grid, kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, n, norb, src, sign);
    return (int)cudaGetLastError();
}

// *most = max(*most, the largest kept count of any row).
extern "C" int sci_samespin_count(const u64* keys, long long n, int norb, int nelec,
                                  const uint32_t* slots, int width_full, const double* h1,
                                  const double* eri, int* most, void* stream) {
    if (n == 0) return 0;
    samespin_kernel<false><<<(unsigned)n, kRowThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        keys, n, norb, nelec, slots, width_full, h1, eri, most, nullptr, nullptr, 0);
    return (int)cudaGetLastError();
}

// The kept entries of each row, in candidate order, into zeroed (n, width)
// idx (int64) and val (f64); width is at least the count pass's largest.
extern "C" int sci_samespin_fill(const u64* keys, long long n, int norb, int nelec,
                                 const uint32_t* slots, int width_full, const double* h1,
                                 const double* eri, long long* idx, double* val, int width,
                                 void* stream) {
    if (n == 0) return 0;
    samespin_kernel<true><<<(unsigned)n, kRowThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        keys, n, norb, nelec, slots, width_full, h1, eri, nullptr, idx, val, width);
    return (int)cudaGetLastError();
}
