// (C) 2026. Licensed under the Apache License, Version 2.0.
//
// Cross-spin (opposite-spin) channel of the selected-CI matvec, in f32, for
// Hopper (sm_90a).  Replaces the Pallas TPU kernel
// sqd_tpu/ops/pallas_matvec.py:102-234 (_kernel, cross_spin_matvec, _call).
//
//   sigma[i, j] = sum_{t < kb_n[j]} kb_sgn[j,t]
//                 * sum_{l < ka_n[i]} A_i[kb_rs[j,t], l] * c[ka_src[i,l], kb_src[j,t]]
//   A_i[rs, l]  = eri_t[rs, ka_pq[i,l]] * ka_sgn[i,l]
//
// l runs over the valid alpha pairs of row i and t over the valid beta pairs
// of column j, both compacted once per operator by the Python wrapper (the
// beta entries of a column sorted by source).  This is the TPU kernel's
// g_i = eri_t (E^a c)_i followed by the beta pick g_i[rs, src_b[rs, j]],
// with only the entries of g_i that the pick reads computed.  Padded
// determinants have no valid pairs and come out as exact zeros.
//
// What bounds it on this card.  At the 10^6-determinant headline
// (M = N = 1024, npair = 256) the alpha rows hold 19,936 valid pairs in all
// and the beta columns 19,522, so the contraction needs 2 * 19,936 * 19,522
// = 0.78 GFLOP: 11.6 us at the H100's 67 TFLOP/s f32 rate outside the tensor
// cores.  Its inputs and output, each moved once, are 9.5 MB: 2.8 us at
// 3.35 TB/s.  Operations bound it.  Building all of g_i, as the TPU kernel
// does, would be 2 * npair * 19,936 * N = 10.45 GFLOP, of which the pick
// reads 7.4 %.  What limits this design is shared-memory traffic: two
// 16-byte loads of random rows per four FMAs, about 3.4 GB per call at the
// headline (0.1 ms at one 128-byte wavefront per clock per SM), which bank
// conflicts between random rows roughly double; then the latency of staging
// and of the beta-table loads, which one block per SM does not overlap with
// its own arithmetic.
//
// wgmma and TMA do not fit: the contraction has no dense product (every
// output element sums over its own gathered (rs, source) entries) and the
// rows of c it reads are gathered, not strided.  The arithmetic is f32 FMAs
// on the CUDA cores; no tensor cores, no TF32.
//
// Design:
// * one block of 1024 threads per alpha row i; rows with no valid pair (the
//   padding) write zeros and return;
// * shared memory holds A_i as [rs][l], the gathered rows of c for a tile of
//   columns transposed to [k][l], and row i's pair lists; the rows have the
//   stride kp floats, a multiple of 4 whose count of 16-byte groups is odd,
//   so float4 reads of random rows spread over the eight bank groups.  Each
//   is loaded once per block (at the headline: 36 KB + 144 KB), c with
//   coalesced loads and 16-byte stores, A a warp per pair row;
// * one thread per output column (four per thread past 1024 columns, more
//   column chunks past 4096): its sum stays in a register while it walks the
//   column's compacted entries, loading each entry's indices one entry ahead
//   of its float4 dot product over l < ka_n[i] of two shared rows, times the
//   sign.  No atomics: the order of summation is fixed and each output
//   element is written once;
// * N wider than one shared tile: the k axis is tiled.  A column's entries
//   are sorted by source, so those whose source lies in a tile are a
//   contiguous run; a cursor per column takes each entry once;
// * npair * kp too large to sit beside a tile: the rs axis is tiled too, and
//   each rs tile walks the run again, taking the entries whose rs it holds;
// * the beta tables are entry-major (entry t of every column contiguous), so
//   a warp's table loads coalesce; shared memory is written before it is
//   read, padding lanes included (no stale 0 * NaN).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 4;  // output columns a thread keeps in registers
constexpr int kChunk = kThreads * kColsPerThread;
constexpr int kMaxSmem = 232448;   // shared memory one block may use on Hopper

__global__ void __launch_bounds__(kThreads, 1)
cross_spin_kernel(const float* __restrict__ c, int n,
                  const int* __restrict__ ka_n, const int* __restrict__ ka_pq,
                  const int* __restrict__ ka_src, const float* __restrict__ ka_sgn, int ka,
                  const int* __restrict__ kb_n, const int* __restrict__ kb_rs,
                  const int* __restrict__ kb_src, const float* __restrict__ kb_sgn,
                  const float* __restrict__ eri_t, int npair,
                  int kp, int tile_cols, int tile_rs, float* __restrict__ out) {
    extern __shared__ float4 smem4[];
    const int kq = kp >> 2;                                  // float4 groups per row
    float4* a4 = smem4;                                      // tile_rs x kp: A_i[rs][l]
    float4* c4 = smem4 + (size_t)tile_rs * kq;               // tile_cols x kp: c[src_l, k]
    float* a_s = reinterpret_cast<float*>(a4);
    int* pq_s = reinterpret_cast<int*>(c4 + (size_t)tile_cols * kq);  // 3 x kp: row i's pairs
    int* src_s = pq_s + kp;
    float* sgn_s = reinterpret_cast<float*>(src_s + kp);

    const int i = blockIdx.x;
    const int tid = threadIdx.x;
    const int nv = ka_n[i];
    float* out_row = out + (size_t)i * n;
    if (nv == 0) {  // uniform across the block
        for (int j = tid; j < n; j += kThreads) out_row[j] = 0.f;
        return;
    }
    const int nq = (nv + 3) >> 2;  // float4 groups of one dot product
    const int lw = nq << 2;        // staged width; lanes l >= nv hold zeros
    for (int l = tid; l < lw; l += kThreads) {
        const bool ok = l < nv;
        pq_s[l] = ok ? ka_pq[(size_t)i * ka + l] : 0;
        src_s[l] = ok ? ka_src[(size_t)i * ka + l] : 0;
        sgn_s[l] = ok ? ka_sgn[(size_t)i * ka + l] : 0.f;
    }
    const bool rs_tiled = tile_rs < npair;
    const int warp = tid >> 5, lane = tid & 31;

    for (int j0 = 0; j0 < n; j0 += kChunk) {
        float acc[kColsPerThread];
        int cur[kColsPerThread], end[kColsPerThread];
#pragma unroll
        for (int u = 0; u < kColsPerThread; ++u) {
            const int j = j0 + tid + u * kThreads;
            acc[u] = 0.f;
            cur[u] = 0;
            end[u] = j < n ? kb_n[j] : 0;
        }
        for (int k0 = 0; k0 < n; k0 += tile_cols) {
            const int nk = min(tile_cols, n - k0);
            const int k1 = k0 + nk;
            __syncthreads();  // the pair lists are staged; the previous tile's reads are done
            // c_s[kk][l] = c[src_l, k0 + kk]: a thread per column kk, loads
            // coalesced along the rows of c, one 16-byte store per 4 lanes
            for (int kk = tid; kk < nk; kk += kThreads) {
                const float* ccol = c + k0 + kk;
                float4* dst = c4 + (size_t)kk * kq;
#pragma unroll 4
                for (int g = 0; g < nq; ++g) {
                    float v[4];
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int l = 4 * g + q;
                        v[q] = l < nv ? __ldg(ccol + (size_t)src_s[l] * n) : 0.f;
                    }
                    dst[g] = make_float4(v[0], v[1], v[2], v[3]);
                }
            }
            for (int r0 = 0; r0 < npair; r0 += tile_rs) {
                const int r1 = min(npair, r0 + tile_rs);
                if (r0 > 0) __syncthreads();  // the previous rs tile's reads are done
                if (rs_tiled || (j0 == 0 && k0 == 0)) {
                    // a_s[r][l] = eri_t[r0 + r, pq_l] * sgn_l: a warp per row
#pragma unroll 4
                    for (int r = warp; r < r1 - r0; r += kWarps) {
                        const float* erow = eri_t + (size_t)(r0 + r) * npair;
                        for (int l = lane; l < lw; l += 32)
                            a_s[(size_t)r * kp + l] = l < nv ? __ldg(erow + pq_s[l]) * sgn_s[l] : 0.f;
                    }
                }
                __syncthreads();  // both tiles are staged
#pragma unroll
                for (int u = 0; u < kColsPerThread; ++u) {
                    const int j = j0 + tid + u * kThreads;
                    if (j >= n) continue;
                    const int stop = end[u];
                    float s = acc[u];
                    int t = cur[u];
                    // entry t's indices, loaded one entry ahead of its use
                    int k = 0, rs = 0;
                    float sg = 0.f;
                    if (t < stop) {
                        const size_t e = (size_t)t * n + j;
                        k = kb_src[e];
                        rs = kb_rs[e];
                        sg = kb_sgn[e];
                    }
                    while (t < stop && k < k1) {  // the run of this k tile
                        int k_next = 0, rs_next = 0;
                        float sg_next = 0.f;
                        if (t + 1 < stop) {
                            const size_t e = (size_t)(t + 1) * n + j;
                            k_next = kb_src[e];
                            rs_next = kb_rs[e];
                            sg_next = kb_sgn[e];
                        }
                        if (!rs_tiled || (rs >= r0 && rs < r1)) {
                            const float4* ap = a4 + (size_t)(rs - r0) * kq;
                            const float4* bp = c4 + (size_t)(k - k0) * kq;
                            float d = 0.f;
                            for (int g = 0; g < nq; ++g) {
                                const float4 a = ap[g];
                                const float4 b = bp[g];
                                d = fmaf(a.x, b.x, d);
                                d = fmaf(a.y, b.y, d);
                                d = fmaf(a.z, b.z, d);
                                d = fmaf(a.w, b.w, d);
                            }
                            s = fmaf(sg, d, s);
                        }
                        k = k_next;
                        rs = rs_next;
                        sg = sg_next;
                        ++t;
                    }
                    acc[u] = s;
                    if (r1 == npair) cur[u] = t;  // every rs tile has walked the run
                }
            }
        }
#pragma unroll
        for (int u = 0; u < kColsPerThread; ++u) {
            const int j = j0 + tid + u * kThreads;
            if (j < n) out_row[j] = acc[u];
        }
    }
}

}  // namespace

// All pointers are device pointers:
//   c (rows, n) f32, C-contiguous, with rows > every ka_src: m is the count of
//     output rows, and ka_src may point past them (a row shard of an operator
//     reads source rows anywhere in the whole c);
//   ka_n (m,) i32; ka_pq, ka_src (m, ka) i32 and ka_sgn (m, ka) f32, C-contiguous;
//   kb_n (n,) i32; kb_rs, kb_src i32 and kb_sgn f32, entry-major (kb, n);
//   eri_t (npair, npair) f32; out (m, n) f32, fully written.
// kp >= ka is the shared row stride (a multiple of 4); tile_cols columns of c
// and tile_rs pair rows of A are staged per block, with row i's pair lists:
// (tile_cols + tile_rs + 3) * kp floats of shared memory.  Launches on
// `stream` without synchronising; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan that does not fit.
extern "C" int cross_spin_matvec_f32(const float* c, int m, int n, const int* ka_n,
                                     const int* ka_pq, const int* ka_src, const float* ka_sgn,
                                     int ka, const int* kb_n, const int* kb_rs,
                                     const int* kb_src, const float* kb_sgn,
                                     const float* eri_t, int npair, int kp, int tile_cols,
                                     int tile_rs, float* out, void* stream) {
    if (m <= 0 || n <= 0) return 0;
    const size_t smem = sizeof(float) * (size_t)kp * ((size_t)tile_cols + tile_rs + 3);
    if (kp < ka || kp % 4 != 0 || tile_cols < 1 || tile_rs < 1 || tile_rs > npair ||
        smem > (size_t)kMaxSmem)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        cross_spin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cross_spin_kernel<<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        c, n, ka_n, ka_pq, ka_src, ka_sgn, ka, kb_n, kb_rs, kb_src, kb_sgn, eri_t, npair,
        kp, tile_cols, tile_rs, out);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The same channel in f64, for the exact operator: the f64 Davidson
// refinement, the f64 Davidson of small subspaces and the f64 energy.
//
// It replaces no TPU kernel: sqd_tpu sends f64 to XLA's dense route, which
// gathers every pair into an (npair, M, N) tensor, multiplies it by the whole
// npair x npair matrix and gathers back (2 npair^2 M N FLOPs: 3.5 TFLOP an
// application at npair 1296 and 10^6 determinants, most of them on
// excitations that leave the subspace).  It was added because that dense
// product was most of a solve on this card.  It computes the function of
// cross_spin_kernel above, with the same formulation, in f64: f64 loads, f64
// FMAs (DFMA) into an f64 register sum per output element, in a fixed order
// of summation and with no atomics.  Tensor cores do not apply, for the
// reason given above: there is no dense product.
//
// What bounds it on this card.  The in-set couples' FLOPs at the H100's 34
// TFLOP/s f64 rate outside the tensor cores (the headline's 0.78 GFLOP:
// 23 us), or its bytes, inputs read and output written once at 3.35 TB/s
// (the headline's 18.4 MB: c and sigma 8.4 MB each, the tables and the
// 0.5-MB matrix: 5.5 us), whichever is larger: operations bound it at the
// headline, config 5 and the CASCI, bytes at npair 784, where a row has
// few valid pairs.  What limits this design is what limits the f32 one,
// twice over: each FMA reads two 8-byte operands from shared memory (16
// bytes a FMA against the f32 kernel's 8), so shared-memory bandwidth caps
// it near an eighth of the DFMA rate, and the 8-byte rows halve the pair
// rows and columns one block stages.  The design keeps every operand read
// once from shared memory per FMA, in 16-byte reads that spread over the
// bank groups, and keeps the walks over the beta tables few:
// * rows of A_i and of the gathered c are double2 groups, with a stride
//   whose count of 16-byte groups is odd (plan() and row_stride() in
//   ops/cross_spin.py with itemsize 8);
// * A_i stays whole beside a column tile of at least 128 columns (the CASCI:
//   npair 256, up to 60 pairs a row, 210 columns a tile), so one walk of
//   each column's entries per k tile; past that (npair 676 or 1296) the rs
//   axis is tiled as in the f32 kernel, half the rows each;
// * the pair lists take 16 bytes a pair, as two 8-byte rows: the signs in
//   f64, then the pair indices and sources in int32.

namespace {

__global__ void __launch_bounds__(kThreads, 1)
cross_spin_f64_rows(const double* __restrict__ c, int n,
                    const int* __restrict__ ka_n, const int* __restrict__ ka_pq,
                    const int* __restrict__ ka_src, const double* __restrict__ ka_sgn, int ka,
                    const int* __restrict__ kb_n, const int* __restrict__ kb_rs,
                    const int* __restrict__ kb_src, const double* __restrict__ kb_sgn,
                    const double* __restrict__ eri_t, int npair,
                    int kp, int tile_cols, int tile_rs, double* __restrict__ out) {
    extern __shared__ double2 smem2[];
    const int kq = kp >> 1;                                  // double2 groups per row
    double2* a2 = smem2;                                     // tile_rs x kp: A_i[rs][l]
    double2* c2 = smem2 + (size_t)tile_rs * kq;              // tile_cols x kp: c[src_l, k]
    double* a_s = reinterpret_cast<double*>(a2);
    double* sgn_s = reinterpret_cast<double*>(c2 + (size_t)tile_cols * kq);  // 2 x kp: row i's pairs
    int* pq_s = reinterpret_cast<int*>(sgn_s + kp);
    int* src_s = pq_s + kp;

    const int i = blockIdx.x;
    const int tid = threadIdx.x;
    const int nv = ka_n[i];
    double* out_row = out + (size_t)i * n;
    if (nv == 0) {  // uniform across the block
        for (int j = tid; j < n; j += kThreads) out_row[j] = 0.0;
        return;
    }
    const int nq = (nv + 1) >> 1;  // double2 groups of one dot product
    const int lw = nq << 1;        // staged width; lanes l >= nv hold zeros
    for (int l = tid; l < lw; l += kThreads) {
        const bool ok = l < nv;
        pq_s[l] = ok ? ka_pq[(size_t)i * ka + l] : 0;
        src_s[l] = ok ? ka_src[(size_t)i * ka + l] : 0;
        sgn_s[l] = ok ? ka_sgn[(size_t)i * ka + l] : 0.0;
    }
    const bool rs_tiled = tile_rs < npair;
    const int warp = tid >> 5, lane = tid & 31;

    for (int j0 = 0; j0 < n; j0 += kChunk) {
        double acc[kColsPerThread];
        int cur[kColsPerThread], end[kColsPerThread];
#pragma unroll
        for (int u = 0; u < kColsPerThread; ++u) {
            const int j = j0 + tid + u * kThreads;
            acc[u] = 0.0;
            cur[u] = 0;
            end[u] = j < n ? kb_n[j] : 0;
        }
        for (int k0 = 0; k0 < n; k0 += tile_cols) {
            const int nk = min(tile_cols, n - k0);
            const int k1 = k0 + nk;
            __syncthreads();  // the pair lists are staged; the previous tile's reads are done
            // c_s[kk][l] = c[src_l, k0 + kk]: a thread per column kk, loads
            // coalesced along the rows of c, one 16-byte store per 2 lanes
            for (int kk = tid; kk < nk; kk += kThreads) {
                const double* ccol = c + k0 + kk;
                double2* dst = c2 + (size_t)kk * kq;
#pragma unroll 4
                for (int g = 0; g < nq; ++g) {
                    const int l = 2 * g;
                    const double v0 = __ldg(ccol + (size_t)src_s[l] * n);
                    const double v1 = l + 1 < nv ? __ldg(ccol + (size_t)src_s[l + 1] * n) : 0.0;
                    dst[g] = make_double2(v0, v1);
                }
            }
            for (int r0 = 0; r0 < npair; r0 += tile_rs) {
                const int r1 = min(npair, r0 + tile_rs);
                if (r0 > 0) __syncthreads();  // the previous rs tile's reads are done
                if (rs_tiled || (j0 == 0 && k0 == 0)) {
                    // a_s[r][l] = eri_t[r0 + r, pq_l] * sgn_l: a warp per row
#pragma unroll 4
                    for (int r = warp; r < r1 - r0; r += kWarps) {
                        const double* erow = eri_t + (size_t)(r0 + r) * npair;
                        for (int l = lane; l < lw; l += 32)
                            a_s[(size_t)r * kp + l] = l < nv ? __ldg(erow + pq_s[l]) * sgn_s[l] : 0.0;
                    }
                }
                __syncthreads();  // both tiles are staged
#pragma unroll
                for (int u = 0; u < kColsPerThread; ++u) {
                    const int j = j0 + tid + u * kThreads;
                    if (j >= n) continue;
                    const int stop = end[u];
                    double s = acc[u];
                    int t = cur[u];
                    // entry t's indices, loaded one entry ahead of its use
                    int k = 0, rs = 0;
                    double sg = 0.0;
                    if (t < stop) {
                        const size_t e = (size_t)t * n + j;
                        k = kb_src[e];
                        rs = kb_rs[e];
                        sg = kb_sgn[e];
                    }
                    while (t < stop && k < k1) {  // the run of this k tile
                        int k_next = 0, rs_next = 0;
                        double sg_next = 0.0;
                        if (t + 1 < stop) {
                            const size_t e = (size_t)(t + 1) * n + j;
                            k_next = kb_src[e];
                            rs_next = kb_rs[e];
                            sg_next = kb_sgn[e];
                        }
                        if (!rs_tiled || (rs >= r0 && rs < r1)) {
                            const double2* ap = a2 + (size_t)(rs - r0) * kq;
                            const double2* bp = c2 + (size_t)(k - k0) * kq;
                            double d = 0.0;
                            for (int g = 0; g < nq; ++g) {
                                const double2 a = ap[g];
                                const double2 b = bp[g];
                                d = fma(a.x, b.x, d);
                                d = fma(a.y, b.y, d);
                            }
                            s = fma(sg, d, s);
                        }
                        k = k_next;
                        rs = rs_next;
                        sg = sg_next;
                        ++t;
                    }
                    acc[u] = s;
                    if (r1 == npair) cur[u] = t;  // every rs tile has walked the run
                }
            }
        }
#pragma unroll
        for (int u = 0; u < kColsPerThread; ++u) {
            const int j = j0 + tid + u * kThreads;
            if (j < n) out_row[j] = acc[u];
        }
    }
}

}  // namespace

// As cross_spin_matvec_f32, in f64: c, ka_sgn, kb_sgn, eri_t and out are
// f64; kp >= ka is the shared row stride in doubles (even); tile_cols
// columns of c and tile_rs pair rows of A are staged per block, with row i's
// pair lists: (tile_cols + tile_rs + 2) * kp doubles of shared memory.
extern "C" int cross_spin_matvec_f64(const double* c, int m, int n, const int* ka_n,
                                     const int* ka_pq, const int* ka_src, const double* ka_sgn,
                                     int ka, const int* kb_n, const int* kb_rs,
                                     const int* kb_src, const double* kb_sgn,
                                     const double* eri_t, int npair, int kp, int tile_cols,
                                     int tile_rs, double* out, void* stream) {
    if (m <= 0 || n <= 0) return 0;
    const size_t smem = sizeof(double) * (size_t)kp * ((size_t)tile_cols + tile_rs + 2);
    if (kp < ka || kp % 2 != 0 || tile_cols < 1 || tile_rs < 1 || tile_rs > npair ||
        smem > (size_t)kMaxSmem)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        cross_spin_f64_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cross_spin_f64_rows<<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        c, n, ka_n, ka_pq, ka_src, ka_sgn, ka, kb_n, kb_rs, kb_src, kb_sgn, eri_t, npair,
        kp, tile_cols, tile_rs, out);
    return (int)cudaGetLastError();
}
