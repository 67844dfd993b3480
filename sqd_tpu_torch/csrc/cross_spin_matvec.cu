// (C) 2026. Licensed under the Apache License, Version 2.0.
//
// Cross-spin (opposite-spin) channel of the selected-CI matvec, in f32, for
// Hopper (sm_90a).  Replaces the Pallas TPU kernel
// sqd_tpu/ops/pallas_matvec.py::cross_spin_matvec.
//
//   sigma[i, j] = sum_rs sign_b[rs, j] * g_i[rs, src_b[rs, j]]
//   g_i[rs, k]  = sum_l  eri_t[rs, pq_l] * sgn_l * c[src_l, k]
//
// where l runs over the VALID alpha pairs (pq_l, src_l, sgn_l) of alpha row i
// only, compacted once per operator by the Python wrapper.  Invalid beta
// entries carry sign 0 and are skipped; padded determinants have all-zero
// signs and come out as exact zeros.
//
// What bounds it on this card: f32 FMA issue and L2 bandwidth, not HBM.  The
// operands (c, the tables, eri_t) are a few MB and stay L2-resident; at the
// 10^6-determinant headline (M = N = 1024, npair = 256, at most ka = 36 valid
// pairs per alpha row) the work is at most 2 * npair * ka * M * N ~ 19 GFLOP
// of f32 FMAs (no tensor cores: f32 without TF32), the gathered rows of c are
// re-read from L2 once per 16 g rows (~2.4 GB), and the beta tables once per
// alpha row (~1.3 GB).
//
// Design:
// * one block per alpha row i; the TPU's 8-row tiles, its VMEM-resident
//   operands and its M % 8 / N % 128 gates do not carry over: any M and N;
// * compacted alpha pairs (at most 36 of npair = 256 at the headline) instead
//   of the dense pq axis: 7x fewer FLOPs than the plain (npair x npair) product;
// * g_i is built `rows` rows at a time into shared memory (a register tile of
//   16 g rows x 4 columns per thread, FMAs over the compacted pairs), then
//   every output column picks g_i[rs, src_b[rs, j]] with one indexed shared
//   load -- the TPU's lo/hi lane split and 128 x 128 masked pick loop existed
//   only because Mosaic cannot gather across a vreg;
// * when N exceeds one shared-memory tile, the k axis is tiled and each pick
//   keeps only the sources inside the current tile;
// * every shared-memory element is written before it is read (no stale
//   scratch, so no 0 * NaN), and the block writes its whole output row.
// wgmma, TMA and a tuned tiling are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 16;        // g rows per register tile (= rows per chunk)
constexpr int kColsPerThread = 4;   // k columns per thread per register tile
constexpr int kColTile = kThreads * kColsPerThread;
constexpr int kMaxTileCols = 1536;  // g chunk <= 96 KB: two blocks fit per SM

__global__ void __launch_bounds__(kThreads)
cross_spin_kernel(const float* __restrict__ c, int n,
                  const int* __restrict__ ka_n, const int* __restrict__ ka_pq,
                  const int* __restrict__ ka_src, const float* __restrict__ ka_sgn, int ka,
                  const int* __restrict__ src_b, const int8_t* __restrict__ sign_b,
                  const float* __restrict__ eri_t, int npair,
                  float* __restrict__ out, int cols) {
    extern __shared__ float smem[];
    constexpr int rows = kRowTile;
    float* g_s = smem;                                            // rows x cols
    float* a_s = g_s + (size_t)rows * cols;                       // ka x rows, [l][r]
    int* src_s = reinterpret_cast<int*>(a_s + (size_t)ka * rows); // ka

    const int i = blockIdx.x;
    const int tid = threadIdx.x;
    const int nv = ka_n[i];
    const size_t lrow = (size_t)i * ka;
    float* out_row = out + (size_t)i * n;
    // column j belongs to thread j % kThreads in every loop below
    for (int j = tid; j < n; j += kThreads) out_row[j] = 0.f;
    if (nv == 0) return;  // uniform across the block
    for (int l = tid; l < nv; l += kThreads) src_s[l] = ka_src[lrow + l];

    for (int rs0 = 0; rs0 < npair; rs0 += rows) {
        const int nr = min(rows, npair - rs0);
        __syncthreads();  // src_s is written
        // a_s[l][r] = eri_t[rs0 + r, pq_l] * sgn_l (zero past the last pair row)
        for (int e = tid; e < nv * rows; e += kThreads) {
            const int l = e / rows;
            const int r = e - l * rows;
            a_s[e] = r < nr
                ? eri_t[(size_t)(rs0 + r) * npair + ka_pq[lrow + l]] * ka_sgn[lrow + l]
                : 0.f;
        }
        for (int k0 = 0; k0 < n; k0 += cols) {
            const int nk = min(cols, n - k0);
            __syncthreads();  // a_s is complete; the last pick is done with g_s
            // g_s[r][kk] = sum_l a_s[l][r] * c[src_l, k0 + kk]
            for (int kb = 0; kb < nk; kb += kColTile) {
                float acc[kRowTile][kColsPerThread];
#pragma unroll
                for (int r = 0; r < kRowTile; ++r)
#pragma unroll
                    for (int u = 0; u < kColsPerThread; ++u) acc[r][u] = 0.f;
                for (int l = 0; l < nv; ++l) {
                    const float* crow = c + (size_t)src_s[l] * n + k0 + kb + tid;
                    float cv[kColsPerThread];
#pragma unroll
                    for (int u = 0; u < kColsPerThread; ++u)
                        cv[u] = kb + tid + u * kThreads < nk ? __ldg(crow + u * kThreads) : 0.f;
                    const float* ap = a_s + (size_t)l * rows;
#pragma unroll
                    for (int r = 0; r < kRowTile; ++r) {
                        const float a = ap[r];
#pragma unroll
                        for (int u = 0; u < kColsPerThread; ++u) acc[r][u] = fmaf(a, cv[u], acc[r][u]);
                    }
                }
#pragma unroll
                for (int r = 0; r < kRowTile; ++r) {
#pragma unroll
                    for (int u = 0; u < kColsPerThread; ++u) {
                        const int kk = kb + tid + u * kThreads;
                        if (r < nr && kk < nk) g_s[(size_t)r * cols + kk] = acc[r][u];
                    }
                }
            }
            __syncthreads();  // g_s tile is complete
            for (int j = tid; j < n; j += kThreads) {
                float acc = 0.f;
                for (int r = 0; r < nr; ++r) {
                    const size_t off = (size_t)(rs0 + r) * n + j;
                    const int s = sign_b[off];
                    if (s != 0) {
                        const int k = src_b[off] - k0;
                        if (k >= 0 && k < nk) acc = fmaf((float)s, g_s[(size_t)r * cols + k], acc);
                    }
                }
                out_row[j] += acc;
            }
        }
    }
}

}  // namespace

// All pointers are device pointers to C-contiguous arrays:
//   c (m, n) f32; ka_n (m,) i32; ka_pq, ka_src (m, ka) i32; ka_sgn (m, ka) f32;
//   src_b (npair, n) i32; sign_b (npair, n) i8; eri_t (npair, npair) f32;
//   out (m, n) f32, fully written.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int cross_spin_matvec_f32(const float* c, int m, int n, const int* ka_n,
                                     const int* ka_pq, const int* ka_src, const float* ka_sgn,
                                     int ka, const int* src_b, const int8_t* sign_b,
                                     const float* eri_t, int npair, float* out, void* stream) {
    if (m <= 0 || n <= 0) return 0;
    const int cols = n < kMaxTileCols ? n : kMaxTileCols;
    const size_t smem = sizeof(float) * ((size_t)kRowTile * cols + (size_t)ka * kRowTile)
                      + sizeof(int) * (size_t)ka;
    cudaError_t err = cudaFuncSetAttribute(
        cross_spin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cross_spin_kernel<<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        c, n, ka_n, ka_pq, ka_src, ka_sgn, ka, src_b, sign_b, eri_t, npair, out, cols);
    return (int)cudaGetLastError();
}
