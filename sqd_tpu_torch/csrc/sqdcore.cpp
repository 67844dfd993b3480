// (C) 2026. Licensed under the Apache License, Version 2.0.
//
// Native host table kernels of sqd_tpu_torch: the part of sqd_tpu's
// sqd_tpu/native/sqdcore.cpp that the port binds (sqd_tpu_torch/native.py),
// copied so that the port builds from its own sources.  Bitstrings are packed
// little-endian uint32 words (word 0 = orbitals 0..31), as in
// sqd_tpu_torch.ops.bitpack.  The functions are those of sqdcore.cpp, line for
// line, including the set-independent value kernels behind the table cache
// (gather_values, samespin_values); its connected-membership, sparse
// same-spin, integral and Pauli kernels are left out until a slice of the
// port needs them.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC sqdcore.cpp -o libsqdcore.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Per-row popcount of an (n, w) packed matrix.
void popcount_rows(const uint32_t* strs, int64_t n, int w, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t acc = 0;
        for (int j = 0; j < w; ++j) acc += __builtin_popcount(strs[i * w + j]);
        out[i] = acc;
    }
}

// Enumerate all two-hole intermediates K = I - u - v over every string I and
// every occupied pair (u < v).  Writes n * C(nelec, 2) rows of w words into
// `out` (caller-allocated).  Returns the number of rows written.
int64_t desdes_candidates(const uint32_t* strs, int64_t n, int w, int nelec,
                          uint32_t* out) {
    const int64_t pairs = (int64_t)nelec * (nelec - 1) / 2;
    std::vector<int> occ(nelec);
    int64_t row_out = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* s = strs + i * w;
        // collect occupied bit positions
        int cnt = 0;
        for (int j = 0; j < w && cnt < nelec; ++j) {
            uint32_t word = s[j];
            while (word && cnt < nelec) {
                int b = __builtin_ctz(word);
                occ[cnt++] = j * 32 + b;
                word &= word - 1;
            }
        }
        for (int a = 0; a < cnt; ++a) {
            for (int b = a + 1; b < cnt; ++b) {
                uint32_t* dst = out + row_out * w;
                std::memcpy(dst, s, w * sizeof(uint32_t));
                dst[occ[a] >> 5] ^= (uint32_t)1u << (occ[a] & 31);
                dst[occ[b] >> 5] ^= (uint32_t)1u << (occ[b] & 31);
                ++row_out;
            }
        }
        (void)pairs;
    }
    return row_out;
}

// Lexicographic (integer-value) sort + dedup of packed rows, in place into
// `out`.  Returns the number of unique rows.
static bool row_less(const uint32_t* a, const uint32_t* b, int w) {
    for (int j = w - 1; j >= 0; --j) {
        if (a[j] != b[j]) return a[j] < b[j];
    }
    return false;
}

int64_t sort_unique_rows(const uint32_t* rows, int64_t n, int w, uint32_t* out) {
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
        return row_less(rows + x * w, rows + y * w, w);
    });
    int64_t n_out = 0;
    for (int64_t k = 0; k < n; ++k) {
        const uint32_t* r = rows + order[k] * w;
        if (n_out == 0 || std::memcmp(out + (n_out - 1) * w, r, w * sizeof(uint32_t)) != 0) {
            std::memcpy(out + n_out * w, r, w * sizeof(uint32_t));
            ++n_out;
        }
    }
    return n_out;
}

// Pack arbitrary-width integer strings given as (n, w) little-endian uint32
// from string form is handled in Python; here we provide the fused
// "desdes + sort + unique" used by the RDM builder.
int64_t desdes_unique(const uint32_t* strs, int64_t n, int w, int nelec,
                      uint32_t* scratch, uint32_t* out) {
    int64_t total = desdes_candidates(strs, n, w, nelec, scratch);
    return sort_unique_rows(scratch, total, w, out);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Excitation gather tables + Slater-Condon neighbor lists (host build path).
// Mirrors sqd_tpu.ops.linktab / ops.hamiltonian semantics exactly: the
// one-time per-solve table builds of the operator.
// ---------------------------------------------------------------------------

static inline int popcount_below(const uint32_t* s, int w, int t) {
    // popcount of bits [0, t) of a packed row
    int full = t >> 5, rem = t & 31, acc = 0;
    for (int j = 0; j < full; ++j) acc += __builtin_popcount(s[j]);
    if (rem && full < w) acc += __builtin_popcount(s[full] & ((1u << rem) - 1u));
    return acc;
}

static inline bool get_bit(const uint32_t* s, int t) {
    return (s[t >> 5] >> (t & 31)) & 1u;
}

static inline void flip_bit(uint32_t* s, int t) { s[t >> 5] ^= 1u << (t & 31); }

static int64_t bsearch_row(const uint32_t* strs, int64_t n, int w, const uint32_t* key) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (row_less(strs + mid * w, key, w)) lo = mid + 1;
        else hi = mid;
    }
    if (lo < n && std::memcmp(strs + lo * w, key, w * sizeof(uint32_t)) == 0) return lo;
    return -1;
}

extern "C" {

// Per-(p,q) single-excitation gather tables: src[pq*n + J] = index of
// I = J - p + q (clamped to 0 with sign 0 when absent/invalid);
// sign = <J|a+_p a_q|I> parity.
void gather_tables(const uint32_t* strs, int64_t n, int w, int norb,
                   int32_t* out_src, int8_t* out_sign) {
    std::vector<uint32_t> buf(w);
    for (int p = 0; p < norb; ++p) {
        for (int q = 0; q < norb; ++q) {
            int64_t base = (int64_t)(p * norb + q) * n;
            for (int64_t j = 0; j < n; ++j) {
                const uint32_t* J = strs + j * w;
                if (p == q) {
                    bool occ = get_bit(J, p);
                    out_src[base + j] = occ ? (int32_t)j : 0;
                    out_sign[base + j] = occ ? 1 : 0;
                    continue;
                }
                if (!get_bit(J, p) || get_bit(J, q)) {
                    out_src[base + j] = 0;
                    out_sign[base + j] = 0;
                    continue;
                }
                std::memcpy(buf.data(), J, w * sizeof(uint32_t));
                flip_bit(buf.data(), p);
                flip_bit(buf.data(), q);  // I = J - p + q
                int64_t idx = bsearch_row(strs, n, w, buf.data());
                if (idx < 0) {
                    out_src[base + j] = 0;
                    out_sign[base + j] = 0;
                    continue;
                }
                // sign on I: remove q (parity below q in I), add p (parity
                // below p in I - q == popcount_below(I, p) - [q < p])
                int s1 = popcount_below(buf.data(), w, q);
                int s2 = popcount_below(buf.data(), w, p) - (q < p ? 1 : 0);
                out_src[base + j] = (int32_t)idx;
                out_sign[base + j] = ((s1 + s2) & 1) ? -1 : 1;
            }
        }
    }
}

// Slater-Condon same-spin neighbor candidates, laid out exactly like the
// device kernel: per row [diagonal, singles (occ x virt), doubles
// (occ-pairs x virt-pairs)]; invalid entries are (idx=0, val=0).
// eri is chemist (pq|rs), row-major norb^4; h1 is norb^2.
void samespin_candidates(const uint32_t* strs, int64_t n, int w, int norb,
                         int nelec, const double* h1, const double* eri,
                         int32_t* out_idx, double* out_val, int64_t cand_width) {
    const int nv = norb - nelec;
    const int64_t n4 = (int64_t)norb * norb * norb, n2 = (int64_t)norb * norb;
    auto E = [&](int a, int b, int c, int d) -> double {
        return eri[(int64_t)a * n4 + (int64_t)b * n2 + (int64_t)c * norb + d];
    };
    std::vector<int> occ(nelec), virt(nv);
    std::vector<uint32_t> buf(w);
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* J = strs + i * w;
        int32_t* idx_row = out_idx + i * cand_width;
        double* val_row = out_val + i * cand_width;
        // Defensive: a string whose Hamming weight disagrees with nelec would
        // overrun occ/virt (and the caller's candidate rows).  Emit an inert
        // all-zero row instead; the Python layer validates and raises first.
        int oc = 0, vc = 0;
        for (int t = 0; t < norb; ++t) {
            if (get_bit(J, t)) { if (oc < nelec) occ[oc] = t; ++oc; }
            else { if (vc < nv) virt[vc] = t; ++vc; }
        }
        if (oc != nelec || vc != nv) {
            for (int64_t c0 = 0; c0 < cand_width; ++c0) { idx_row[c0] = 0; val_row[c0] = 0.0; }
            continue;
        }
        int64_t c = 0;
        // diagonal: h_pp + 1/2 sum_{p,q in J} [(pp|qq) - (pq|qp)]
        double diag = 0.0;
        for (int a = 0; a < oc; ++a) {
            int p = occ[a];
            diag += h1[p * norb + p];
            for (int b = 0; b < oc; ++b) {
                int q = occ[b];
                diag += 0.5 * (E(p, p, q, q) - E(p, q, q, p));
            }
        }
        idx_row[c] = (int32_t)i;
        val_row[c] = diag;
        ++c;
        // singles: I = J - p + q, val = sign * (h_pq + sum_{k in I\q} [(pq|kk)-(pk|kq)])
        for (int a = 0; a < oc; ++a) {
            for (int k = 0; k < vc; ++k, ++c) {
                int p = occ[a], q = virt[k];
                std::memcpy(buf.data(), J, w * sizeof(uint32_t));
                flip_bit(buf.data(), p);
                flip_bit(buf.data(), q);
                int64_t idx = bsearch_row(strs, n, w, buf.data());
                if (idx < 0) { idx_row[c] = 0; val_row[c] = 0.0; continue; }
                double mf = h1[p * norb + q];
                for (int b = 0; b < oc; ++b) {
                    int kk = occ[b];
                    if (kk == p) continue;  // k runs over I\{q} = (J\{p}) u {q}\{q}
                    mf += E(p, q, kk, kk) - E(p, kk, kk, q);
                }
                int s1 = popcount_below(buf.data(), w, q);
                int s2 = popcount_below(buf.data(), w, p) - (q < p ? 1 : 0);
                idx_row[c] = (int32_t)idx;
                val_row[c] = (((s1 + s2) & 1) ? -1.0 : 1.0) * mf;
            }
        }
        // doubles: I = J - p - r + q + s
        for (int a = 0; a < oc; ++a) {
            for (int b = a + 1; b < oc; ++b) {
                for (int k = 0; k < vc; ++k) {
                    for (int l = k + 1; l < vc; ++l, ++c) {
                        int p = occ[a], r = occ[b], q = virt[k], s = virt[l];
                        std::memcpy(buf.data(), J, w * sizeof(uint32_t));
                        flip_bit(buf.data(), p);
                        flip_bit(buf.data(), r);
                        flip_bit(buf.data(), q);
                        flip_bit(buf.data(), s);
                        int64_t idx = bsearch_row(strs, n, w, buf.data());
                        if (idx < 0) { idx_row[c] = 0; val_row[c] = 0.0; continue; }
                        // g = sign of a+_p a+_r a_s a_q on I (sequential)
                        int par = popcount_below(buf.data(), w, q);
                        flip_bit(buf.data(), q);
                        par += popcount_below(buf.data(), w, s);
                        flip_bit(buf.data(), s);
                        par += popcount_below(buf.data(), w, r);
                        flip_bit(buf.data(), r);
                        par += popcount_below(buf.data(), w, p);
                        double g = (par & 1) ? -1.0 : 1.0;
                        val_row[c] = 0.5 * g * (E(p, q, r, s) + E(r, s, p, q)
                                                - E(p, s, r, q) - E(r, q, p, s));
                        idx_row[c] = (int32_t)idx;
                    }
                }
            }
        }
        for (; c < cand_width; ++c) { idx_row[c] = 0; val_row[c] = 0.0; }
    }
}

// ---------------------------------------------------------------------------
// SET-INDEPENDENT "values" variants for incremental table caching.
//
// The per-string halves of the table builds (candidate excited/neighbor
// STRINGS, fermionic signs, Slater-Condon matrix elements) depend only on
// the string itself (+ integrals) — never on which other strings are in the
// set.  Emitting them lets the Python layer cache per-string rows across SQD
// iterations (where string sets overlap heavily) and redo only the cheap
// vectorized membership pass against each iteration's sorted set.
// ---------------------------------------------------------------------------

// Per-(p,q) single-excitation candidate VALUES: for each target string J and
// pair pq, the source string I = J - p + q (packed) and the parity sign, or
// sign 0 when the excitation is invalid on J.  Layout: out_val[(pq*n + j)*w],
// out_sign[pq*n + j].  Diagonal pairs emit I = J with sign = occupancy.
void gather_values(const uint32_t* strs, int64_t n, int w, int norb,
                   uint32_t* out_val, int8_t* out_sign) {
    std::vector<uint32_t> buf(w);
    for (int p = 0; p < norb; ++p) {
        for (int q = 0; q < norb; ++q) {
            int64_t base = (int64_t)(p * norb + q) * n;
            for (int64_t j = 0; j < n; ++j) {
                const uint32_t* J = strs + j * w;
                uint32_t* out = out_val + (base + j) * w;
                if (p == q) {
                    std::memcpy(out, J, w * sizeof(uint32_t));
                    out_sign[base + j] = get_bit(J, p) ? 1 : 0;
                    continue;
                }
                if (!get_bit(J, p) || get_bit(J, q)) {
                    std::memset(out, 0, w * sizeof(uint32_t));
                    out_sign[base + j] = 0;
                    continue;
                }
                std::memcpy(buf.data(), J, w * sizeof(uint32_t));
                flip_bit(buf.data(), p);
                flip_bit(buf.data(), q);
                int s1 = popcount_below(buf.data(), w, q);
                int s2 = popcount_below(buf.data(), w, p) - (q < p ? 1 : 0);
                std::memcpy(out, buf.data(), w * sizeof(uint32_t));
                out_sign[base + j] = ((s1 + s2) & 1) ? -1 : 1;
            }
        }
    }
}

// Same-spin Slater-Condon neighbor VALUES: per row the candidate neighbor
// strings (packed) and signed matrix elements, membership-free.  Layout per
// row: [diagonal, singles, doubles] exactly like samespin_candidates; the
// diagonal slot stores J itself.
void samespin_values(const uint32_t* strs, int64_t n, int w, int norb,
                     int nelec, const double* h1, const double* eri,
                     uint32_t* out_nbr, double* out_val, int64_t cand_width) {
    const int nv = norb - nelec;
    const int64_t n4 = (int64_t)norb * norb * norb, n2 = (int64_t)norb * norb;
    auto E = [&](int a, int b, int c, int d) -> double {
        return eri[(int64_t)a * n4 + (int64_t)b * n2 + (int64_t)c * norb + d];
    };
    std::vector<int> occ(nelec), virt(nv);
    std::vector<uint32_t> buf(w);
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* J = strs + i * w;
        uint32_t* nbr_row = out_nbr + i * cand_width * w;
        double* val_row = out_val + i * cand_width;
        int oc = 0, vc = 0;
        for (int t = 0; t < norb; ++t) {
            if (get_bit(J, t)) { if (oc < nelec) occ[oc] = t; ++oc; }
            else { if (vc < nv) virt[vc] = t; ++vc; }
        }
        if (oc != nelec || vc != nv) {
            std::memset(nbr_row, 0, cand_width * w * sizeof(uint32_t));
            for (int64_t c0 = 0; c0 < cand_width; ++c0) val_row[c0] = 0.0;
            continue;
        }
        int64_t c = 0;
        double diag = 0.0;
        for (int a = 0; a < oc; ++a) {
            int p = occ[a];
            diag += h1[p * norb + p];
            for (int b = 0; b < oc; ++b) {
                int q = occ[b];
                diag += 0.5 * (E(p, p, q, q) - E(p, q, q, p));
            }
        }
        std::memcpy(nbr_row + c * w, J, w * sizeof(uint32_t));
        val_row[c] = diag;
        ++c;
        for (int a = 0; a < oc; ++a) {
            for (int k = 0; k < vc; ++k, ++c) {
                int p = occ[a], q = virt[k];
                std::memcpy(buf.data(), J, w * sizeof(uint32_t));
                flip_bit(buf.data(), p);
                flip_bit(buf.data(), q);
                double mf = h1[p * norb + q];
                for (int b = 0; b < oc; ++b) {
                    int kk = occ[b];
                    if (kk == p) continue;
                    mf += E(p, q, kk, kk) - E(p, kk, kk, q);
                }
                int s1 = popcount_below(buf.data(), w, q);
                int s2 = popcount_below(buf.data(), w, p) - (q < p ? 1 : 0);
                std::memcpy(nbr_row + c * w, buf.data(), w * sizeof(uint32_t));
                val_row[c] = (((s1 + s2) & 1) ? -1.0 : 1.0) * mf;
            }
        }
        for (int a = 0; a < oc; ++a) {
            for (int b = a + 1; b < oc; ++b) {
                for (int k = 0; k < vc; ++k) {
                    for (int l = k + 1; l < vc; ++l, ++c) {
                        int p = occ[a], r = occ[b], q = virt[k], s = virt[l];
                        std::memcpy(buf.data(), J, w * sizeof(uint32_t));
                        flip_bit(buf.data(), p);
                        flip_bit(buf.data(), r);
                        flip_bit(buf.data(), q);
                        flip_bit(buf.data(), s);
                        std::memcpy(nbr_row + c * w, buf.data(), w * sizeof(uint32_t));
                        int par = popcount_below(buf.data(), w, q);
                        flip_bit(buf.data(), q);
                        par += popcount_below(buf.data(), w, s);
                        flip_bit(buf.data(), s);
                        par += popcount_below(buf.data(), w, r);
                        flip_bit(buf.data(), r);
                        par += popcount_below(buf.data(), w, p);
                        double g = (par & 1) ? -1.0 : 1.0;
                        val_row[c] = 0.5 * g * (E(p, q, r, s) + E(r, s, p, q)
                                                - E(p, s, r, q) - E(r, q, p, s));
                    }
                }
            }
        }
        for (; c < cand_width; ++c) {
            std::memset(nbr_row + c * w, 0, w * sizeof(uint32_t));
            val_row[c] = 0.0;
        }
    }
}

}  // extern "C"
