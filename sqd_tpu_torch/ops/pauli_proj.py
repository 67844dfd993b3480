# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Pauli-operator projection onto a computational-basis subspace (port of
``sqd_tpu.ops.pauli_proj``).

For each Pauli term ``P = (z, x)`` the connected configuration of a basis
state is ``conn = bits XOR x`` and the amplitude is
``i^{#Y} * (-1)^{popcount(bits AND z)}``.  Membership of the connected
strings resolves over the sorted packed subspace into a permutation table,
and the projected operator is matrix-free: ``(H v)[i] = sum_t c_t a_t[i] *
v[perm_t[i]]``, pure gathers.

The subspace lives on the device as the ``int64`` word tensor of
:mod:`sqd_tpu_torch.ops.bitpack`.  ``sqd_tpu`` lowers all of this through XLA
(no Pallas kernel), so the port keeps it as torch ops.  Departures, by
design:

* a complex operator is held in complex128 (complex64 for ``dense32``
  weights) and its matvec acts on complex vectors of length ``d``;
  ``sqd_tpu`` acts on the real embedding ``[[A, -B], [B, A]]`` because its
  TPU runtime has no complex dtype;
* packed sign words are ``int32`` tensors holding the ``uint32`` bits;
* the batched membership builds loop over batches of x-masks sized by
  ``_PAIR_BATCH_BYTES`` with no padding to a compiled shape, and the weight
  folds over chunks of terms accumulate with ``index_add_`` in f64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import checked_device
from . import bitpack
from .precision import complex_dtype, real_dtype

__all__ = [
    "pauli_masks_to_packed",
    "connected_table",
    "connected_table_rank",
    "connected_table_pair",
    "diagonal_sign_table",
    "pauli_term_table",
    "ProjectedPauliOperator",
    "pauli_apply_flat",
    "build_projected_operator",
    "estimate_operator_bytes",
]

# per-term chunk cap for the sign folds (elements of the (chunk, d) buffer)
_WEIGHT_CHUNK_ELEMS = 50_000_000
# byte budget for the batched pairing sort's live buffers at large d
_PAIR_BATCH_BYTES = 1_500_000_000
# d at/above which auto weights switch to the bit-packed representation
_PACKED_WEIGHTS_MIN_D = 2_000_000
# dense (U, d) f64 weight bytes above which the matvec loops over groups
_SCAN_MATVEC_BYTES = 1_500_000_000
# d at/above which membership resolves by involution pairing, not binary search
_PAIR_MIN_D = 1_000_000


def pauli_masks_to_packed(z: np.ndarray, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(z, x) boolean qubit masks -> packed uint32 words (bit q = qubit q)."""
    # qubit q == bit q: reverse into the bool-matrix column convention
    zrow = np.asarray(z, dtype=bool)[::-1][None, :]
    xrow = np.asarray(x, dtype=bool)[::-1][None, :]
    return bitpack.pack_bool_matrix(zrow)[0], bitpack.pack_bool_matrix(xrow)[0]


def _mask(words, sorted_packed: torch.Tensor) -> torch.Tensor:
    """Packed mask words (uint32 NumPy or a tensor) as int64 on the subspace's device."""
    return bitpack.to_device_words(words, sorted_packed.device).reshape(-1)


def _signs(sorted_packed: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``(-1)^{popcount(b & z)}`` per row, int32."""
    return 1 - 2 * (bitpack.torch_popcount_rows(sorted_packed & z) % 2)


def connected_table(sorted_packed: torch.Tensor, z_words, x_words):
    """Per-row (column index, sign) of one Pauli term over the sorted subspace.

    Returns ``(col, sign)``: ``col[i]`` (int32) is the subspace index of
    ``bits_i XOR x`` (or ``d`` if absent), ``sign[i]`` (int8) is
    ``(-1)^{popcount(b & z)}`` (0 if absent).  The constant ``i^{#Y}`` phase
    is NOT included (multiply per term).  Branchless binary search.
    """
    d = sorted_packed.shape[0]
    conn = sorted_packed ^ _mask(x_words, sorted_packed)
    col = bitpack.torch_find_packed(sorted_packed, conn)
    sign = _signs(sorted_packed, _mask(z_words, sorted_packed))
    ok = col >= 0
    return torch.where(ok, col, d).to(torch.int32), torch.where(ok, sign, 0).to(torch.int8)


def diagonal_sign_table(sorted_packed: torch.Tensor, z_words) -> torch.Tensor:
    """Per-row int8 sign of a DIAGONAL (X-free) Pauli term: every basis state
    connects to itself, so the projection is ``(-1)^{popcount(bits AND z)}``
    with no membership search."""
    return _signs(sorted_packed, _mask(z_words, sorted_packed)).to(torch.int8)


def pauli_term_table(sorted_packed, pauli, *, device="cuda"):
    """Matrix-free ``(col, sign, phase)`` table of ONE Pauli term, on the device.

    ``col[i]`` is the subspace index of the state connected to row ``i``
    (sentinel ``d`` when the connected string is outside the subspace),
    ``sign[i]`` the real sign, and ``phase = i^{#Y}`` the constant per-term
    factor.

    Args:
        sorted_packed: ``(d, W)`` sorted packed rows, uint32 NumPy or a tensor
            of word values (moved to ``device`` as int64).
        pauli: object with boolean ``z``/``x`` arrays in qubit order.
        device: where the table is built.
    """
    device = checked_device(device)
    sp = bitpack.to_device_words(sorted_packed, device)
    z = np.asarray(pauli.z)
    x = np.asarray(pauli.x)
    zw, xw = pauli_masks_to_packed(z, x)
    d, w = sp.shape
    phase = 1j ** int(np.sum(z & x))
    if not np.asarray(xw[:w]).any():
        col = torch.arange(d, dtype=torch.int32, device=device)
        return col, diagonal_sign_table(sp, zw[:w]), phase
    table_fn = connected_table_pair if d >= _PAIR_MIN_D else connected_table
    col, sign = table_fn(sp, zw[:w], xw[:w])
    return col, sign, phase


def connected_table_rank(sorted_packed: torch.Tensor, z_words, x_words):
    """Sort-rank variant of :func:`connected_table`.

    Sort the concatenation of (table, queries) with a tie-break flag placing
    table entries first, take a cumulative count of table entries, and check
    each query against its immediate table predecessor: one sort and one
    gather instead of ~log2(d) rounds of gathers.
    """
    n = sorted_packed.shape[0]
    dev = sorted_packed.device
    conn = sorted_packed ^ _mask(x_words, sorted_packed)
    combined = torch.cat([sorted_packed, conn])
    flags = torch.cat([torch.zeros(n, dtype=torch.int64, device=dev),
                       torch.ones(n, dtype=torch.int64, device=dev)])
    order = bitpack.torch_lex_order(combined, flags)
    flags_s = flags[order]
    payload_s = order % n  # the row of the table entry or query
    cum_table = torch.clamp(torch.cumsum(1 - flags_s, 0) - 1, min=0)  # last table entry <= here
    match = bitpack.torch_lex_eq(sorted_packed[cum_table], combined[order]) & (flags_s == 1)
    col_sorted = torch.where(match, cum_table, n)
    # back to query order; table entries have no query to write (sqd_tpu aims
    # them out of range and drops them)
    query = flags_s == 1
    col = torch.full((n,), n, dtype=torch.int64, device=dev)
    col[payload_s[query]] = col_sorted[query]
    sign = _signs(sorted_packed, _mask(z_words, sorted_packed))
    return col.to(torch.int32), torch.where(col < n, sign, 0).to(torch.int8)


def _pair_cols(sorted_packed: torch.Tensor, x_batch: torch.Tensor) -> torch.Tensor:
    """Connected-index columns ``(B, n)`` int32 of B non-diagonal x-masks, by
    involution pairing.

    Requires ``x != 0`` (diagonal terms connect every row to itself; with
    ``x == 0`` the pairing below would report every row absent).

    For a non-diagonal term the map ``a -> a ^ x`` is an INVOLUTION: ``a`` and
    ``b`` are partners iff they share the key ``k = min(a, a ^ x)`` (each key
    is shared by at most 2 distinct rows, since rows are unique).  Sorting the
    rows by ``(k, a > a^x)`` lands every partner pair ADJACENT with the
    smaller element first, so membership resolves by comparing neighbours:
    one sort of ``n`` keys per mask, no random gather.  The table depends on
    ``x`` only, so terms sharing an x-mask share it.
    """
    n = sorted_packed.shape[0]
    conn = sorted_packed[None] ^ x_batch[:, None, :]  # (B, n, W)
    gt = bitpack.torch_lex_less(conn, sorted_packed[None])  # a > a ^ x
    k = torch.where(gt[..., None], conn, sorted_packed[None])  # min(a, a ^ x)
    del conn
    flag = gt.to(torch.int64)
    order = bitpack.torch_lex_order(k, flag)  # (B, n)
    k_s = torch.take_along_dim(k, order[..., None], dim=1)
    flag_s = torch.gather(flag, 1, order)
    del k, flag
    # a pair is (flag 0 at i, flag 1 at i + 1) with equal k: each side reads
    # its neighbour; row 0 has no predecessor and row n - 1 no successor
    prev_is_partner = torch.zeros_like(gt)
    prev_is_partner[:, 1:] = (bitpack.torch_lex_eq(k_s[:, 1:], k_s[:, :-1])
                              & (flag_s[:, 1:] == 1) & (flag_s[:, :-1] == 0))
    next_is_partner = torch.zeros_like(gt)
    next_is_partner[:, :-1] = prev_is_partner[:, 1:] & (flag_s[:, :-1] == 0)
    partner = torch.full_like(order, n)
    partner[:, 1:] = torch.where(prev_is_partner[:, 1:], order[:, :-1], partner[:, 1:])
    partner[:, :-1] = torch.where(next_is_partner[:, :-1], order[:, 1:], partner[:, :-1])
    col = torch.empty_like(order).scatter_(1, order, partner)
    return col.to(torch.int32)


def connected_table_pair(sorted_packed: torch.Tensor, z_words, x_words):
    """Involution-pairing variant of :func:`connected_table` for large subspaces.

    ``(col, sign)`` of one term; see :func:`_pair_cols` for the pairing design
    (and its ``x != 0`` requirement).
    """
    n = sorted_packed.shape[0]
    col = _pair_cols(sorted_packed, _mask(x_words, sorted_packed)[None])[0]
    sign = _signs(sorted_packed, _mask(z_words, sorted_packed))
    return col, torch.where(col < n, sign, 0).to(torch.int8)


def _search_col(sorted_packed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Connected-index column of one x-mask via branchless binary search."""
    d = sorted_packed.shape[0]
    col = bitpack.torch_find_packed(sorted_packed, sorted_packed ^ x)
    return torch.where(col >= 0, col, d).to(torch.int32)


def _unpacked_signs(sign_words: torch.Tensor, d: int, dt: torch.dtype) -> torch.Tensor:
    """``(k, ceil(d/32))`` packed parity words -> ``(k, d)`` ±1 values in ``dt``.

    Bit ``i & 31`` of word ``i >> 5`` holds the term's parity at row ``i``.
    The words are int32 holding uint32 bits: ``(w >> s) & 1`` is bit ``s``
    whether the shift is arithmetic or logical.
    """
    shifts = torch.arange(32, dtype=torch.int32, device=sign_words.device)
    bits = (sign_words[..., None] >> shifts) & 1
    s = 1.0 - 2.0 * bits.to(dt)
    return s.reshape(*sign_words.shape[:-1], -1)[..., :d]


@dataclass(frozen=True)
class ProjectedPauliOperator:
    """Matrix-free projected Pauli sum over a sorted bitstring subspace.

    Terms are stored GROUPED BY X-MASK: the connected map ``a -> a ^ x``
    depends only on a term's x component, so all terms sharing an x-mask
    share one permutation table, and their ``coeff * i^{#Y} * (-1)^{b & z}``
    amplitudes fold into one weight vector per group.  The matvec is
    ``(H v)[i] = (hdiag[i] + i hdiag_im[i]) v[i] + sum_u W_u[i] v[perm_u[i]]``
    over the non-diagonal unique x-masks.

    * The DIAGONAL x-group (``x == 0``) is implicit: its permutation is the
      identity and its weight IS ``hdiag`` (real f64; ``hdiag_im`` only when
      the diagonal has an imaginary part).
    * Weights are stored DENSE (``weight``, ``(U, d)``: f64, f32, or complex128
      / complex64 for a complex operator) or BIT-PACKED (``sign_words`` and the
      per-term coefficients ``coeff``, ``(U, kmax)`` f64 or complex128):
      ``W_u[i] = sum_{t in u} c_t (1 - 2 bit_t[i])``, exact, folded in the
      matvec's dtype.  ``build_projected_operator`` picks packed at large d.
    * Large-d matvecs loop over groups (``scan_matvec``), so the transient
      footprint is O(d), not O(U d).

    For a complex operator the matvec acts on complex vectors of length
    ``d`` (``embedded_dim == dim``).  Plan memory with
    :func:`estimate_operator_bytes`.
    """

    perm: torch.Tensor  # (U, d) int32, NON-diagonal x-groups, sentinel d
    weight: torch.Tensor  # dense modes: (U, d); packed mode: (0, 0)
    hdiag: torch.Tensor  # (d,) f64, the implicit diagonal group's real weight
    hdiag_im: torch.Tensor  # (d,) f64 when the diagonal weight has an imag part, else (0,)
    sign_words: torch.Tensor  # packed mode: (U, kmax, ceil(d/32)) int32 bits; else (0, 0, 0)
    coeff: torch.Tensor  # packed mode: (U, kmax) f64 or complex128; else (0, 0)
    is_complex: bool = False  # any term coefficient with a nonzero imaginary part
    has_diag: bool = False  # a diagonal (x == 0) group exists
    packed_weights: bool = False  # weights stored as sign bits + coefficients
    scan_matvec: bool = False  # matvec loops over groups (O(d) transients)

    @property
    def dim(self) -> int:
        return self.hdiag.shape[0]

    @property
    def num_groups(self) -> int:
        """Number of unique x-masks (incl. the implicit diagonal group)."""
        return self.perm.shape[0] + (1 if self.has_diag else 0)

    @property
    def embedded_dim(self) -> int:
        """Length of the vectors :meth:`matvec` acts on (``dim``: no real embedding)."""
        return self.dim

    @property
    def shape(self) -> tuple[int, int]:
        return (self.dim, self.dim)

    @property
    def device(self) -> torch.device:
        return self.hdiag.device

    @property
    def memory_bytes(self) -> int:
        """Total bytes of the stored tensors (perm + weights/signs + diagonal)."""
        tensors = (self.perm, self.weight, self.hdiag, self.hdiag_im, self.sign_words, self.coeff)
        return sum(t.numel() * t.element_size() for t in tensors)

    def _group_weight(self, u: int, dt: torch.dtype) -> torch.Tensor:
        """Group ``u``'s weight vector in the matvec dtype ``dt``."""
        if self.packed_weights:
            s = _unpacked_signs(self.sign_words[u], self.dim, real_dtype(dt))
            return (self.coeff[u].to(dt)[:, None] * s).sum(0)
        return self.weight[u].to(dt)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """``H v`` via per-x-group gathers.

        Convention matches the reference projection: ``A[row, col] =
        amp(row)`` with ``col`` the connected index, i.e. ``(H v)[row] =
        sum_t c_t a_t(row) v[col_t(row)]``, with the ``t`` sum folded into
        per-group weights.  A real ``v`` given to a complex operator is
        promoted to complex.
        """
        if self.is_complex and not v.is_complex():
            v = v.to(complex_dtype(v.dtype))
        dt = v.dtype
        rdt = real_dtype(dt)
        out = self.hdiag.to(rdt) * v
        if self.hdiag_im.numel():
            out = out + 1j * (self.hdiag_im.to(rdt) * v)
        n_groups = self.perm.shape[0]
        if n_groups == 0:
            return out
        v_pad = torch.cat([v, v.new_zeros(1)])
        if not self.scan_matvec:
            gathered = torch.index_select(v_pad, 0, self.perm.reshape(-1)).reshape(n_groups, -1)
            return out + (self.weight.to(dt) * gathered).sum(0)
        for u in range(n_groups):
            out += self._group_weight(u, dt) * torch.index_select(v_pad, 0, self.perm[u])
        return out


def pauli_apply_flat(op: ProjectedPauliOperator, v: torch.Tensor) -> torch.Tensor:
    """Module-level matvec adapter, ``matvec(operator, x)`` for the Davidson solvers."""
    return op.matvec(v)


def _parities(sorted_packed: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``(T, d)`` int32 parity ``popcount(b_i & z_t) & 1`` of each term mask."""
    return bitpack.torch_popcount_rows(sorted_packed[None] & z[:, None, :]) & 1


def _group_weights(sorted_packed, z_stack, c_re, c_im, group_id, *, num_groups, chunk,
                   with_imag):
    """Per-group weights ``W_u[i] = sum_{t in u} c_t (-1)^{b_i & z_t}`` in f64.

    A loop over chunks of ``chunk`` terms bounds the live ``(chunk, d)`` sign
    intermediate; each chunk adds into the groups with ``index_add_``.
    Returns ``(w_re, w_im)`` with ``w_im`` None unless ``with_imag``.
    """
    d = sorted_packed.shape[0]
    dev = sorted_packed.device
    w_re = torch.zeros((num_groups, d), dtype=torch.float64, device=dev)
    w_im = torch.zeros((num_groups, d), dtype=torch.float64, device=dev) if with_imag else None
    for start in range(0, z_stack.shape[0], chunk):
        rows = slice(start, start + chunk)
        s = (1 - 2 * _parities(sorted_packed, z_stack[rows])).to(torch.float64)
        w_re.index_add_(0, group_id[rows], c_re[rows, None] * s)
        if with_imag:
            w_im.index_add_(0, group_id[rows], c_im[rows, None] * s)
    return w_re, w_im


def _sign_words_stack(sorted_packed, z_stack, *, chunk, dpad) -> torch.Tensor:
    """Packed parity words of each term, ``(T, dpad // 32)`` int32 holding uint32
    bits: bit ``i & 31`` of word ``i >> 5`` = ``popcount(b_i & z_t) & 1``.

    The lanes are summed in int64 (bit 31 of a word overflows int32) and
    wrapped to int32 explicitly.
    """
    d = sorted_packed.shape[0]
    dev = sorted_packed.device
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    out = torch.empty((z_stack.shape[0], dpad // 32), dtype=torch.int32, device=dev)
    for start in range(0, z_stack.shape[0], chunk):
        par = _parities(sorted_packed, z_stack[start:start + chunk]).to(torch.int64)
        par = torch.nn.functional.pad(par, (0, dpad - d))
        words = (par.reshape(par.shape[0], -1, 32) << shifts).sum(-1)
        out[start:start + chunk] = torch.where(words >= 2**31, words - 2**32, words)
    return out


def estimate_operator_bytes(
    d: int,
    *,
    num_nondiag_groups: int,
    max_terms_per_group: int = 1,
    weights: str = "packed",
    is_complex: bool = False,
    diag_is_complex: bool = False,
) -> int:
    """Predicted resident bytes of a :class:`ProjectedPauliOperator`.

    Equal to the built operator's ``memory_bytes``.  (``sqd_tpu``'s estimate
    takes ``has_diag`` instead of ``diag_is_complex``: it leaves out the zero
    ``hdiag`` stored without a diagonal group, and counts ``hdiag_im``
    whenever the operator is complex.)  A Davidson solve adds about
    ``2 * max_subspace`` vectors of ``d`` in its dtype.

    Args:
        d: subspace dimension (rows).
        num_nondiag_groups: unique non-diagonal x-masks ``U``.
        max_terms_per_group: packed mode's per-group term-slot count ``kmax``.
        weights: ``"packed"`` | ``"dense64"`` | ``"dense32"``.
        is_complex: whether any effective coefficient is complex.
        diag_is_complex: whether the diagonal group's weight is complex
            (``hdiag_im`` stored).
    """
    u = num_nondiag_groups
    total = u * d * 4  # perm int32
    total += d * 8 * (2 if diag_is_complex else 1)  # hdiag (+ hdiag_im)
    if weights == "packed":
        dw = -(-d // 32)
        total += u * max_terms_per_group * (dw * 4 + 8 * (2 if is_complex else 1))
    else:
        per = 8 if weights == "dense64" else 4
        total += u * d * per * (2 if is_complex else 1)
    return total


def build_projected_operator(
    sorted_packed, paulis, coeffs, *, weights: str = "auto", device="cuda"
) -> ProjectedPauliOperator:
    """Assemble the matrix-free projected operator for a Pauli sum.

    Terms are grouped by x-mask: one membership resolution per UNIQUE
    non-diagonal x (binary search below ``_PAIR_MIN_D`` rows, batched
    involution-pairing sorts at and above it), the diagonal group folds
    straight into ``hdiag``, and weights are stored dense or bit-packed per
    the memory model in :class:`ProjectedPauliOperator`.

    Args:
        sorted_packed: ``(d, W)`` sorted unique packed bitstrings (uint32
            NumPy or a tensor of word values).
        paulis: sequence of :class:`sqd_tpu_torch.primitives.Pauli`.
        coeffs: complex coefficients.
        weights: ``"auto"`` (packed at d >= 2e6 when groups are small, dense
            f64 otherwise), ``"dense64"``, ``"dense32"``, or ``"packed"``.
        device: where the operator is built and kept.
    """
    if weights not in ("auto", "dense64", "dense32", "packed"):
        raise ValueError(f"unknown weights mode: {weights!r}")
    device = checked_device(device)
    sp = bitpack.to_device_words(sorted_packed, device)
    d, w = sp.shape
    zws, xws, cs = [], [], []
    for pauli, c in zip(paulis, np.asarray(coeffs)):
        zw, xw = pauli_masks_to_packed(pauli.z, pauli.x)
        if np.any(zw[w:]) or np.any(xw[w:]):
            raise ValueError(
                f"Pauli term acts on more qubits ({len(np.asarray(pauli.z))}) than the "
                f"packed subspace encodes ({w * 32}); truncating its mask would build a "
                "wrong operator."
            )
        n_y = int(np.sum(np.asarray(pauli.z) & np.asarray(pauli.x)))
        zws.append(zw[:w])
        xws.append(xw[:w])
        cs.append(complex(c) * (1j**n_y))
    n_terms = len(cs)
    cs_arr = np.array(cs, dtype=np.complex128)
    is_complex = bool(np.any(cs_arr.imag != 0.0))

    # ---- group terms by x-mask (insertion order; diagonal group = x == 0) --
    group_of: dict[bytes, int] = {}
    group_id = np.empty(n_terms, dtype=np.int64)
    unique_x: list[np.ndarray] = []
    for t, xw in enumerate(xws):
        key = xw.tobytes()
        if key not in group_of:
            group_of[key] = len(unique_x)
            unique_x.append(xw)
        group_id[t] = group_of[key]
    x_arr = np.stack(unique_x) if unique_x else np.zeros((0, w), np.uint32)
    is_diag = ~x_arr.any(axis=1)
    has_diag = bool(is_diag.any())

    # remap non-diagonal groups to 0..U-1 preserving insertion order
    nd_order = np.nonzero(~is_diag)[0]
    u_nd = len(nd_order)
    remap = np.full(len(unique_x), -1, np.int64)
    remap[nd_order] = np.arange(u_nd)
    term_is_diag = is_diag[group_id] if n_terms else np.zeros(0, bool)
    nd_terms = np.nonzero(~term_is_diag)[0]
    dg_terms = np.nonzero(term_is_diag)[0]
    x_nd = bitpack.to_device_words(x_arr[nd_order], device)
    gid_nd = remap[group_id[nd_terms]]

    # ---- one membership table per unique non-diagonal x ---------------------
    perm = torch.empty((u_nd, d), dtype=torch.int32, device=device)
    if u_nd and d >= _PAIR_MIN_D:
        # the pairing sort's live int64 buffers per x-mask (words, keys,
        # sorted copies, order, partners): batch them to _PAIR_BATCH_BYTES
        per_x = d * (3 * w + 7) * 8
        uc = max(1, min(u_nd, _PAIR_BATCH_BYTES // per_x))
        for start in range(0, u_nd, uc):
            perm[start:start + uc] = _pair_cols(sp, x_nd[start:start + uc])
    else:
        for u in range(u_nd):  # binary search (x != 0 here)
            perm[u] = _search_col(sp, x_nd[u])

    def _fold(term_idx, n_groups, gid, with_imag):
        """Chunked weight fold over a subset of terms."""
        chunk = max(1, min(len(term_idx), _WEIGHT_CHUNK_ELEMS // max(d, 1)))
        z_stack = bitpack.to_device_words(np.stack([zws[t] for t in term_idx]), device)
        c_re = torch.as_tensor(cs_arr[term_idx].real, device=device)
        c_im = torch.as_tensor(cs_arr[term_idx].imag, device=device)
        return _group_weights(
            sp, z_stack, c_re, c_im, torch.as_tensor(gid, device=device),
            num_groups=n_groups, chunk=chunk, with_imag=with_imag,
        )

    # ---- diagonal group folds straight into hdiag ---------------------------
    empty1 = torch.zeros((0,), dtype=torch.float64, device=device)
    if len(dg_terms):
        diag_has_imag = is_complex and bool(np.any(cs_arr[dg_terms].imag != 0.0))
        hre, him = _fold(dg_terms, 1, np.zeros(len(dg_terms), np.int64), diag_has_imag)
        hdiag = hre[0]
        hdiag_im = him[0] if diag_has_imag else empty1
    else:
        hdiag = torch.zeros((d,), dtype=torch.float64, device=device)
        hdiag_im = empty1

    # ---- weight representation for the non-diagonal groups ------------------
    counts = np.bincount(gid_nd, minlength=u_nd) if u_nd else np.zeros(0, int)
    kmax = int(counts.max()) if u_nd else 0
    mode = weights
    if mode == "auto":
        # packed beats dense32 on bytes whenever kmax < 32 (d/8 per term vs
        # 4d per group) and is exact; dense f64 at small d
        mode = "packed" if (d >= _PACKED_WEIGHTS_MIN_D and u_nd and kmax <= 32) else "dense64"

    cdt = torch.complex128 if is_complex else torch.float64
    sign_words = torch.zeros((0, 0, 0), dtype=torch.int32, device=device)
    coeff = torch.zeros((0, 0), dtype=cdt, device=device)
    weight = torch.zeros((0, 0), dtype=cdt, device=device)
    if u_nd and mode == "packed":
        tcnt = len(nd_terms)
        chunk = max(1, min(tcnt, _WEIGHT_CHUNK_ELEMS // max(d, 1)))
        dpad = -(-d // 32) * 32
        z_stack = bitpack.to_device_words(np.stack([zws[t] for t in nd_terms]), device)
        words = _sign_words_stack(sp, z_stack, chunk=chunk, dpad=dpad)
        slot = np.zeros(tcnt, np.int64)
        running = np.zeros(u_nd, np.int64)
        for i, g in enumerate(gid_nd):
            slot[i] = running[g]
            running[g] += 1
        sign_words = torch.zeros((u_nd, kmax, dpad // 32), dtype=torch.int32, device=device)
        sign_words[torch.as_tensor(gid_nd, device=device), torch.as_tensor(slot, device=device)] = words
        c = np.zeros((u_nd, kmax), dtype=np.complex128)
        c[gid_nd, slot] = cs_arr[nd_terms]
        coeff = torch.as_tensor(c if is_complex else c.real.copy(), device=device)
    elif u_nd:
        wre, wim = _fold(nd_terms, u_nd, gid_nd, is_complex)
        weight = torch.complex(wre, wim) if is_complex else wre
        if mode == "dense32":
            weight = weight.to(torch.complex64 if is_complex else torch.float32)

    per_w = 8 if mode == "dense64" else 4
    scan = mode == "packed" or (u_nd * d * per_w > _SCAN_MATVEC_BYTES)
    return ProjectedPauliOperator(
        perm=perm, weight=weight, hdiag=hdiag, hdiag_im=hdiag_im,
        sign_words=sign_words, coeff=coeff,
        is_complex=is_complex, has_diag=has_diag,
        packed_weights=(mode == "packed" and u_nd > 0), scan_matvec=scan,
    )
