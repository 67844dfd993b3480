# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Self-consistent configuration recovery, every row at once on the device.

The port of ``sqd_tpu.configuration_recovery``.  The repair runs as torch
ops on ``device`` (``sqd_tpu`` lowers it through XLA, not Pallas):

* per-bit flip probabilities, elementwise in (expected ratio, occupancy),
  piecewise linear with ``eps = 0.01``;
* "flip exactly ``|n_diff|`` bits without replacement, p proportional to the
  flip probabilities" as a per-row Gumbel-top-k rank and mask
  (:func:`sqd_tpu_torch.ops.sampling.rank_by_gumbel`);
* dedup and probability aggregation over packed uint32 keys on the host, after
  one copy of the repaired matrix.

The seed flow is ``sqd_tpu``'s: one integer ``rng.integers(0, 2**63 - 1)``
is drawn from the caller's NumPy generator, so the generator's later draws
(the loop's ``subsample``) stay aligned with ``sqd_tpu``.  That integer seeds
a ``torch.Generator`` on the device (:func:`_gumbel_noise`); torch cannot
reproduce ``jax.random``, so the flips themselves follow the same law from
another stream.

Behaviour shared with ``sqd_tpu``: output rows are sorted by integer value;
a row with fewer positive-probability candidate bits than ``|n_diff|`` flips
every candidate (the reference's ``rng.choice`` would raise).
"""

from __future__ import annotations

import warnings
from collections.abc import Sequence

import numpy as np
import torch

from .ops import bitpack
from .ops.sampling import gumbel, rank_by_gumbel
from .subsampling import post_select_by_hamming_weight  # re-export for API parity
from .utils.device import checked_device

__all__ = ["post_select_by_hamming_weight", "recover_configurations"]

_EPS = 0.01


def recover_configurations(
    bitstring_matrix: np.ndarray,
    probabilities: Sequence[float] | np.ndarray,
    avg_occupancies: tuple[np.ndarray, np.ndarray],
    num_elec_a: int,
    num_elec_b: int,
    rand_seed: np.random.Generator | int | None = None,
    *,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Refine bitstrings toward the target bipartite Hamming weight.

    Args:
        bitstring_matrix: 2D bool array, one bitstring per row
            (``[b_N..b_0, a_N..a_0]`` column layout).
        probabilities: 1D probability distribution over the rows.
        avg_occupancies: Pair ``(occ_a, occ_b)`` of mean spin-up / spin-down
            orbital occupancies (orbital-index order).
        num_elec_a: Number of spin-up electrons.
        num_elec_b: Number of spin-down electrons.
        rand_seed: Seed or NumPy generator controlling randomness.
        device: where the repair runs.

    Returns:
        The refined (deduplicated) bitstring matrix and updated probabilities.

    Raises:
        ValueError: The numbers of electrons must be non-negative integers.
    """
    occ_dims = len(np.array(avg_occupancies).shape)
    if occ_dims == 1:
        warnings.warn(
            "Passing avg_occupancies as a 1D array is deprecated. Pass a "
            "length-2 tuple containing the spin-up and spin-down occupancies "
            "respectively.",
            DeprecationWarning,
            stacklevel=2,
        )
        norb = bitstring_matrix.shape[1] // 2
        avg_occupancies = (np.flip(avg_occupancies[norb:]), np.flip(avg_occupancies[:norb]))

    if num_elec_a < 0 or num_elec_b < 0:
        raise ValueError("The numbers of electrons must be specified as non-negative integers.")
    device = checked_device(device)

    rng = np.random.default_rng(rand_seed)
    seed = int(rng.integers(0, 2**63 - 1))

    bs_mat = np.asarray(bitstring_matrix, dtype=bool)
    if bs_mat.size == 0:
        return bs_mat, np.asarray(probabilities, dtype=float)
    # column-space occupancies [occ_b reversed, occ_a reversed], as the columns
    occs_array = np.concatenate(
        (np.asarray(avg_occupancies[1])[::-1], np.asarray(avg_occupancies[0])[::-1])
    ).astype(np.float64)

    half = bs_mat.shape[1] // 2
    noise_l, noise_r = _gumbel_noise(seed, (bs_mat.shape[0], half), device)
    repaired = _recover_kernel(
        torch.as_tensor(bs_mat, device=device),
        torch.as_tensor(occs_array, device=device),
        noise_l,
        noise_r,
        hamming_left=int(num_elec_b),
        hamming_right=int(num_elec_a),
    ).cpu().numpy()

    # deduplicate the repaired strings, aggregating their probabilities
    packed = bitpack.pack_bool_matrix(repaired)
    order = np.lexsort(tuple(packed[:, j] for j in range(packed.shape[1])))
    s = packed[order]
    probs_sorted = np.asarray(probabilities, dtype=float)[order]
    new_group = np.ones(len(s), dtype=bool)
    if len(s) > 1:
        new_group[1:] = np.any(s[1:] != s[:-1], axis=1)
    group_ids = np.cumsum(new_group) - 1
    freqs_out = np.zeros(group_ids[-1] + 1 if len(s) else 0, dtype=float)
    np.add.at(freqs_out, group_ids, probs_sorted)
    uniq = s[new_group]
    bs_mat_out = bitpack.unpack_to_bool_matrix(uniq, bs_mat.shape[1])
    freqs_out = np.abs(freqs_out) / np.sum(np.abs(freqs_out))
    return bs_mat_out, freqs_out


def _gumbel_noise(seed: int, shape: tuple[int, int], device: torch.device):
    """The f64 Gumbel noise of the left and right halves, in that order.

    Every random number of the repair comes from here: a ``torch.Generator``
    on ``device`` seeded with ``seed`` draws the left half's noise, then the
    right half's (``sqd_tpu`` splits its key into left and right the same
    way).
    """
    generator = torch.Generator(device=device).manual_seed(seed)
    left = gumbel(shape, generator)
    return left, gumbel(shape, generator)


def _p_flip_0_to_1(ratio_exp: float, occ: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Probability of flipping a bit 0 -> 1 (elementwise in ``occ``)."""
    below = occ * eps / (ratio_exp if ratio_exp > 0 else 1.0)
    slope = (1 - eps) / (1 - ratio_exp if ratio_exp != 1.0 else 1.0)
    intercept = 1 - slope
    above = torch.full_like(occ, eps) if ratio_exp == 1.0 else occ * slope + intercept
    return torch.where(occ < ratio_exp, below, above)


def _p_flip_1_to_0(ratio_exp: float, occ: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Probability of flipping a bit 1 -> 0."""
    return _p_flip_0_to_1(1 - ratio_exp, 1 - occ, eps)


def _recover_kernel(bs_mat, occs_array, noise_l, noise_r, *, hamming_left: int,
                    hamming_right: int) -> torch.Tensor:
    """Repair all rows at once; returns the corrected bool matrix (on its device)."""
    half = bs_mat.shape[1] // 2

    def fix_half(bits, occs, target, noise):
        # bits: (S, half) bool; occs: (half,) column-space occupancies
        ratio = target / half
        p = torch.where(bits, _p_flip_1_to_0(ratio, occs[None, :]),
                        _p_flip_0_to_1(ratio, occs[None, :]))
        p = p.clamp(0.0, 1.0)
        any_p = (p > 0).any(dim=1)  # the reference's np.any(probs) gate
        n_diff = bits.sum(dim=1) - target
        # candidates: occupied bits when over weight, empty bits when under
        over = n_diff > 0
        candidate = torch.where(over[:, None], bits, ~bits) & (p > 0)
        logw = torch.where(candidate, torch.log(torch.where(candidate, p, 1.0)), -torch.inf)
        ranks, _ = rank_by_gumbel(logw, noise)
        k = n_diff.abs()[:, None]
        flip = candidate & (ranks < k) & any_p[:, None] & (n_diff != 0)[:, None]
        return bits ^ flip

    left = fix_half(bs_mat[:, :half], occs_array[:half], hamming_left, noise_l)
    right = fix_half(bs_mat[:, half:], occs_array[half:], hamming_right, noise_r)
    return torch.cat((left, right), dim=1)
