# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Postselection and batch subsampling of bitstring matrices.

The port of ``sqd_tpu.subsampling``.  The host functions are NumPy copies:
:func:`subsample` draws with ``rng.choice`` exactly as ``sqd_tpu`` does (the
loop's seeded determinism rests on it).  :func:`subsample_device` draws all
batches at once on the device by Gumbel-top-k
(:mod:`sqd_tpu_torch.ops.sampling`): the same distribution from a
``torch.Generator``'s stream.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.sampling import gumbel, gumbel_topk_indices
from .utils.deprecation import deprecate_func
from .utils.device import checked_device

__all__ = [
    "postselect_and_subsample",
    "postselect_by_hamming_right_and_left",
    "subsample",
    "subsample_device",
]

_PROBS_LENGTH = (
    "The number of elements in the probabilities array must match the "
    "number of rows in the bitstring matrix."
)


@deprecate_func(
    since="0.2.0",
    package_name="sqd-tpu",
    removal_timeline="no earlier than v0.4.0",
    additional_msg=("Instead, use the ``postselect_by_hamming_right_and_left`` function."),
)
def post_select_by_hamming_weight(
    bitstring_matrix: np.ndarray, *, hamming_right: int, hamming_left: int
) -> np.ndarray:
    """Mask of rows whose halves have the target Hamming weights (deprecated)."""
    if hamming_left < 0 or hamming_right < 0:
        raise ValueError("Hamming weights must be non-negative integers.")
    num_bits = bitstring_matrix.shape[1]
    up_keepers = np.sum(bitstring_matrix[:, num_bits // 2 :], axis=1) == hamming_right
    down_keepers = np.sum(bitstring_matrix[:, : num_bits // 2], axis=1) == hamming_left
    return np.logical_and(up_keepers, down_keepers)


def postselect_by_hamming_right_and_left(
    bitstring_matrix: np.ndarray,
    probabilities: np.ndarray,
    *,
    hamming_right: int,
    hamming_left: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Keep rows with the target Hamming weight on each half; renormalize probabilities.

    Raises:
        ValueError: Hamming weights must be non-negative integers.
        ValueError: The number of columns in ``bitstring_matrix`` must be even.
        ValueError: The number of elements in ``probabilities`` must equal the
            number of rows in ``bitstring_matrix``.
    """
    if hamming_left < 0 or hamming_right < 0:
        raise ValueError("Hamming weight must be specified with a non-negative integer.")
    n_bitstrings, n_bits = bitstring_matrix.shape
    if n_bits % 2:
        raise ValueError(f"The length of the bitstrings must be even. Instead, got {n_bits}.")
    if len(probabilities) != n_bitstrings:
        raise ValueError(_PROBS_LENGTH)
    norb = n_bits // 2
    valid_right = np.sum(bitstring_matrix[:, norb:], axis=1) == hamming_right
    valid_left = np.sum(bitstring_matrix[:, :norb], axis=1) == hamming_left
    valid_indices = np.logical_and(valid_right, valid_left)

    bitstrings_post = bitstring_matrix[valid_indices]
    probs_post = np.asarray(probabilities, dtype=float)[valid_indices]
    probs_post = probs_post / np.sum(probs_post)
    return bitstrings_post, probs_post


def _check_batches(bitstring_matrix, probabilities, samples_per_batch, num_batches) -> None:
    if len(probabilities) != bitstring_matrix.shape[0]:
        raise ValueError(_PROBS_LENGTH)
    if samples_per_batch < 1:
        raise ValueError("Samples per batch must be specified with a positive integer.")
    if num_batches < 1:
        raise ValueError("The number of batches must be specified with a positive integer.")


def subsample(
    bitstring_matrix: np.ndarray,
    probabilities: np.ndarray,
    samples_per_batch: int,
    num_batches: int,
    rand_seed: np.random.Generator | int | None = None,
) -> list[np.ndarray]:
    """Draw batches of rows: without replacement within a batch, with replacement across.

    If ``samples_per_batch >= len(bitstring_matrix)`` every batch is a copy of
    the whole matrix.

    Raises:
        ValueError: The number of elements in ``probabilities`` must equal the
            number of rows in ``bitstring_matrix``.
        ValueError: Samples per batch and number of batches must be positive integers.
    """
    if bitstring_matrix.shape[0] < 1:
        return [np.array([])] * num_batches
    _check_batches(bitstring_matrix, probabilities, samples_per_batch, num_batches)

    rng = np.random.default_rng(rand_seed)
    num_bitstrings = bitstring_matrix.shape[0]
    if samples_per_batch >= num_bitstrings:
        return [bitstring_matrix.copy() for _ in range(num_batches)]

    batches = []
    for _ in range(num_batches):
        indices = rng.choice(num_bitstrings, samples_per_batch, replace=False, p=probabilities)
        batches.append(bitstring_matrix[indices])
    return batches


def subsample_device(
    bitstring_matrix: np.ndarray,
    probabilities: np.ndarray,
    samples_per_batch: int,
    num_batches: int,
    generator: torch.Generator,
    *,
    device="cuda",
) -> list[np.ndarray]:
    """All batches drawn at once on ``device`` (Gumbel-top-k, no host loop).

    The distribution of :func:`subsample`, a different stream: the noise
    comes from ``generator``, a ``torch.Generator`` on ``device``.  The
    log-weights and the noise are f64.
    """
    if bitstring_matrix.shape[0] < 1:
        return [np.array([])] * num_batches
    _check_batches(bitstring_matrix, probabilities, samples_per_batch, num_batches)
    device = checked_device(device)
    if samples_per_batch >= bitstring_matrix.shape[0]:
        return [bitstring_matrix.copy() for _ in range(num_batches)]
    if int(np.count_nonzero(np.asarray(probabilities) > 0)) < samples_per_batch:
        # rng.choice's semantics: without replacement there are not enough
        # rows of positive probability
        raise ValueError("Fewer non-zero entries in p than size")

    p = torch.as_tensor(np.asarray(probabilities, dtype=np.float64), device=device)
    logw = torch.where(p > 0, torch.log(torch.where(p > 0, p, 1.0)), -torch.inf)
    logw = logw.expand(num_batches, -1)
    noise = gumbel(logw.shape, generator)
    idx = gumbel_topk_indices(logw, samples_per_batch, noise).cpu().numpy()
    return [bitstring_matrix[idx[b]] for b in range(num_batches)]


@deprecate_func(
    since="0.2.0",
    package_name="sqd-tpu",
    removal_timeline="no earlier than v0.4.0",
    additional_msg=(
        "Instead, use the ``postselect_by_hamming_right_and_left`` and ``subsample`` functions."
    ),
)
def postselect_and_subsample(
    bitstring_matrix: np.ndarray,
    probabilities: np.ndarray,
    *,
    hamming_right: int,
    hamming_left: int,
    samples_per_batch: int,
    num_batches: int,
    rand_seed: np.random.Generator | int | None = None,
) -> list[np.ndarray]:
    """Postselect on bipartite Hamming weight, then subsample batches (deprecated)."""
    num_bitstrings = len(bitstring_matrix)
    if num_bitstrings == 0:
        return [np.array([])] * num_batches
    if len(probabilities) != num_bitstrings:
        raise ValueError(_PROBS_LENGTH)
    if hamming_left < 0 or hamming_right < 0:
        raise ValueError("Hamming weight must be specified with a non-negative integer.")

    rng = np.random.default_rng(rand_seed)
    mask_postsel = post_select_by_hamming_weight(
        bitstring_matrix, hamming_right=hamming_right, hamming_left=hamming_left
    )
    bs_mat_postsel = bitstring_matrix[mask_postsel]
    probs_postsel = np.abs(np.asarray(probabilities, dtype=float)[mask_postsel])
    if len(probs_postsel) == 0:
        return [np.array([])] * num_batches
    probs_postsel = probs_postsel / np.sum(probs_postsel)
    return subsample(bs_mat_postsel, probs_postsel, samples_per_batch, num_batches, rand_seed=rng)
