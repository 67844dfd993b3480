# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's public surface is ``sqd_tpu``'s: every name the JAX package
re-exports, and every name in the ``__all__`` of each module the port has a
counterpart of, resolves in ``sqd_tpu_torch``; what is not ported yet raises
``NotImplementedError`` when called."""

import ast
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import sqd_tpu
import sqd_tpu_torch
from sqd_tpu.ops import linktab as jax_linktab
from sqd_tpu_torch import fermion, native
from sqd_tpu_torch.models import fcidump
from sqd_tpu_torch.ops import bitpack, davidson, hamiltonian, linktab, rdm

def _reexported_names():
    """The names ``sqd_tpu/__init__.py`` imports from its own modules, read
    from its source: ``vars(sqd_tpu)`` also holds whatever submodules this
    process happened to import."""
    tree = ast.parse(inspect.getsource(sqd_tpu))
    return sorted(
        alias.asname or alias.name
        for node in tree.body if isinstance(node, ast.ImportFrom) and node.level == 1
        for alias in node.names
    )


PACKAGE_NAMES = _reexported_names()


def _module_pairs():
    """(port module, ``sqd_tpu`` module) names for every port module whose
    namesake in ``sqd_tpu`` declares an ``__all__``."""
    pairs = []
    for info in pkgutil.walk_packages(sqd_tpu_torch.__path__, "sqd_tpu_torch."):
        theirs = info.name.replace("sqd_tpu_torch", "sqd_tpu", 1)
        try:
            module = importlib.import_module(theirs)
        except ModuleNotFoundError:
            continue  # the port's own: build, convert, ops.cross_spin, ...
        if hasattr(module, "__all__"):
            pairs.append((info.name, theirs))
    return pairs


MODULE_PAIRS = _module_pairs()


def test_surface_is_wide_enough_to_mean_something():
    assert len(PACKAGE_NAMES) == 25
    assert {"solve_sci", "qubit", "BitArray", "rotate_integrals", "subsample",
            "recover_configurations", "counts_to_arrays"} <= set(PACKAGE_NAMES)
    ours = {pair[0] for pair in MODULE_PAIRS}
    assert {"sqd_tpu_torch.fermion", "sqd_tpu_torch.qubit", "sqd_tpu_torch.ops.dense_df",
            "sqd_tpu_torch.ops.davidson", "sqd_tpu_torch.ops.linktab",
            "sqd_tpu_torch.native"} <= ours


@pytest.mark.parametrize("name", PACKAGE_NAMES)
def test_package_level_name_resolves(name):
    ours, theirs = getattr(sqd_tpu_torch, name), getattr(sqd_tpu, name)
    assert type(ours) is type(theirs)  # a function, a class or the qubit module
    if name != "qubit":
        assert ours.__module__ == theirs.__module__.replace("sqd_tpu", "sqd_tpu_torch", 1)


@pytest.mark.parametrize("ours,theirs", MODULE_PAIRS, ids=[p[0] for p in MODULE_PAIRS])
def test_module_all_resolves(ours, theirs):
    port, ref = importlib.import_module(ours), importlib.import_module(theirs)
    missing = [name for name in ref.__all__ if not hasattr(port, name)]
    assert missing == []
    assert set(ref.__all__) <= set(port.__all__)


UNPORTED = {
    "fermion.solve_sci_excited": fermion.solve_sci_excited,
    "fermion.optimize_orbitals": fermion.optimize_orbitals,
    "fermion.rotate_integrals": fermion.rotate_integrals,
    "fermion.apply_excitations": fermion.apply_excitations,
    "fermion.enlarge_batch_from_transitions": fermion.enlarge_batch_from_transitions,
    "package.rotate_integrals": sqd_tpu_torch.rotate_integrals,
    "package.optimize_orbitals": sqd_tpu_torch.optimize_orbitals,
    "package.enlarge_batch_from_transitions": sqd_tpu_torch.enlarge_batch_from_transitions,
    "linktab.build_gather_tables": linktab.build_gather_tables,
    "hamiltonian.build_samespin_tables": hamiltonian.build_samespin_tables,
    "fcidump.write_fcidump": fcidump.write_fcidump,
    "davidson.davidson_ground_state_segmented": davidson.davidson_ground_state_segmented,
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_name_raises(name):
    with pytest.raises(NotImplementedError, match="not ported"):
        UNPORTED[name]("anything", key="word")


def test_small_ported_names_match():
    """``rdm1``, ``occupancy_matrix`` and ``native.available``, which the
    surface needed and which are ports, not stubs."""
    assert native.available() is True
    rng = np.random.default_rng(2)
    for norb in (7, 40):
        rows = rng.integers(0, 2, (9, norb)).astype(bool)
        packed = bitpack.pack_bool_matrix(rows)
        got = linktab.occupancy_matrix(bitpack.to_device_words(packed, "cpu"), norb)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jax_linktab.occupancy_matrix(packed, norb)))
    from sqd_tpu_torch.ops.hamiltonian import build_sci_basis

    strs = bitpack.pack_ints(np.array([0b0111, 0b1011, 0b1101]), 4)
    basis = build_sci_basis(strs, strs, 4, (3, 3), device="cpu")
    c = torch.as_tensor(rng.normal(size=(3, 3)))
    a, b = rdm.rdm1s(basis, c)
    assert torch.equal(rdm.rdm1(basis, c), a + b)
