# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's public surface is ``sqd_tpu``'s: every name the JAX package
re-exports, and every name in the ``__all__`` of each module the port has a
counterpart of, resolves in ``sqd_tpu_torch``, and the names that raised
``NotImplementedError`` in earlier slices of the port now compute."""

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
            "sqd_tpu_torch.native", "sqd_tpu_torch.chem", "sqd_tpu_torch.chem.scf_open"} <= ours


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


# names that raised NotImplementedError in earlier slices of the port; each
# now computes what sqd_tpu's does
UNPORTED = {
    "davidson.davidson_ground_state_segmented": davidson.davidson_ground_state_segmented,
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_name_raises(name):
    """The segmented solve of a small symmetric matrix lands on its lowest
    eigenvalue through several segments (no ``NotImplementedError``)."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(60, 60))
    a = torch.as_tensor(a + a.T + np.diag(np.arange(60.0)))
    hdiag = torch.diagonal(a).clone()
    res = UNPORTED[name](lambda op, x: op @ x, a, hdiag,
                         davidson.davidson_initial_guess(hdiag), tol=1e-10, max_subspace=8,
                         segment_iterations=5)
    assert res.converged and res.iterations > 5
    assert abs(res.theta - float(torch.linalg.eigvalsh(a)[0])) < 1e-9


def test_no_name_raises_not_implemented():
    """No function of the port is a stub: the one ``NotImplementedError`` left
    is ``SCIState.rdm``'s answer to a rank other than 1 and 2, as
    ``sqd_tpu``'s."""
    raising = []
    for info in pkgutil.walk_packages(sqd_tpu_torch.__path__, "sqd_tpu_torch."):
        module = importlib.import_module(info.name)
        source = inspect.getsource(module)
        raising += [info.name] * source.count("raise NotImplementedError")
    assert raising == ["sqd_tpu_torch.fermion"]
    with pytest.raises(NotImplementedError, match="rank 3"):
        fermion.SCIState(np.ones((1, 1)), np.array([7]), np.array([7]), norb=4, nelec=(3, 3),
                         device="cpu").rdm(rank=3)


def _integrals(norb):
    rng = np.random.default_rng(norb)
    h1 = rng.normal(size=(norb, norb))
    eri = rng.normal(size=(norb,) * 4)
    eri = eri + eri.transpose(1, 0, 3, 2) + eri.transpose(2, 3, 0, 1) + eri.transpose(3, 2, 1, 0)
    return h1 + h1.T, eri


def _device_gather(strs, norb):
    return linktab.build_gather_tables(strs, norb, device="cpu")


def _device_samespin(strs, norb):
    return hamiltonian.build_samespin_tables(strs, *_integrals(norb), norb, 3, device="cpu")


def _native_samespin(strs, norb):
    return native.samespin_tables(strs, *_integrals(norb), norb, 3)


FORMERLY_UNPORTED = {
    "linktab.build_gather_tables": (_device_gather, native.gather_tables),
    "hamiltonian.build_samespin_tables": (_device_samespin, _native_samespin),
}


@pytest.mark.parametrize("name", list(FORMERLY_UNPORTED))
def test_device_table_builder_is_ported(name):
    """The two device builders that were stubs compute, on the CPU, the
    tables of the native build (their ``sqd_tpu`` comparison is in
    ``tests/test_torch_device_tables.py``)."""
    ours, native_build = FORMERLY_UNPORTED[name]
    strs = bitpack.pack_ints(np.array([0b000111, 0b001011, 0b010101, 0b100011, 0b110001]), 6)
    for got, want in zip(ours(strs, 6), native_build(strs, 6)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)


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


def _parallel_names():
    """The names ``sqd_tpu/parallel/__init__.py`` imports, read from its
    source (as ``_reexported_names`` reads the package's)."""
    import sqd_tpu.parallel

    tree = ast.parse(inspect.getsource(sqd_tpu.parallel))
    return sorted(alias.asname or alias.name
                  for node in tree.body if isinstance(node, ast.ImportFrom) and node.level == 1
                  for alias in node.names)


PARALLEL_NAMES = _parallel_names()


def test_parallel_surface_is_whole():
    assert len(PARALLEL_NAMES) == 12


@pytest.mark.parametrize("name", PARALLEL_NAMES)
def test_parallel_name_resolves(name):
    """Each name of ``sqd_tpu.parallel`` is a function of the port's
    ``parallel`` package, defined in its namesake module, and no stub."""
    from sqd_tpu import parallel as jax_parallel
    from sqd_tpu_torch import parallel

    ours, theirs = getattr(parallel, name), getattr(jax_parallel, name)
    assert callable(ours)
    assert ours.__module__ == theirs.__module__.replace("sqd_tpu", "sqd_tpu_torch", 1)
    assert "NotImplementedError" not in inspect.getsource(ours)
