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


def _module_pairs(declared=True):
    """(port module, ``sqd_tpu`` module) names for every port module whose
    namesake in ``sqd_tpu`` declares an ``__all__`` (``declared=False``: does
    not declare one)."""
    pairs = []
    for info in pkgutil.walk_packages(sqd_tpu_torch.__path__, "sqd_tpu_torch."):
        theirs = info.name.replace("sqd_tpu_torch", "sqd_tpu", 1)
        try:
            module = importlib.import_module(theirs)
        except ModuleNotFoundError:
            continue  # the port's own: build, convert, ops.cross_spin, ...
        if hasattr(module, "__all__") == declared:
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


# Every parameter of every public callable of ``sqd_tpu`` that its port does
# not take, and every public callable it has no namesake of, by design: the
# key is "module:callable(parameter)" or "module:callable", module names
# relative to the package.
GROUP = "a torch.distributed process group (group=) in place of the shard_map axis name"
NOISE = "the randomness is passed explicitly (a torch.Generator or its noise) in place of a JAX key"
PYTREE = "a JAX pytree hook; torch registers no pytrees for these"
CHUNKED = "drives the TPU's chunked f32 energy; the card computes the f64 quotient directly"
EMBEDDING = "a field of the real embedding of complex operators; the port keeps complex dtypes"
DEVICE_HELPER = "the port's device-side helper of the same module is the torch_* namesake"
BY_DESIGN = {
    "ops.davidson:davidson_ground_state(axis_name)": GROUP,
    "ops.davidson:davidson_ground_state_segmented(axis_name)": GROUP,
    "ops.davidson:davidson_lowest_k(axis_name)": GROUP,
    "ops.sampling:gumbel_topk_indices(key)": NOISE,
    "ops.sampling:rank_by_gumbel(key)": NOISE,
    "subsampling:subsample_device(key)": NOISE,
    **{f"{module}:{cls}.{hook}": PYTREE
       for module, cls in (("ops.dense_df", "DenseDFOperator"), ("ops.hamiltonian", "SCIBasis"),
                           ("ops.hamiltonian", "SCIHamiltonian"),
                           ("ops.pauli_proj", "ProjectedPauliOperator"))
       for hook in ("tree_flatten", "tree_unflatten")},
    "ops.hamiltonian:expectation_value(row_block)": CHUNKED,
    "ops.hamiltonian:expectation_value(force_chunked)": CHUNKED,
    **{f"ops.pauli_proj:ProjectedPauliOperator({field})": EMBEDDING
       for field in ("weight_re", "weight_im", "coeff_re", "coeff_im")},
    "ops.pauli_proj:estimate_operator_bytes(has_diag)": (
        "diag_is_complex in its place: the port stores hdiag always and hdiag_im only for a "
        "complex diagonal (the function's docstring)"),
    **{f"ops.bitpack:jnp_{name}": DEVICE_HELPER
       for name in ("popcount", "popcount_rows", "lex_less", "lex_eq", "sort_packed",
                    "searchsorted_packed", "find_packed")},
}
SIGNATURE_PAIRS = MODULE_PAIRS + _module_pairs(declared=False)


def _public_callables(module):
    """``(name, object)`` of the module's public callables: its ``__all__``,
    or the public functions and classes it defines, each class followed by
    its public methods (bound, so a classmethod shows no ``cls``)."""
    if hasattr(module, "__all__"):
        names = module.__all__
    else:
        names = [name for name, obj in vars(module).items() if not name.startswith("_")
                 and (inspect.isfunction(obj) or inspect.isclass(obj))
                 and obj.__module__ == module.__name__]
    for name in names:
        obj = getattr(module, name)
        if inspect.isclass(obj):
            yield name, obj
            for attr, raw in vars(obj).items():
                if not attr.startswith("_") and not isinstance(raw, property) \
                        and callable(getattr(obj, attr)):
                    yield f"{name}.{attr}", getattr(obj, attr)
        elif callable(obj):
            yield name, obj


def _resolve(module, dotted):
    obj = module
    for part in dotted.split("."):
        obj = getattr(obj, part, None)
    return obj


@pytest.mark.parametrize("ours,theirs", SIGNATURE_PAIRS, ids=[p[0] for p in SIGNATURE_PAIRS])
def test_parameters_match(ours, theirs):
    """Every parameter that a public callable of the ``sqd_tpu`` module takes,
    its port takes too, and every such callable has a port, apart from
    ``BY_DESIGN``; and every entry of ``BY_DESIGN`` for this module is still a
    difference."""
    port, ref = importlib.import_module(ours), importlib.import_module(theirs)
    short = theirs.removeprefix("sqd_tpu.")
    found = set()
    for name, obj in _public_callables(ref):
        mine = _resolve(port, name)
        if mine is None:
            found.add(f"{short}:{name}")
            continue
        try:
            want = inspect.signature(obj).parameters
        except (TypeError, ValueError):
            continue  # a builtin without a signature
        have = inspect.signature(mine).parameters
        found |= {f"{short}:{name}({p})" for p in want if p not in have}
    assert found == {key for key in BY_DESIGN if key.startswith(f"{short}:")}


def test_by_design_table_is_reached():
    """Each module named in ``BY_DESIGN`` is one of the compared pairs."""
    compared = {theirs.removeprefix("sqd_tpu.") for _, theirs in SIGNATURE_PAIRS}
    assert {key.split(":")[0] for key in BY_DESIGN} <= compared


@pytest.mark.parametrize("words", [1, 3])
def test_unique_packed_matches(words):
    """``unique_packed`` with ``return_index`` and ``return_counts`` against
    ``sqd_tpu``'s on rows with duplicates: the first occurrence in the
    original order, as ``np.unique``'s."""
    from sqd_tpu.ops import bitpack as jax_bitpack

    rng = np.random.default_rng(words)
    rows = rng.integers(0, 4, size=(40, words)).astype(np.uint32)
    rows = rows[rng.integers(0, len(rows), 90)]  # duplicates, out of order
    for index in (False, True):
        for counts in (False, True):
            got = bitpack.unique_packed(rows, return_index=index, return_counts=counts)
            want = jax_bitpack.unique_packed(rows, return_index=index, return_counts=counts)
            got, want = (got, want) if index or counts else ((got,), (want,))
            assert len(got) == len(want) == 1 + index + counts
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    uniq, first = bitpack.unique_packed(rows, return_index=True)
    np.testing.assert_array_equal(rows[first], uniq)
    if words == 1:
        np.testing.assert_array_equal(first, np.unique(rows[:, 0], return_index=True)[1])


@pytest.mark.parametrize("algo", ["enum", "sparse"])
@pytest.mark.parametrize("bucket", [1, 8, 16])
def test_samespin_tables_bucket_matches(bucket, algo):
    """``native.samespin_tables(bucket=)`` against ``sqd_tpu.native``'s, bit
    for bit, by both algorithms: the width is the most neighbours rounded up
    to ``bucket``."""
    from sqd_tpu import native as jax_native

    from test_torch_native_state import ensure_sqd_tpu_native

    ensure_sqd_tpu_native()
    norb, nelec = 9, 3
    strs = bitpack.pack_ints(np.sort(np.random.default_rng(5).choice(
        [int(s) for s in range(1 << norb) if bin(s).count("1") == nelec], 40, replace=False)),
        norb)
    h1, eri = _integrals(norb)
    got = native.samespin_tables(strs, h1, eri, norb, nelec, bucket=bucket, algo=algo)
    want = jax_native.samespin_tables(strs, h1, eri, norb, nelec, bucket=bucket, algo=algo)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    most = int((got[1] != 0).sum(axis=1).max())
    assert got[0].shape[1] == max(bucket, -(-most // bucket) * bucket)


def test_default_meshes_over_given_ranks(tmp_path):
    """``default_mesh`` and ``default_grid_mesh`` over a given subset of ranks
    (rank 0 of a one-rank gloo group), a rank outside the group raising; the
    grid factors a rank count as ``sqd_tpu``'s factors a device count."""
    import jax
    import torch.distributed as dist

    from sqd_tpu.parallel import default_grid_mesh as jax_grid_mesh
    from sqd_tpu_torch.parallel import default_grid_mesh, default_mesh, grid_sharded

    for count in range(1, 9):
        assert grid_sharded._near_square(count) == jax_grid_mesh(jax.devices()[:count]).devices.shape
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = default_mesh(devices=[0], device_type="cpu")
        assert mesh.mesh_dim_names == ("batch",) and mesh.mesh.tolist() == [0]
        grid = default_grid_mesh([0], device_type="cpu")
        assert grid.mesh_dim_names == ("row", "col") and grid.mesh.tolist() == [[0]]
        assert default_mesh("x", None, "cpu").mesh.tolist() == [0]
        for bad in ([1], [0, 0], []):
            with pytest.raises(ValueError, match="distinct ranks"):
                default_mesh(devices=bad, device_type="cpu")
            with pytest.raises(ValueError, match="distinct ranks"):
                default_grid_mesh(bad, device_type="cpu")
    finally:
        dist.destroy_process_group()
