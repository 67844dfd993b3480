# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The operator's tables built on the card (``ops/card_tables``, the CUDA port
of the native enumeration) against the native host build, and the route
``tables_backend="auto"`` takes.

The tests marked ``card`` need an NVIDIA card and skip without one; on the
card they hold every table bit for bit to ``native.gather_tables`` and
``native.samespin_tables`` (``torch.equal``, widths included).  This file
imports no JAX, so the card tests run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_card_tables.py

The other tests run anywhere: the route, the slot table's order and the
launch counter on the CPU paths.
"""

import os
from itertools import combinations

import numpy as np
import pytest
import torch

from bench_torch import excitation_strings
from sqd_tpu_torch import native
from sqd_tpu_torch.models.fcidump import read_fcidump
from sqd_tpu_torch.ops import bitpack, card_tables, hamiltonian
from sqd_tpu_torch.ops.table_cache import TableCache

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sqd_tpu_torch", "data")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _fcidump(name):
    d = read_fcidump(os.path.join(DATA, name))
    return np.asarray(d["h1e"], np.float64), np.asarray(d["eri"], np.float64)


def _random_integrals(norb, seed, rank=6):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    chol = rng.normal(size=(rank, norb, norb)) * 0.3
    chol = (chol + chol.transpose(0, 2, 1)) / 2
    return h1, np.einsum("xpq,xrs->pqrs", chol, chol)


def _random_strings(norb, nelec, count, seed):
    rng = np.random.default_rng(seed)
    chosen = {sum(1 << int(b) for b in range(norb - nelec, norb))}  # the top orbitals
    while len(chosen) < count:
        chosen.add(sum(1 << int(b) for b in rng.choice(norb, nelec, replace=False)))
    return np.array(sorted(chosen), dtype=object)


def _pack(ints, norb):
    return bitpack.pack_ints(np.asarray(ints), norb)


def _lonely():
    """HF of (16o, 3e), its singles into orbitals 3-5, and {13, 14, 15}, six
    orbital changes from every other string: no neighbour but itself."""
    hf = 0b111
    singles = [hf ^ (1 << o) ^ (1 << v) for o in range(3) for v in range(3, 6)]
    return np.array(sorted([hf, *singles, 0b111 << 13]), dtype=np.int64)


def _case(name):
    """``(strs_a, strs_b, h1, eri, norb, nelec)`` of one card-test case."""
    if name in ("headline", "casci", "open_shell", "one_string", "lonely", "one_electron"):
        h1, eri = _fcidump("n2_631g_cas16o_5a5b.fcidump")
        norb = 16
        if name == "headline":
            a, b, nelec = excitation_strings(1000, 16, 5, 1), excitation_strings(1000, 16, 5, 2), (5, 5)
        elif name == "casci":
            a = b = np.array([sum(1 << o for o in occ) for occ in combinations(range(16), 5)])
            nelec = (5, 5)
        elif name == "open_shell":
            a, b, nelec = excitation_strings(600, 16, 5, 3), excitation_strings(500, 16, 4, 4), (5, 4)
        elif name == "one_string":
            a = b = np.array([0b11111], dtype=np.int64)
            nelec = (5, 5)
        elif name == "lonely":
            a = b = _lonely()
            nelec = (3, 3)
        else:
            a = b = np.array([1 << o for o in range(16)], dtype=np.int64)
            nelec = (1, 1)
    elif name in ("ccpvdz_26o", "ccpvdz_26o_sparse"):
        # the cc-pVDZ FCIDUMP's 26 highest orbitals (symmetry zeros kept)
        h1, eri = _fcidump("n2_ccpvdz_28o_7a7b.fcidump")
        h1, eri = h1[2:, 2:].copy(), eri[2:, 2:, 2:, 2:].copy()
        norb, nelec = 26, (5, 5)
        # 2000 strings a spin: n * width_full passes 4M, and the host takes "sparse"
        count = 1000 if name == "ccpvdz_26o" else 2000
        a, b = (excitation_strings(count, 26, 5, s) for s in (5, 6))
    elif name in ("c17_6144", "c17_all"):
        # C(17, 5) = 6188 strings: the first 6144 (8 bytes a key, 48 KB) and
        # all, over 17 orbitals of the cc-pVDZ FCIDUMP (symmetry zeros kept)
        h1, eri = _fcidump("n2_ccpvdz_28o_7a7b.fcidump")
        h1, eri = h1[2:19, 2:19].copy(), eri[2:19, 2:19, 2:19, 2:19].copy()
        norb, nelec = 17, (5, 5)
        every = np.array([sum(1 << o for o in occ) for occ in combinations(range(17), 5)])
        a = b = np.sort(every)[:6144] if name == "c17_6144" else np.sort(every)
    elif name == "two_words_40o":
        norb, nelec = 40, (3, 3)
        h1, eri = _random_integrals(norb, 7)
        eri[np.abs(eri) < 0.02] = 0.0  # exact zeros, some of them in kept places
        a, b = (excitation_strings(800, 40, 3, s) for s in (8, 9))
    elif name == "two_words_64o":
        norb, nelec = 64, (3, 2)
        h1, eri = _random_integrals(norb, 10, rank=2)
        a, b = _random_strings(64, 3, 300, 11), _random_strings(64, 2, 300, 12)
    else:
        raise KeyError(name)
    return _pack(a, norb), _pack(b, norb), h1, eri, norb, nelec


CARD_CASES = ["headline", "casci", "ccpvdz_26o", "ccpvdz_26o_sparse", "open_shell",
              "two_words_40o", "two_words_64o", "one_string", "lonely", "one_electron",
              "c17_6144", "c17_all"]


def _native_tables(pa, pb, h1, eri, norb, nelec):
    out = []
    for p in (pa, pb):
        src, sign = native.gather_tables(p, norb)
        out += [torch.from_numpy(src).to(torch.int64), torch.from_numpy(sign)]
    for p, ne in ((pa, nelec[0]), (pb, nelec[1])):
        idx, val = native.samespin_tables(p, h1, eri, norb, ne)
        out += [torch.from_numpy(idx).to(torch.int64), torch.from_numpy(val)]
    return out


NAMES = ["src_a", "sign_a", "src_b", "sign_b", "idx_a", "val_a", "idx_b", "val_b"]


def _assert_equal(got, want):
    for name, g, w in zip(NAMES, got, want):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, g.shape, w.shape)
        assert torch.equal(g, w), (name, int((g != w).sum()))


# ---------------------------------------------------------------- any device


@pytest.mark.parametrize("device, cache, norb, nelec, want", [
    ("cuda", False, 16, (5, 5), "card"),
    ("cuda", True, 16, (5, 5), "cache"),
    ("cuda", False, 70, (3, 3), "native"),  # three words a string
    ("cuda", True, 70, (3, 3), "native"),
    ("cuda", True, 36, (18, 18), "card"),  # too many candidates for the cache
    ("cpu", False, 16, (5, 5), "native"),
    ("cpu", True, 16, (5, 5), "cache"),
])
def test_route(device, cache, norb, nelec, want):
    """``torch.device("cuda")`` needs no card: the route reads only its type."""
    packed = _pack(np.array([(1 << nelec[0]) - 1], dtype=object), norb)
    got = hamiltonian._tables_route(torch.device(device), TableCache() if cache else None,
                                    packed, norb, nelec)
    assert got == want


@pytest.mark.parametrize("norb, nelec", [(16, 5), (26, 5), (8, 1), (8, 7), (6, 0), (6, 6),
                                         (40, 3), (64, 32)])
def test_slot_table_is_the_native_order(norb, nelec):
    """Decoded, the slot table lists ``_candidate_index_arrays``' singles and
    doubles after the diagonal, in their order: the order of
    ``sqdcore.cpp``'s ``samespin_candidates`` and of the compacted lists."""
    table = card_tables.slot_table(norb, nelec)
    assert table.dtype == np.uint32 and len(table) == native.samespin_width(norb, nelec)
    slots, nv = table.astype(np.int64), norb - nelec
    (si, sk), (di, dj, dk, dl) = hamiltonian._candidate_index_arrays(nelec, nv)
    ns = len(si)
    a, b, k, l = slots & 0xFF, slots >> 8 & 0xFF, slots >> 16 & 0xFF, slots >> 24
    assert slots[0] == 0
    np.testing.assert_array_equal(a[1:1 + ns], si)
    np.testing.assert_array_equal(k[1:1 + ns], sk)
    assert not b[1:1 + ns].any() and not l[1:1 + ns].any()
    for got, want in zip((a, b, k, l), (di, dj, dk, dl)):
        np.testing.assert_array_equal(got[1 + ns:], want)


@pytest.mark.parametrize("norb", [20, 32, 33, 64])
def test_keys_keep_the_row_order(norb):
    """One 64-bit key a string orders the packed rows as the host's search
    does (high word first), over the whole unsigned range."""
    packed = bitpack.sort_packed(_pack(_random_strings(norb, 3, 200, norb), norb))
    keys = card_tables._keys(packed).view(np.uint64)
    assert np.all(keys[1:] > keys[:-1])
    np.testing.assert_array_equal(keys & np.uint64(0xFFFFFFFF), packed[:, 0])
    with pytest.raises(ValueError, match="packed strings"):
        card_tables._keys(np.zeros((3, 3), np.uint32))


def test_cpu_paths_launch_nothing():
    """On the CPU every backend, with and without a cache, builds what it
    built before and launches no card build; the card build refuses the CPU."""
    pa, pb, h1, eri, norb, nelec = _case("lonely")
    before = card_tables.build_tables.launches, card_tables.gather_tables.launches
    want = _native_tables(pa, pb, h1, eri, norb, nelec)
    with pytest.raises(ValueError, match="CUDA device"):
        card_tables.build_tables(pa, pb, h1, eri, norb, nelec, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        card_tables.gather_tables(pa, norb, device="cpu")
    hams = [hamiltonian.build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, device="cpu",
                                              tables_backend=backend, table_cache=cache)
            for backend in ("auto", "native", "device") for cache in (None, TableCache())]
    hamiltonian.build_sci_basis(pa, pb, norb, nelec, device="cpu")
    assert (card_tables.build_tables.launches, card_tables.gather_tables.launches) == before
    for ham in hams[:4]:
        _assert_equal([ham.src_a, ham.sign_a, ham.src_b, ham.sign_b, ham.nbr_idx_a,
                       ham.nbr_val_a, ham.nbr_idx_b, ham.nbr_val_b], want)


# ---------------------------------------------------------------- the card


@pytest.mark.card
@pytest.mark.parametrize("name", CARD_CASES)
def test_card_tables_equal_native(card, name):
    pa, pb, h1, eri, norb, nelec = _case(name)
    want = _native_tables(pa, pb, h1, eri, norb, nelec)
    before = card_tables.build_tables.launches
    got = card_tables.build_tables(pa, pb, h1, eri, norb, nelec, device=card)
    torch.cuda.synchronize()
    assert card_tables.build_tables.launches == before + 1
    assert all(t.device.type == "cuda" for t in got)
    _assert_equal(got, want)
    gathers = card_tables.gather_tables.launches
    for p, src, sign in ((pa, *want[0:2]), (pb, *want[2:4])):
        _assert_equal(card_tables.gather_tables(p, norb, device=card), [src, sign])
    assert card_tables.gather_tables.launches == gathers + 2


@pytest.mark.card
@pytest.mark.parametrize("name, dtype, pad_to", [
    ("headline", torch.float64, None),
    ("headline", torch.float32, (1024, 1024)),
    ("open_shell", torch.float64, (608, 512)),
    ("two_words_40o", torch.float64, None),
])
def test_auto_operator_on_the_card_equals_native(card, name, dtype, pad_to):
    """``build_sci_hamiltonian`` with ``"auto"`` on the card: every field equal
    to ``"native"``'s, one card build per operator, none for ``"native"``;
    ``build_sci_basis`` likewise."""
    pa, pb, h1, eri, norb, nelec = _case(name)
    before = card_tables.build_tables.launches
    kwargs = dict(device=card, dtype=dtype, pad_to=pad_to)
    auto = hamiltonian.build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, **kwargs)
    assert card_tables.build_tables.launches == before + 1
    ref = hamiltonian.build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec,
                                            tables_backend="native", **kwargs)
    assert card_tables.build_tables.launches == before + 1
    for field in ref.__dataclass_fields__:
        x, y = getattr(auto, field), getattr(ref, field)
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), field
        else:
            assert x == y, field
    gathers = card_tables.gather_tables.launches
    basis = hamiltonian.build_sci_basis(pa, pb, norb, nelec, device=card)
    assert card_tables.gather_tables.launches == gathers + 2
    host = hamiltonian.build_sci_basis(pa, pb, norb, nelec, device=card, tables_backend="native")
    assert card_tables.gather_tables.launches == gathers + 2
    for field in ("src_a", "sign_a", "src_b", "sign_b"):
        assert torch.equal(getattr(basis, field), getattr(host, field)), field
