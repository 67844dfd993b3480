# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The port's Davidson solver against ``sqd_tpu``'s on the same f64 operator.

Same operator, same start vector: ``|d theta| <= 1e-10`` and
``|<u_jax, u_port>| >= 1 - 1e-8``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqd_tpu.models.hubbard import hubbard_integrals
from sqd_tpu.ops import bitpack, dense_fci
from sqd_tpu.ops import davidson as jax_davidson
from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian as jax_build
from sqd_tpu.ops.hamiltonian import sci_matvec_flat as jax_matvec_flat

from test_torch_native_state import sqd_tpu_native_loaded  # noqa: F401  (autouse fixture)
from sqd_tpu_torch.convert import FIELDS, hamiltonian_from_numpy
from sqd_tpu_torch.ops import davidson
from sqd_tpu_torch.ops.hamiltonian import sci_matvec_flat

torch.set_num_threads(2)

NORB, NELEC = 7, (3, 3)


@pytest.fixture(scope="module")
def operators():
    h1, eri = hubbard_integrals(NORB, u=4.0)
    rng = np.random.default_rng(21)
    a = rng.normal(size=(NORB, NORB))
    h1 = h1 + 0.05 * (a + a.T)
    allstr = dense_fci.all_hamming_strings(NORB, 3)
    sa = np.sort(rng.choice(allstr, 30, replace=False))
    sb = np.sort(rng.choice(allstr, 26, replace=False))
    pa, pb = bitpack.pack_ints(sa, NORB), bitpack.pack_ints(sb, NORB)
    ham_j = jax_build(pa, pb, h1, eri, NORB, NELEC, pad_to=(32, 32))
    ham_t = hamiltonian_from_numpy(
        {k: np.asarray(getattr(ham_j, k)) for k in FIELDS}, norb=NORB, nelec=NELEC, device="cpu"
    )
    return ham_j, ham_t


def test_initial_guess_matches(operators):
    ham_j, ham_t = operators
    ref = jax_davidson.davidson_initial_guess(ham_j.hdiag.reshape(-1))
    out = davidson.davidson_initial_guess(ham_t.hdiag.reshape(-1))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("max_subspace", [24, 6], ids=["no_restart", "thick_restart"])
def test_ground_state_matches(operators, max_subspace):
    ham_j, ham_t = operators
    v0 = np.array(jax_davidson.davidson_initial_guess(ham_j.hdiag.reshape(-1)))
    ref = jax_davidson.davidson_ground_state(
        jax_matvec_flat, ham_j, ham_j.hdiag.reshape(-1), jnp.asarray(v0),
        tol=1e-9, max_subspace=max_subspace, max_iterations=300,
    )
    out = davidson.davidson_ground_state(
        sci_matvec_flat, ham_t, ham_t.hdiag.reshape(-1), torch.as_tensor(v0),
        tol=1e-9, max_subspace=max_subspace, max_iterations=300,
    )
    assert bool(ref.converged) and out.converged
    assert abs(out.theta - float(ref.theta)) <= 1e-10
    overlap = abs(float(np.dot(out.vector.numpy(), np.asarray(ref.vector))))
    assert overlap >= 1 - 1e-8
    assert out.residual_norm < 1e-9


def test_f32_solve_is_near_f64(operators):
    """The f32 working dtype (the kernel's dtype) still finds the ground state."""
    ham_j, ham_t = operators
    ham32 = ham_t.astype(torch.float32)
    hd = ham32.hdiag.reshape(-1)
    v0 = davidson.davidson_initial_guess(hd, torch.float32)
    out = davidson.davidson_ground_state(sci_matvec_flat, ham32, hd, v0, tol=1e-4)
    ref = jax_davidson.davidson_ground_state(
        jax_matvec_flat, ham_j, ham_j.hdiag.reshape(-1),
        jax_davidson.davidson_initial_guess(ham_j.hdiag.reshape(-1)), tol=1e-9,
    )
    assert out.vector.dtype == torch.float32 and out.converged
    assert abs(out.theta - float(ref.theta)) < 1e-4
