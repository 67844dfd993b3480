"""Driver of the fixed-subspace solve: one request is one call of
``sqd_tpu_torch.fermion.solve_sci`` with the traffic's solver options (by
default none: the f32 Davidson through the kernel, the f64 refinement, the
f64 energy, the 1- and 2-RDMs), which builds the subspace's tables itself.

Set-up makes a pool of subspaces: ``"subspace": "full"`` is every string of
the configuration's orbitals and electrons (the CASCI); ``"excitation_walk"``
makes ``pool`` subspaces of ``strings_per_spin`` excitation-walk strings per
spin, subspace ``k`` from the seed ``(seed, k)``.  Request ``j`` solves
subspace ``j mod pool``; set-up warms up with one request.  The check, after
the window, judges a seeded sample of ``check_solves`` solves against
:mod:`benchmark.reference.sci` (:func:`benchmark.drivers.judging.solve_gaps`,
its ground state as the traffic's ``"ground"`` says).
"""

from __future__ import annotations

from types import SimpleNamespace

from benchmark import generators
from benchmark.drivers import judging
from benchmark.harness import problem


def setup(run):
    tr = run.cell.traffic
    prob = problem(run.cell)
    norb, (na, nb) = prob["norb"], prob["nelec"]
    if tr["subspace"] == "full":
        pool = [(generators.all_strings(norb, na), generators.all_strings(norb, nb))]
    elif tr["subspace"] == "excitation_walk":
        n = tr["strings_per_spin"]
        pool = [(generators.excitation_strings(n, norb, na, generators.seed_words(run.seed, k, 0)),
                 generators.excitation_strings(n, norb, nb, generators.seed_words(run.seed, k, 1)))
                for k in range(tr["pool"])]
    else:
        raise ValueError(f"unknown subspace {tr['subspace']!r}")
    options = judging.solver_options(tr)
    if run.control:
        options["refine_iterations"] = 0  # the program's own f32-only path
    state = SimpleNamespace(
        run=run, prob=prob, pool=pool, options=options,
        sampler=judging.Reservoir(tr["check_solves"], generators.seed_words(run.seed, 0, 7)),
    )
    _solve(state, 0)
    return state


def _solve(state, j: int):
    from sqd_tpu_torch import fermion

    prob = state.prob
    return fermion.solve_sci(state.pool[j % len(state.pool)], prob["h1"], prob["eri"],
                             prob["norb"], prob["nelec"], device=state.run.device,
                             **state.options)


def request(state, j: int) -> int:
    state.sampler.offer(j, _solve(state, j))
    return 1


def check(state) -> dict:
    return judging.solve_gaps(state.sampler.kept(), state.prob, state.run,
                              state.run.cell.traffic["ground"], state.run.cell.config)
