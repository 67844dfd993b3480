"""Driver of the SQD loop: one request is one call of
``sqd_tpu_torch.fermion.diagonalize_fermionic_hamiltonian`` (a job) on a
synthetic shot set; its units of work are the iterations it ran, counted
through the loop's ``callback``.

Set-up makes ``shot_sets`` sets of ``shots`` shots from the seed (pairs of
excitation-walk strings and uniform random bits, :mod:`benchmark.generators`)
and warms up with one job.  Job ``j`` takes set ``j mod shot_sets`` and the
loop seed ``(seed, j)``.  The check, after the window: every job's first
iteration against :mod:`benchmark.reference.iteration_zero` (exact), every
later string's Hamming weights, and a seeded sample of ``check_solves`` of
all the batch solves of the window's jobs (each batch's energy, amplitudes,
occupancies and RDMs, whether or not the loop returns it: its occupancies
feed the next iteration's recovery) against :mod:`benchmark.reference.sci`
(:func:`benchmark.drivers.judging.solve_gaps`, its ground state by Lanczos).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from benchmark import generators
from benchmark.drivers import judging
from benchmark.harness import problem
from benchmark.reference import iteration_zero

WARMUP_JOB = 1 << 32  # the loop seed's sub-stream of the warm-up job


def setup(run):
    from sqd_tpu_torch.ops.hamiltonian import pivoted_cholesky_pairs
    from sqd_tpu_torch.primitives import BitArray

    tr = run.cell.traffic
    prob = problem(run.cell)
    norb, nelec = prob["norb"], prob["nelec"]
    sets = []
    for s in range(tr["shot_sets"]):
        sa = generators.excitation_strings(tr["strings_per_spin"], norb, nelec[0],
                                           generators.seed_words(run.seed, s, 0))
        sb = generators.excitation_strings(tr["strings_per_spin"], norb, nelec[1],
                                           generators.seed_words(run.seed, s, 1))
        sets.append(generators.shots(sa, sb, norb, tr["shots"],
                                     generators.seed_words(run.seed, s, 2)))
    options = judging.solver_options(tr)
    if tr.get("eri_factor") == "pivoted_cholesky":
        factor = pivoted_cholesky_pairs(prob["eri"], norb)
        if factor is None:
            raise ValueError("the integrals have no pivoted-Cholesky pair factor")
        options["eri_factor"] = factor
    if run.control:
        options["refine_iterations"] = 0  # the program's own f32-only path
    state = SimpleNamespace(
        run=run, prob=prob, shots=sets, bit_arrays=[BitArray.from_bool_array(x) for x in sets],
        options=options, loop=dict(tr["loop"]), jobs=[],
        sampler=judging.Reservoir(tr["check_solves"], generators.seed_words(run.seed, 0, 7)),
    )
    _job(state, WARMUP_JOB, keep=False)
    return state


def _job(state, j: int, keep: bool = True) -> int:
    from sqd_tpu_torch import fermion

    prob, run = state.prob, state.run
    n_sets = len(state.shots)
    strings = []

    def callback(results):
        if keep:
            for b, r in enumerate(results):
                state.sampler.offer((j, len(strings), b), r)
        strings.append([(r.sci_state.ci_strs_a, r.sci_state.ci_strs_b) for r in results])

    job = j % n_sets if j != WARMUP_JOB else 0
    fermion.diagonalize_fermionic_hamiltonian(
        prob["h1"], prob["eri"], state.bit_arrays[job], norb=prob["norb"], nelec=prob["nelec"],
        callback=callback, seed=np.random.default_rng(generators.seed_words(run.seed, j)),
        solver_options=dict(state.options), device=run.device, **state.loop,
    )
    if keep:
        state.jobs.append({"job": j, "set": job, "strings": strings})
    return len(strings)


def request(state, j: int) -> int:
    return _job(state, j)


def check(state) -> dict:
    """The numbers the cell's limits hold: ``strings0_mismatch`` (first
    iterations' batches whose strings differ from the reference's),
    ``weight_errors`` (strings of later iterations with a wrong Hamming
    weight) and the sampled batch solves' gaps (:func:`judging.solve_gaps`)."""
    prob, run = state.prob, state.run
    norb, nelec = prob["norb"], prob["nelec"]
    mismatch, weight_errors = 0, 0
    for job in state.jobs:
        rng = np.random.default_rng(generators.seed_words(run.seed, job["job"]))
        ref = iteration_zero.batch_strings(state.shots[job["set"]], norb, nelec, rng, **state.loop)
        got = job["strings"][0]
        mismatch += abs(len(ref) - len(got))
        for (ra, rb), (ga, gb) in zip(ref, got):
            mismatch += int(not (np.array_equal(ra, np.asarray(ga))
                                 and np.array_equal(rb, np.asarray(gb))))
        for batches in job["strings"][1:]:
            for ga, gb in batches:
                weight_errors += judging.weight_errors(ga, nelec[0]) + judging.weight_errors(
                    gb, nelec[1])
    numbers = {"strings0_mismatch": float(mismatch), "weight_errors": float(weight_errors)}
    numbers.update(judging.solve_gaps(state.sampler.kept(), prob, run,
                                      run.cell.traffic["ground"], run.cell.config))
    return numbers
