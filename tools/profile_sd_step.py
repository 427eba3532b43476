"""Decompose the SD step's per-iteration wall clock on the real device.

The jitted step fuses everything, so phase timers inside it are
meaningless; instead this harness times (a) the full chunked run and
(b) ablation variants that disable one phase at a time, at a
REPRESENTATIVE state — pools populated by a warm run — because the
argmax/dedup cost scales with live counts and the PDHG/ADMM iteration
counts depend on warm-start quality.

Usage:  python tools/profile_sd_step.py [instance] [warm_iters]
"""

from __future__ import annotations

import sys
import time

import jax
import numpy as np

sys.path.insert(0, ".")

from sqlp_tpu.config import PDHGConfig, SDConfig, autoscale_capacities
from sqlp_tpu.models.instance import load_instance
from sqlp_tpu.sd.algorithm import sd_run
from sqlp_tpu.sd.driver import SDSolver


def time_chunk(solver: SDSolver, chunk: int = 64, reps: int = 3) -> float:
    """Best-of-reps seconds per iteration for one compiled chunk, from a
    fixed state (state is restored between reps)."""
    state0 = solver.state
    # compile + warm
    st, acc = sd_run(solver.arrays, solver.scenario_model, solver.espec,
                     solver.prep_sub, state0, solver.config, chunk)
    np.asarray(st.x_candidate)
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        st, acc = sd_run(solver.arrays, solver.scenario_model, solver.espec,
                         solver.prep_sub, state0, solver.config, chunk)
        np.asarray(st.x_candidate)
        best = min(best, time.time() - t0)
    return best / chunk


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "ssn"
    warm_iters = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    total_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 3000

    base = SDConfig(quad_schedule="adaptive", quad_scalar_init=1e-3,
                    pdhg=PDHGConfig(tol=1e-4, max_iters=80_000))
    base = autoscale_capacities(base, total_iters)
    inst = load_instance(name, dtype=base.jdtype)

    solver = SDSolver(inst, base, seed=0)
    t0 = time.time()
    solver.run(warm_iters)
    print(f"[warm] {warm_iters} iters in {time.time() - t0:.1f}s "
          f"(incl. compile); n_duals={int(solver.state.n_duals)} "
          f"n_cuts={int(np.sum(np.asarray(solver.state.cut_live)))}")
    state = solver.state

    variants = {
        "full": {},
        "no_crossover": dict(dual_crossover=False),
        "no_inc_cut": dict(update_incumbent_cut=False),
        "no_pool_warm": dict(pool_dual_warm_start=False),
        "qp_64max": dict(qp=base.qp.__class__(
            **{**base.qp.__dict__, "max_iters": 64})),
        "pdhg_160max": dict(pdhg=base.pdhg.__class__(
            **{**base.pdhg.__dict__, "max_iters": 160})),
    }
    out = {}
    for label, kw in variants.items():
        cfg = base.replace(**kw) if kw else base
        solver.config = cfg
        sec = time_chunk(solver, chunk=64)
        out[label] = sec
        print(f"{label:>14}: {sec * 1e3:7.2f} ms/iter "
              f"({1.0 / sec:6.1f} it/s)")
    solver.config = base

    full = out["full"]
    print("\nderived phase shares (vs full):")
    for label in ("no_crossover", "no_inc_cut", "no_pool_warm",
                  "qp_64max", "pdhg_160max"):
        if label in out:
            d = full - out[label]
            print(f"  {label:>14}: saves {d * 1e3:6.2f} ms/iter "
                  f"({100 * d / full:5.1f}%)")


if __name__ == "__main__":
    main()
