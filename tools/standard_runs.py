"""Standardized runs behind RESULTS.md's table.

One run per shipped instance with the documented workload (reference
driver workloads where they exist), on whatever backend jax selects.
Prints one line per instance, with the device it ran on:
wall, it/s, lb estimate, MC ub with 95% CI.

Usage: python tools/standard_runs.py [instance ...]
"""

import sys
import time

import jax

sys.path.insert(0, ".")

from sqlp_tpu.config import PDHGConfig, SDConfig, autoscale_capacities
from sqlp_tpu.models.instance import load_instance
from sqlp_tpu.sd.driver import SDSolver

# instance -> (iters, config kwargs, x0 mode, B)
WORKLOADS = {
    "newsvendor": dict(iters=200),
    "lands": dict(iters=300),
    "transship": dict(iters=400),
    # reference driver workload: 1000 iters, crash start, constant rho=0.1
    # (test/instance_test/sd_single_cut_test.jl:22,51)
    "baa99-20": dict(iters=1000, x0="crash"),
    "storm": dict(iters=1500),
    # reference driver workload: 3000 iters, x0=0, adaptive rho0=1e-3
    # (test/instance_test/ssn_test.jl:31,45-48)
    "ssn": dict(iters=3000, schedule="adaptive", rho=1e-3),
}


def run_one(name: str, spec: dict) -> None:
    iters = spec["iters"]
    cfg = SDConfig(
        quad_schedule=spec.get("schedule", "constant"),
        quad_scalar_init=spec.get("rho", 0.1),
        scenarios_per_iter=spec.get("B", 1),
        pdhg=PDHGConfig(tol=1e-4, max_iters=80_000))
    cfg = autoscale_capacities(cfg, iters)
    inst = load_instance(name, dtype=cfg.jdtype)

    x0 = None
    if spec.get("x0") == "crash":
        from sqlp_tpu.models.crash import crash_x0
        x0, _, _ = crash_x0(inst, n_scenarios=10, seed=0)

    warm = SDSolver(inst, cfg, x0=x0, seed=1)
    warm.run(min(iters, 256))
    del warm
    solver = SDSolver(inst, cfg, x0=x0, seed=0)
    t0 = time.time()
    solver.run(iters)
    wall = time.time() - t0
    ub, hw, n = solver.evaluate_ci(min_samples=16384, max_samples=16384,
                                   seed=7)
    dev = jax.devices()[0]
    print(f"{name} [{dev.platform} {dev.device_kind}]: {iters} iters "
          f"{wall:.1f}s ({iters / wall:.1f} it/s) "
          f"lb={solver.lower_estimate:.4f} ub={ub:.4f} +- {hw:.4f} "
          f"(N={n})", flush=True)


def main():
    names = sys.argv[1:] or list(WORKLOADS)
    for name in names:
        run_one(name, WORKLOADS[name])


if __name__ == "__main__":
    main()
