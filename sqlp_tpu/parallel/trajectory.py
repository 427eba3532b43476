"""Sharded-vs-single trajectory equality of the full SD step.

One check, two callers: ``__graft_entry__.dryrun_multichip`` runs it on
virtual CPU devices, and ``chip_smoke.py --four-cards`` on four GPUs.

Twelve full SD iterations on lands run in f64 at tight solver
tolerances on one device, then again under three real sharding layouts:

  1. 1-D mesh, scenario stores sharded;
  2. 1-D mesh with the dual-vertex pool ALSO sharded (the SASA argmax is
     quantized, sd/cuts.py:quantized_argmax, so pool-sharded score
     reductions pick the same vertex as the single-device run even on
     near-ties);
  3. 2-D (duals x scenarios) mesh, when n_devices >= 4 and even.

Collective reductions only reassociate floating point, so in f64 the
sharded x_candidate and x_incumbent must match the single-device ones to
atol 1e-8 at every iteration (tests/test_parallel.py pins the same bound).
"""

from __future__ import annotations

from typing import Callable, List

import jax
import numpy as np

N_ITERS = 12
ATOL = 1e-8


def _lands_setup(n_devices: int):
    from sqlp_tpu.config import PDHGConfig, QPConfig, SDConfig
    from sqlp_tpu.models.instance import load_instance
    from sqlp_tpu.ops.pdhg import prepare_lp
    from sqlp_tpu.sd.state import default_epigraph_spec, init_state

    cap_s = max(128, n_devices)
    config = SDConfig(
        dtype="float64",
        max_scenarios=cap_s + (-cap_s) % n_devices,
        max_dual_vertices=64, max_cuts=16,
        pdhg=PDHGConfig(tol=1e-8, max_iters=10_000),
        qp=QPConfig(tol=1e-9, max_iters=4_000),
    )
    inst = load_instance("lands", dtype=config.jdtype)
    espec = default_epigraph_spec(1, 1.0, 0.0, dtype=config.jdtype)
    prep = prepare_lp(inst.arrays.W, inst.arrays.senses2, inst.arrays.q,
                      inst.arrays.lb2, inst.arrays.ub2,
                      ruiz_iters=config.pdhg.ruiz_iters)
    state = init_state(inst, espec, config,
                       np.array([3.0, 3.0, 3.0, 3.0]), jax.random.PRNGKey(0))
    return inst, espec, prep, state, config


def check_sharded_trajectories(n_devices: int,
                               log: Callable[[str], None] = print
                               ) -> List[str]:
    """Assert trajectory equality on every layout ``n_devices`` allows.

    Needs x64 enabled and at least ``n_devices`` devices. Raises
    AssertionError on the first divergence; returns the labels of the
    layouts checked.
    """
    from sqlp_tpu.parallel.mesh import (make_mesh, make_mesh_2d, replicate,
                                        shard_state)
    from sqlp_tpu.sd.algorithm import sd_step

    assert jax.config.jax_enable_x64, "the f64 trajectory needs x64"
    assert jax.device_count() >= n_devices, (
        f"need {n_devices} devices, have {jax.device_count()}")
    inst, espec, prep, state0, config = _lands_setup(n_devices)
    assert config.max_scenarios % n_devices == 0, \
        "scenario capacity must divide the mesh"

    ref_cand, ref_inc = [], []
    s1 = state0
    for _ in range(N_ITERS):
        s1, _ = sd_step(inst.arrays, inst.scenario_model, espec, prep,
                        s1, config)
        ref_cand.append(np.asarray(s1.x_candidate))
        ref_inc.append(np.asarray(s1.x_incumbent))

    def run_sharded(mesh, shard_duals, label):
        arrays = replicate(inst.arrays, mesh)
        model = replicate(inst.scenario_model, mesh)
        espec_r = replicate(espec, mesh)
        prep_r = replicate(prep, mesh)
        ss = shard_state(state0, mesh, shard_duals=shard_duals)
        for it in range(N_ITERS):
            ss, _ = sd_step(arrays, model, espec_r, prep_r, ss, config)
            np.testing.assert_allclose(
                np.asarray(ss.x_candidate), ref_cand[it], atol=ATOL,
                err_msg=f"{label}: x_candidate diverged at iter {it}")
            np.testing.assert_allclose(
                np.asarray(ss.x_incumbent), ref_inc[it], atol=ATOL,
                err_msg=f"{label}: x_incumbent diverged at iter {it}")
        # the dual-pool dedup rounds to 16 significant bits, so duals equal
        # to ~1e-8 can still land in different buckets near a boundary
        scale = abs(float(s1.cand_est)) + 1.0
        assert abs(float(s1.cand_est) - float(ss.cand_est)) / scale < 5e-3, \
            f"{label}: cand_est inconsistent"
        assert abs(int(s1.n_duals) - int(ss.n_duals)) <= 3, label
        assert np.isfinite(float(ss.cand_est)), label
        log(f"{label}: trajectory equal (atol {ATOL:g}, f64) through "
            f"iter {N_ITERS}, cand_est={float(ss.cand_est):.9f} "
            f"(single-device {float(s1.cand_est):.9f}), "
            f"n_duals={int(ss.n_duals)}, mesh={dict(mesh.shape)}")
        return label

    done = [run_sharded(make_mesh(n_devices), False,
                        f"1-D x{n_devices} (scenarios)")]
    if config.max_dual_vertices % n_devices == 0:
        done.append(run_sharded(make_mesh(n_devices), True,
                                f"1-D x{n_devices} (scenarios+duals)"))
    if n_devices % 2 == 0 and n_devices >= 4:
        done.append(run_sharded(make_mesh_2d(2, n_devices // 2), False,
                                f"2-D 2x{n_devices // 2} "
                                f"(duals x scenarios)"))
    return done
