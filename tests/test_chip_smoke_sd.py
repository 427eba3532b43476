"""chip_smoke.py's SD, certification and sharded phases at tiny sizes on
the CPU (the sharded ones on the virtual CPU devices conftest.py sets
up)."""

import importlib.util
import os

import jax
import numpy as np

from conftest import require_instance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

_LANDS = dict(quad_schedule="constant", quad_scalar_init=0.1)


def test_sd_phase():
    require_instance("lands")
    out = cs.phase_sd("lands", 64, optimum=cs.LANDS_OPT,
                      ub_max=cs.LANDS_OPT + cs.LANDS_SPREAD,
                      ub_samples=1024, chunk=16, **_LANDS)
    assert out["S"] == 64 and out["iters"] == 64
    assert np.isfinite(out["warm_s_per_iter"])
    assert out["host_fallback_count"] == 0


def test_certification_phase():
    """Every per-replication certificate sits at or below the exact SAA
    optimum HiGHS finds for its own stream."""
    require_instance("lands")
    out = cs.phase_certification("lands", 2, 40, fresh=16, **_LANDS)
    assert len(out["lb_per_rep"]) == 2
    assert min(out["saa_minus_lb"]) >= -cs.CERT_RTOL * 400.0
    assert out["dual_infeas_max"] <= cs.CERT_DUAL_INFEAS


def test_host_ef_matches_the_scenario_lps():
    """solve_ef_host at a single scenario is the first-stage LP plus that
    scenario's recourse: at a fixed x it equals c'x + the recourse LP."""
    require_instance("lands")
    from sqlp_tpu.models.instance import load_instance
    from sqlp_tpu.models.routines import solve_lp_host
    from sqlp_tpu.models.scenario import sample_deltas
    from sqlp_tpu.sd.algorithm import _scenario_rhs

    inst = load_instance("lands")
    d = np.asarray(sample_deltas(jax.random.PRNGKey(3),
                                 inst.scenario_model, 5), np.float64)
    v = cs.solve_ef_host(inst.arrays, inst.scenario_model, d,
                         np.full(5, 0.2))
    # any feasible x gives an upper bound on the EF optimum
    x = np.array([3.0, 3.0, 3.0, 3.0])
    a = inst.arrays
    H = np.asarray(_scenario_rhs(a, inst.scenario_model, d, x))
    rec = [solve_lp_host(np.asarray(a.q), np.asarray(a.W), H[s],
                         np.asarray(a.senses2), np.asarray(a.lb2),
                         np.asarray(a.ub2))[0] for s in range(5)]
    assert v <= float(np.asarray(a.c) @ x) + np.mean(rec) + 1e-9


def test_four_card_phases_on_virtual_devices():
    """The --four-cards path: lands f64 trajectory equality on three
    meshes, and a sharded SD run against the single-device run."""
    require_instance("lands")
    assert jax.device_count() >= 4
    out = cs.phase_mesh_trajectories(4)
    assert len(out["layouts"]) == 3
    out = cs.phase_sharded_sd("lands", 4, 16, max_scenarios=128,
                              max_dual_vertices=64, max_cuts=16, **_LANDS)
    assert out["S"] == 128
