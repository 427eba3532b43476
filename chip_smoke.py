"""Smoke run of the SD solver's main path on the GPU.

    python chip_smoke.py               # one GPU: every single-card phase
    python chip_smoke.py --four-cards  # four GPUs: the sharded path only

Everything runs in this one process (the CLI phase calls
``sqlp_tpu.cli.main`` in-process), so one JAX process holds the card.
Each phase prints one line with its wall time, the numbers it compared
and the tolerance it held them to. Any failed comparison raises: the
script then exits non-zero and prints no result line. The last line of
standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Single-card phases, at the sizes users run:

  lp_panel       solve_batch on ssn at B=4096 and B=2 (the SD step's
                 panel) and storm at B=256 (f32, tol 1e-4) against HiGHS
                 in f64 on up to 64 spread-out elements;
  master_qp      the captured master/compromise QPs (tests/data) against
                 scipy's trust-constr;
  sd_cli         ``solve lands --iters 1000 --x0 crash --eval-every 500``
                 against the exact lands optimum;
  certification  ssn, R=2 replications, EF-route certificates over fresh
                 128-scenario streams plus the compromise decision; each
                 certificate against the exact SAA optimum (HiGHS, f64);
  sd_flagship    the reference's ssn driver: 3000 SD iterations,
                 adaptive prox schedule, rho0=1e-3, full capacities
                 (S=4096, D=2048, K=96), then a stratified MC upper bound.

Four-card phases (``--four-cards``): the lands f64 trajectory on three
meshes against the single-device one
(sqlp_tpu/parallel/trajectory.py), and ssn at S=4096 in f64 sharded four
ways against the single-card run of the same seed.

Precision: configure_jax() sets matmul precision "highest", so every f32
product runs at full f32 (no TF32); certificates and master QPs run in
f64.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# --- tolerances (each with its precision and reason) ------------------
# LP panel: f32 PDHG at tol 1e-4 against f64 HiGHS. The kernel's own
# relative KKT error bounds the objective error near its tol; 1e-3 is the
# bound bench.py's honesty check has always used.
LP_OBJ_RTOL = 1e-3
# LP panel duals: PDHGConfig.valid_tol, the residual the SD step and the
# MC evaluator require of a dual before they use it. Recomputed in f64 on
# the host from the returned Pi, in the kernel's own measure: the relative
# dual infeasibility ||dc * viol(q - W'pi)|| / (1 + ||dc * q||) with dc
# the Ruiz column scaling (prepare_lp).
LP_DUAL_TOL = 1e-4
# An element the kernel does not mark valid never enters a cut and is
# retried by the MC evaluator's ladder; the compared elements are spread
# over the valid ones, and at least 90% of a cold panel must be valid.
LP_VALID_MIN = 0.9
# Master QP (f64 ADMM + polish): tests/test_prox_qp.py's bounds — the
# solver's own KKT error within the solve's tol, the optimal value within
# 1e-6 relative of trust-constr's (gtol 1e-12), and the captured
# warm-stall master's capacity row (sum x = 12) within 1e-6.
QP_OBJ_RTOL = 1e-6
QP_ROW_ATOL = 1e-6
# ssn flagship (f32 SD, f64 master): the literature optimum is about 9.90.
# An MC estimate of the incumbent's cost may sit below it only by
# sampling error (3 half-widths), and a healthy run ends within about
# 10% of it.
SSN_OPT = 9.90
SSN_UB_MAX = 11.0
# lands (test/crash_test.jl:37; tests/test_sd_e2e.py:19,39-46): lb_est and
# the MC ub bracket the exact optimum to within 0.5 on the wrong side and
# 6.0 overall. The CLI's final ub comes from its own 1000 i.i.d. draws, so
# its wrong-side bound is widened by the 95% half-width the CLI prints.
LANDS_OPT = 381.8533333
LANDS_SIDE = 0.5
LANDS_SPREAD = 6.0
# Certificates (f64 refinement and exact weak-duality corrections): each
# per-replication bound may exceed its exact SAA optimum only by the f64
# round-off of the two solves (1e-6 relative); the measured dual
# infeasibility left after the projection must be below 1e-6.
CERT_RTOL = 1e-6
CERT_DUAL_INFEAS = 1e-6
# ssn sharded four ways vs one card, in f64. On the GPU the two runs do
# not stay on one trajectory: sharded cut sums are reassociated, and the
# SD step's discrete decisions (PDHG and ADMM stopping tests, dedup,
# incumbent test) amplify the difference. Measured on four H100s after 200 iterations: n_duals 250
# sharded vs 262 single in f64, cand_est 8.757 vs 8.540 in f32. So the
# two are compared as two runs of one SD process: cand_est within 2% (a
# single ssn run moves by 3-4% between 256-iteration chunks) and the dual
# pool within 10% of its size. A sharding fault (mis-sharded stores, a
# double-counted reduction) moves both by factors, not percent.
SHARD_DTYPE = "float64"
SHARD_EST_RTOL = 2e-2
SHARD_DUALS_RTOL = 0.1


def _require(ok: bool, msg: str) -> None:
    """Raise on a failed comparison (an ``assert`` would vanish under -O)."""
    if not ok:
        raise RuntimeError(msg)


def _flagship_config(iters: int = 0, **kw):
    """The reference's ssn driver settings (ssn_test.jl:31,45-48) with the
    bench's subproblem budget; capacities autoscaled to ``iters`` when it
    is given, else the full defaults (S=4096, D=2048, K=96)."""
    from sqlp_tpu.config import PDHGConfig, SDConfig, autoscale_capacities
    cfg = SDConfig(quad_schedule="adaptive", quad_scalar_init=1e-3,
                   pdhg=PDHGConfig(tol=1e-4, max_iters=80_000)).replace(**kw)
    return autoscale_capacities(cfg, iters) if iters else cfg


def _timed(fn, *args, **kw):
    """(result, seconds) of one call that ends when the device is done."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


# --- phases ------------------------------------------------------------

def phase_lp_panel(name: str, B: int, n_check: int = 64,
                   seed: int = 0) -> dict:
    """One panel of B recourse LPs at a first-stage feasible x, solved by
    the batched PDHG kernel in f32 and, on n_check elements spread over
    the ones it marks valid, by HiGHS in f64."""
    import jax
    import jax.numpy as jnp

    from sqlp_tpu.config import PDHGConfig
    from sqlp_tpu.models.instance import load_instance
    from sqlp_tpu.models.routines import project_first_stage, solve_lp_host
    from sqlp_tpu.models.scenario import sample_deltas
    from sqlp_tpu.ops.pdhg import prepare_lp, solve_batch
    from sqlp_tpu.sd.algorithm import _scenario_rhs

    cfg = PDHGConfig(tol=1e-4, max_iters=80_000)
    inst = load_instance(name, dtype=jnp.float32)
    a = inst.arrays
    x, _ = project_first_stage(a, np.zeros(inst.n1))
    deltas = sample_deltas(jax.random.PRNGKey(seed), inst.scenario_model, B)
    H = _scenario_rhs(a, inst.scenario_model, deltas,
                      jnp.asarray(x, jnp.float32))
    prep = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
    (obj, Y, Pi, st), t_cold = _timed(solve_batch, prep, H, cfg)
    (obj, Y, Pi, st), t_warm = _timed(solve_batch, prep, H, cfg)

    W = np.asarray(a.W, np.float64)
    q = np.asarray(a.q, np.float64)
    s2 = np.asarray(a.senses2)
    lb = np.asarray(a.lb2, np.float64)
    ub = np.asarray(a.ub2, np.float64)
    Hn = np.asarray(H, np.float64)
    objn = np.asarray(obj, np.float64)
    Pin = np.asarray(Pi, np.float64)
    valid = np.asarray(st["pdhg_valid"])
    dc = np.asarray(prep.col_scale, np.float64)
    ok = np.flatnonzero(valid)
    _require(ok.size >= LP_VALID_MIN * B,
             f"{name}: only {ok.size}/{B} elements reached "
             f"valid_tol={cfg.valid_tol:g}")
    idx = ok[np.unique(np.linspace(0, ok.size - 1,
                                   min(n_check, ok.size)).astype(int))]
    obj_err = dual_inf = 0.0
    for b in idx:
        ref, _, _ = solve_lp_host(q, W, Hn[b], s2, lb, ub)
        obj_err = max(obj_err, abs(objn[b] - ref) / (1.0 + abs(ref)))
        # reduced costs may take either sign at a finite bound; a
        # violation counts only where the bound that would absorb it is
        # infinite. Row duals must also sit in their sign cone.
        g = q - W.T @ Pin[b]
        viol = (np.where(np.isinf(ub), np.maximum(-g, 0.0), 0.0)
                + np.where(np.isinf(lb), np.maximum(g, 0.0), 0.0))
        cone = max(np.maximum(-Pin[b][s2 == 1], 0.0).max(initial=0.0),
                   np.maximum(Pin[b][s2 == -1], 0.0).max(initial=0.0))
        _require(cone == 0.0, f"{name}[{b}]: row dual outside its cone")
        dual_inf = max(dual_inf, np.linalg.norm(dc * viol)
                       / (1.0 + np.linalg.norm(dc * q)))
    out = {"B": B, "checked": int(idx.size),
           "valid": int(valid.sum()),
           "rounds": int(st["pdhg_rounds"]),
           "pdhg_iters": int(st["pdhg_iters"]),
           "cold_s": t_cold, "warm_s": t_warm,
           "obj_rel_err_max": obj_err, "dual_infeas_max": dual_inf}
    _require(obj_err <= LP_OBJ_RTOL,
             f"{name}: objective rel err {obj_err:.3g} > {LP_OBJ_RTOL:g}")
    _require(dual_inf <= LP_DUAL_TOL,
             f"{name}: dual infeasibility {dual_inf:.3g} > {LP_DUAL_TOL:g}")
    return out


def _trust_constr(p, g, A, l, u):
    """Reference QP solve: scipy trust-constr (tests/test_prox_qp.py)."""
    import scipy.optimize
    fun = lambda z: 0.5 * z @ (p * z) + g @ z
    res = scipy.optimize.minimize(
        fun, np.zeros(len(g)), jac=lambda z: p * z + g,
        hess=lambda z: np.diag(p), method="trust-constr",
        constraints=[scipy.optimize.LinearConstraint(A, l, u)],
        options={"gtol": 1e-12, "xtol": 1e-14})
    return res.x, float(res.fun)


def phase_master_qp() -> dict:
    """The captured lands compromise QPs and the warm-stall master QP."""
    import jax.numpy as jnp

    from sqlp_tpu.config import QPConfig
    from sqlp_tpu.ops.prox_qp import solve_qp

    data = os.path.join(REPO, "tests", "data")
    out = {}
    for name in ("compqp", "compqp2", "compqp3",
                 "master_qp_warm_stall_lands"):
        d = np.load(os.path.join(data, name + ".npz"))
        p = d["p_diag"] if "p_diag" in d.files else d["p"]
        args = [jnp.asarray(v) for v in
                (p, d["g"], d["A"], d["l"], d["u"], d["is_eq"])]
        warm = {}
        if "warm_z" in d.files:
            cfg = QPConfig(tol=1e-9, max_iters=4_000)
            warm = dict(z0=jnp.asarray(d["warm_z"]),
                        mu0=jnp.asarray(d["warm_mu"]))
        else:
            cfg = QPConfig(tol=1e-7, max_iters=8_000)
        (z, mu, st), t_cold = _timed(solve_qp, *args, cfg, **warm)
        (z, mu, st), t_warm = _timed(solve_qp, *args, cfg, **warm)
        z = np.asarray(z, np.float64)
        _, f_ref = _trust_constr(p, d["g"], d["A"], d["l"], d["u"])
        f = float(0.5 * z @ (p * z) + d["g"] @ z)
        rel = abs(f - f_ref) / (1.0 + abs(f_ref))
        _require(bool(st["qp_converged"]),
                 f"{name}: qp_err {float(st['qp_err']):.3g} missed tol")
        _require(bool(np.all(np.isfinite(z)))
                 and bool(np.all(np.isfinite(np.asarray(mu)))),
                 f"{name}: non-finite iterate")
        _require(rel <= QP_OBJ_RTOL,
                 f"{name}: objective {f:.12g} vs trust-constr "
                 f"{f_ref:.12g} (rel {rel:.3g} > {QP_OBJ_RTOL:g})")
        if name == "master_qp_warm_stall_lands":
            _require(abs(z[:4].sum() - 12.0) <= QP_ROW_ATOL,
                     f"{name}: capacity row sum {z[:4].sum():.9g} != 12")
        out[name] = {"qp_err": float(st["qp_err"]),
                     "obj_rel_err": rel, "warm_s": t_warm}
    return out


def phase_sd(name: str, iters: int, optimum: float, ub_max: float,
             ub_samples: int = 8192, seed: int = 0, chunk: int = 256,
             **cfg_kw) -> dict:
    """The reference's driver workload through SDSolver, then a stratified
    MC upper bound at the final incumbent."""
    from sqlp_tpu.models.instance import load_instance
    from sqlp_tpu.sd.driver import SDSolver

    cfg = _flagship_config(iters, **cfg_kw)
    inst = load_instance(name, dtype=cfg.jdtype)
    solver = SDSolver(inst, cfg, seed=seed)
    marks = []
    t0 = time.perf_counter()

    def progress(done, last):
        marks.append((done, time.perf_counter()))
        print(f"  {name}: {done}/{iters} iters, "
              f"{marks[-1][1] - t0:.1f}s, cand_est={last['cand_est']:.6g}",
              file=sys.stderr, flush=True)

    solver.run(iters, log_every=1, chunk=chunk, callback=progress)
    run_s = time.perf_counter() - t0
    # the first chunk compiles; later chunks reuse its executable
    warm = (marks[-1][1] - marks[0][1]) / (marks[-1][0] - marks[0][0]) \
        if len(marks) > 1 else float("nan")
    lb = solver.lower_estimate
    tail = float(np.mean([h["cand_est"] for h in solver.history[-100:]]))
    ub, hw, n = solver.evaluate_ci(min_samples=ub_samples,
                                   max_samples=ub_samples, seed=7,
                                   sampling="stratified")
    out = {"iters": iters, "S": cfg.max_scenarios,
           "D": cfg.max_dual_vertices, "K": cfg.max_cuts,
           "run_s": run_s, "warm_s_per_iter": warm,
           "lb_est": lb, "lb_est_mean_last100": tail,
           "mc_ub": ub, "mc_ub_half_width": hw, "mc_samples": n,
           "host_fallback_count": int(getattr(solver,
                                              "host_fallback_count", 0))}
    _require(all(np.isfinite(v) for v in (lb, tail, ub, hw)),
             f"{name}: non-finite result {out}")
    _require(ub + 3.0 * hw >= optimum,
             f"{name}: mc_ub {ub:.6g} + 3*{hw:.3g} below the optimum "
             f"{optimum:g}")
    _require(ub <= ub_max, f"{name}: mc_ub {ub:.6g} > {ub_max:g}")
    return out


def phase_cli(argv, optimum: float) -> dict:
    """``python -m sqlp_tpu <argv>`` in this process; parses the final
    ``lb_est=... mc_ub=...`` line."""
    from sqlp_tpu.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(list(argv))
    text = buf.getvalue()
    m = re.search(r"lb_est=(\S+) mc_ub=(\S+) \(95% \+- (\S+),", text)
    _require(rc == 0 and m is not None,
             f"cli rc={rc}, output:\n{text}")
    lb, ub, hw = (float(v) for v in m.groups())
    _require(lb < optimum + LANDS_SIDE and ub > optimum - LANDS_SIDE - hw
             and abs(lb - optimum) < LANDS_SPREAD
             and abs(ub - optimum) < LANDS_SPREAD,
             f"cli: lb_est {lb:.6g} / mc_ub {ub:.6g} +- {hw:.3g} do not "
             f"bracket {optimum:g} (side {LANDS_SIDE:g}, spread "
             f"{LANDS_SPREAD:g})")
    return {"lb_est": lb, "mc_ub": ub, "mc_ub_half_width": hw}


def solve_ef_host(arrays, model, deltas, probs) -> float:
    """Exact optimum of the sampled extensive form, by HiGHS in f64.

    min c'x + sum_s p_s q'y_s  s.t.  A1 x {senses1} b1,
    T_s x + W y_s {senses2} r_s,  bounds. The scenario data come from the
    subproblem RHS map h_s(x) = r_s - T_s x: r_s = h_s(0) and column j of
    T_s is h_s(0) - h_s(e_j), which covers RHS and transfer randomness.
    """
    import jax
    import jax.numpy as jnp
    import scipy.optimize
    import scipy.sparse as sp

    from sqlp_tpu.sd.algorithm import _scenario_rhs

    f64 = lambda v: np.asarray(v, np.float64)
    n1 = int(np.asarray(arrays.c).shape[0])
    N = int(deltas.shape[0])
    W, q = f64(arrays.W), f64(arrays.q)
    m2, n2 = W.shape
    a64 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64)
                       if jnp.issubdtype(jnp.asarray(v).dtype,
                                         jnp.floating) else v, arrays)
    m64 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64)
                       if jnp.issubdtype(jnp.asarray(v).dtype,
                                         jnp.floating) else v, model)
    d64 = jnp.asarray(deltas, jnp.float64)
    h = jax.vmap(lambda x: _scenario_rhs(a64, m64, d64, x))(
        jnp.concatenate([jnp.zeros((1, n1)), jnp.eye(n1)]))
    h = f64(h)                                          # [n1+1, N, m2]
    r = h[0]                                            # [N, m2]
    T = np.transpose(h[0][None] - h[1:], (1, 2, 0))     # [N, m2, n1]

    A1 = f64(arrays.A1).reshape(-1, n1)
    rows = [sp.hstack([sp.csr_matrix(A1), sp.csr_matrix((A1.shape[0],
                                                         N * n2))])]
    Wc = sp.csr_matrix(W)
    for s in range(N):
        rows.append(sp.hstack([
            sp.csr_matrix(T[s]), sp.csr_matrix((m2, s * n2)), Wc,
            sp.csr_matrix((m2, (N - 1 - s) * n2))]))
    A = sp.vstack(rows).tocsr()
    rhs = np.concatenate([f64(arrays.b1).ravel(), r.ravel()])
    sense = np.concatenate([np.asarray(arrays.senses1).ravel(),
                            np.tile(np.asarray(arrays.senses2), N)])
    ge, le, eq = sense == 1, sense == -1, sense == 0
    A_ub = sp.vstack([A[le], -A[ge]])
    b_ub = np.concatenate([rhs[le], -rhs[ge]])
    obj = np.concatenate([f64(arrays.c)] + [p * q for p in f64(probs)])
    lo = np.concatenate([f64(arrays.lb1)] + [f64(arrays.lb2)] * N)
    hi = np.concatenate([f64(arrays.ub1)] + [f64(arrays.ub2)] * N)
    res = scipy.optimize.linprog(
        obj, A_ub=A_ub, b_ub=b_ub,
        A_eq=A[eq] if eq.any() else None,
        b_eq=rhs[eq] if eq.any() else None,
        bounds=np.stack([np.where(np.isfinite(lo), lo, -np.inf),
                         np.where(np.isfinite(hi), hi, np.inf)], axis=1),
        method="highs")
    _require(res.status == 0, f"host EF failed: {res.message}")
    return float(res.fun)


def phase_certification(name: str, R: int, iters: int, fresh: int,
                        seed: int = 0, **cfg_kw) -> dict:
    """R batched replications, EF-route certificates over fresh stratified
    streams and the compromise decision; each certificate checked
    against its exact SAA optimum."""
    import jax.numpy as jnp

    from sqlp_tpu.models.instance import load_instance
    from sqlp_tpu.sd.compromise import compromise_decision
    from sqlp_tpu.sd.driver import SDReplications
    from sqlp_tpu.sd.lower_bound import _certification_streams

    cfg = _flagship_config(iters, **cfg_kw)
    inst = load_instance(name, dtype=cfg.jdtype)
    t0 = time.perf_counter()
    s = SDReplications(inst, cfg, n_replications=R, seed=seed)
    s.run(iters)
    sd_s = time.perf_counter() - t0
    cert_seed = 9000
    t0 = time.perf_counter()
    cert = s.certified_lower_bound(method="ef", fresh_scenarios=fresh,
                                   seed=cert_seed)
    cert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_comp, info = compromise_decision(inst, s.states, s.especs, rho=1.0,
                                       qp_config=cfg.qp,
                                       obj_scale=s.obj_scale)
    comp_s = time.perf_counter() - t0

    # the certificate bounds the SAA over exactly these streams, cast to
    # the instance dtype as saa_ef_bound casts them
    E = int(np.asarray(s.espec.obj_weight).shape[0])
    _require(E == 1, "the exact SAA reference handles one epigraph")
    deltas_h, _, _ = _certification_streams(
        s.states, inst.scenario_model, R, E, 0, 0, fresh, cert_seed,
        "stratified")
    lb = np.asarray(cert["lb_per_rep"], np.float64)
    below = []
    for r in range(R):
        d = np.asarray(jnp.asarray(deltas_h[r, 0], cfg.jdtype), np.float64)
        v = solve_ef_host(inst.arrays, inst.scenario_model, d,
                          np.full(fresh, 1.0 / fresh))
        _require(lb[r] <= v + CERT_RTOL * max(1.0, abs(v)),
                 f"replication {r}: certificate {lb[r]:.9g} exceeds the "
                 f"exact SAA optimum {v:.9g}")
        below.append(v - lb[r])
    infeas = float(np.max(cert["dual_infeas_per_rep"]))
    _require(infeas <= CERT_DUAL_INFEAS,
             f"dual_infeas_max {infeas:.3g} > {CERT_DUAL_INFEAS:g}")
    _require(bool(np.all(np.isfinite(np.asarray(x_comp)))),
             "non-finite compromise decision")
    return {"R": R, "iters": iters, "fresh_scenarios": fresh,
            "sd_s": sd_s, "cert_s": cert_s, "compromise_s": comp_s,
            "lb_per_rep": lb.tolist(), "saa_minus_lb": below,
            "lb_cert": float(cert["lb_cert"]),
            "dual_infeas_max": infeas}


def phase_mesh_trajectories(n_devices: int) -> dict:
    """lands f64, 12 iterations, on the meshes n_devices allows, against
    the single-device trajectory at atol 1e-8."""
    from sqlp_tpu.parallel.trajectory import check_sharded_trajectories
    lines = []
    labels = check_sharded_trajectories(n_devices, log=lines.append)
    for ln in lines:
        print(f"  {ln}", flush=True)
    return {"layouts": labels}


def phase_sharded_sd(name: str, n_devices: int, iters: int,
                     seed: int = 0, **cfg_kw) -> dict:
    """The flagship settings at full capacity (S=4096) in f64, scenario
    stores sharded over n_devices, against the single-device run of the
    same seed."""
    from sqlp_tpu.models.instance import load_instance
    from sqlp_tpu.sd.driver import SDSolver

    cfg = _flagship_config(**{"dtype": SHARD_DTYPE, **cfg_kw})
    inst = load_instance(name, dtype=cfg.jdtype)
    out = {"iters": iters, "S": cfg.max_scenarios, "dtype": cfg.dtype}
    runs = {}
    for label, mesh in (("single", 0), ("sharded", n_devices)):
        solver = SDSolver(inst, cfg, seed=seed, mesh_devices=mesh)
        t0 = time.perf_counter()
        solver.run(iters)
        out[f"{label}_s"] = time.perf_counter() - t0
        runs[label] = (solver.lower_estimate, int(solver.state.n_duals))
    (e1, d1), (e4, d4) = runs["single"], runs["sharded"]
    out.update(cand_est_single=e1, cand_est_sharded=e4,
               n_duals_single=d1, n_duals_sharded=d4)
    _require(np.isfinite(e4) and abs(e4 - e1) <= SHARD_EST_RTOL * abs(e1),
             f"cand_est sharded {e4:.6g} vs single {e1:.6g}")
    _require(abs(d4 - d1) <= SHARD_DUALS_RTOL * d1,
             f"n_duals sharded {d4} vs single {d1}")
    return out


# --- driver ------------------------------------------------------------

def _card_line() -> str:
    """nvidia-smi's name and power limit, read in a child that does not
    import JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _fmt(v):
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k}={_fmt(x)}" for k, x in v.items()) + "}"
    return str(v)


def _run_phase(name: str, fn, *args, **kw) -> dict:
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    dt = time.perf_counter() - t0
    print(f"phase {name}: ok in {dt:.1f}s " + " ".join(
        f"{k}={_fmt(v)}" for k, v in out.items()), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded path and its single-card "
                        "comparison, on four GPUs")
    args = p.parse_args(argv)

    from sqlp_tpu.utils.jaxsetup import configure_jax
    configure_jax()
    import jax

    devs = jax.devices()
    need = 4 if args.four_cards else 1
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"chip_smoke.py needs {need} GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 1
    print(f"device: {devs[0].platform} {devs[0].device_kind} "
          f"x{len(devs)}", flush=True)
    print(f"card: {_card_line()}", flush=True)

    if args.four_cards:
        _run_phase("mesh_trajectories", phase_mesh_trajectories, 4)
        _run_phase("sharded_ssn", phase_sharded_sd, "ssn", 4, 200)
    else:
        # B=2 is the size of the SD step's own panel (candidate and
        # incumbent), solved thousands of times per run
        for name, B in (("ssn", 4096), ("ssn", 2), ("storm", 256)):
            _run_phase(f"lp_panel[{name},B={B}]", phase_lp_panel, name, B)
        _run_phase("master_qp", phase_master_qp)
        _run_phase("sd_cli", phase_cli,
                   ["solve", "lands", "--iters", "1000", "--x0", "crash",
                    "--eval-every", "500"], optimum=LANDS_OPT)
        _run_phase("certification", phase_certification, "ssn", 2, 500,
                   fresh=128)
        _run_phase("sd_flagship", phase_sd, "ssn", 3000,
                   optimum=SSN_OPT, ub_max=SSN_UB_MAX)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
