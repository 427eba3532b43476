"""The SD iteration: one jitted, pure step function.

Port of record: ``sd_iteration!`` (src/sd_algorithm/algorithm.jl:39-115),
the 8-step loop documented at algorithm.jl:3-18:

  1. add new scenarios to each epigraph           -> scenario store append
  2. solve subproblems at the candidate           -> one batched PDHG call
  3. ... and at the incumbent; collect duals      ->   (both points at once)
  4. prune near-zero-dual cuts if master solved   -> live-mask update
  5. build SASA cut per epigraph at the candidate -> argmax matmul + insert
  6. refresh incumbent cut at the incumbent       -> replace [E] slots
  7. incumbent selection                          -> branchless compare
  8. regularized master solve -> new candidate    -> on-device ADMM QP

Where the reference crosses a process boundary twice per epigraph per
iteration (JuMP -> CPLEX and back), this step stays on device end to end;
the only host interaction is the driver reading back scalars for logging.
"""

from __future__ import annotations

import dataclasses as _dc
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from sqlp_tpu.config import SDConfig
from sqlp_tpu.models.instance import InstanceArrays
from sqlp_tpu.models.scenario import (ScenarioModel, effective_rhs_deltas,
                                      sample_deltas, sample_values,
                                      scenario_log_pdf)
from sqlp_tpu.ops.pdhg import PreparedLP, solve_batch
from sqlp_tpu.ops.prox_qp import solve_qp
from sqlp_tpu.sd.cuts import Cut, build_sasa_cut, evaluate_multi_epigraph
from sqlp_tpu.sd.dual_pool import push_duals
from sqlp_tpu.sd.master import assemble_master, cut_dual_slice
from sqlp_tpu.sd.state import EpigraphSpec, SDState

_PREC = jax.lax.Precision.HIGHEST


def _scenario_rhs(arrays: InstanceArrays, model: ScenarioModel,
                  deltas: jax.Array, x: jax.Array) -> jax.Array:
    """h = r - T x + scatter(effective deltas): the subproblem RHS panel.

    deltas: [P, R] raw scenario deltas -> returns [P, m2].
    """
    dt = arrays.r.dtype
    x = x.astype(dt)
    deltas = deltas.astype(dt)
    eff = effective_rhs_deltas(model, deltas, x)
    m2 = arrays.r.shape[0]
    dense = jnp.zeros(deltas.shape[:-1] + (m2,), dt)
    dense = dense.at[..., model.rv_row].add(eff)
    base = arrays.r - jnp.matmul(arrays.T, x, precision=_PREC)
    return base + dense


def _quad_scalar_schedule(state: SDState, config: SDConfig):
    """Branchless prox-weight schedules (src/sd_algorithm/quad_scalar.jl).

    Returns (rho_for_this_master_solve, new_quad_scalar, new_normDk_1,
    new_normDk_init). Called AFTER incumbent selection and BEFORE the
    incumbent is replaced, like the reference (algorithm.jl:92-94).
    """
    if config.quad_schedule == "constant":
        rho = jnp.asarray(config.quad_scalar_init, state.quad_scalar.dtype)
        return rho, state.quad_scalar, state.normDk_1, state.normDk_init

    assert config.quad_schedule == "adaptive", config.quad_schedule
    diff = state.x_incumbent - state.x_candidate
    normDk = jnp.sum(diff * diff)
    tol = config.quad_tolerance
    # Uninitialized register + no movement: early-return the old value
    # without touching normDk_1 (quad_scalar.jl:30-44).
    early = jnp.logical_and(~state.normDk_init, normDk <= tol)
    normDk_1_eff = jnp.where(state.normDk_init, state.normDk_1, normDk)
    qs = state.quad_scalar
    shrink = jnp.logical_and(
        state.is_improved,
        jnp.logical_and(normDk > tol, normDk >= config.quad_r3 * normDk_1_eff))
    qs = jnp.where(
        shrink,
        qs * (config.quad_r2 * config.quad_r3 * normDk_1_eff
              / jnp.maximum(normDk, 1e-30)),
        qs)
    qs = jnp.where(~state.is_improved, qs / config.quad_r2, qs)
    qs = jnp.clip(qs, config.quad_min, config.quad_max)
    new_qs = jnp.where(early, state.quad_scalar, qs)
    new_normDk_1 = jnp.where(early, state.normDk_1, normDk)
    new_init = jnp.logical_or(state.normDk_init, normDk > tol)
    return new_qs, new_qs, new_normDk_1, new_init


def _refresh_cuts(arrays: InstanceArrays, model: ScenarioModel,
                  state: SDState, scan_k: bool = False) -> SDState:
    """Rebuild every live stored cut at its generating point against the
    CURRENT dual pool and scenario store, full weight (config
    .cut_refresh_every). A refreshed cut is an ordinary SASA cut at the
    stored x, so validity is untouched; the weight_mark reset removes
    the accumulated 1/N decay (the reference regenerates only the
    incumbent cut this way, epigraph.jl:83).

    ``scan_k``: iterate the K cut slots with ``lax.scan`` instead of
    ``vmap``. The vmapped rebuild unrolls E*K cut builds into one graph
    — vmapped again over R replications at flagship sizes (K=96, R=8)
    it made a very large program for XLA to compile — while the scan
    keeps ONE build in the graph (still vmapped over E and R, so the
    matmuls stay batched) at a K-fold smaller program. Single runs keep
    the fused vmap (one batched sweep).
    """
    live = state.cut_live

    if scan_k:
        def per_epi(sd, sw, tw, X):
            def body(carry, x):
                return carry, build_sasa_cut(
                    arrays, model, state.duals, state.n_duals, sd, sw,
                    tw, x)
            return jax.lax.scan(body, None, X)[1]
    else:
        def per_epi(sd, sw, tw, X):
            return jax.vmap(lambda x: build_sasa_cut(
                arrays, model, state.duals, state.n_duals, sd, sw, tw,
                x))(X)

    cuts = jax.vmap(per_epi)(state.scen_deltas, state.scen_weights,
                             state.total_weight, state.cut_x)
    return _dc.replace(
        state,
        cut_alpha=jnp.where(live, cuts.alpha, state.cut_alpha),
        cut_beta=jnp.where(live[..., None], cuts.beta, state.cut_beta),
        cut_mark=jnp.where(live, state.total_weight[:, None],
                           state.cut_mark))


def _maybe_refresh(arrays, model, state, config, it_scalar):
    """lax.cond gate for the periodic refresh (it_scalar: this step's
    pre-increment iteration counter, shared across replications)."""
    do = jnp.logical_and(
        it_scalar > 0, it_scalar % config.cut_refresh_every == 0)
    return jax.lax.cond(
        do, lambda s: _refresh_cuts(arrays, model, s), lambda s: s, state)


def _sample_and_rhs(arrays: InstanceArrays, model: ScenarioModel,
                    espec: EpigraphSpec, state: SDState, config: SDConfig,
                    deltas: jax.Array | None,
                    weights: jax.Array | None,
                    proposal: ScenarioModel | None):
    """Steps 1-2a of the SD iteration: sample/append scenarios and build
    the [2EB, m2] subproblem RHS panel plus the pool dual warm start.

    Returns (key', store, H, L0, Q) where ``store`` carries the updated
    scenario-store fields and ``Q`` is the per-element [2EB, n2] cost
    panel on random-cost instances (None otherwise). Split out of sd_step
    so the replicated step can vmap this phase while flattening the LP
    solves (see sd_step_replicated).
    """
    E = espec.n_epi
    B = config.scenarios_per_iter
    S = config.max_scenarios
    m2 = arrays.r.shape[0]
    dt = arrays.c.dtype

    key, k_sample = jax.random.split(state.key)

    # ---- 1. sample + append scenarios (add_scenario!, epigraph.jl:81-96)
    if deltas is not None:
        assert deltas.shape[:2] == (E, B), (
            f"user scenarios must be [n_epi={E}, B={B}, R], got "
            f"{deltas.shape} (B is config.scenarios_per_iter)")
        new_deltas = deltas.astype(dt)
    elif proposal is not None:
        vals = sample_values(k_sample, proposal, E * B,
                             method=config.sampling)
        logw = scenario_log_pdf(model, vals) - scenario_log_pdf(proposal,
                                                                vals)
        new_deltas = (vals - model.base).astype(dt).reshape(
            E, B, model.n_rv)
        assert weights is None, "proposal computes its own weights"
        weights = jnp.exp(logw).astype(dt).reshape(E, B)
    else:
        new_deltas = sample_deltas(k_sample, model, E * B,
                                   method=config.sampling
                                   ).reshape(E, B, model.n_rv)
    if weights is None:
        new_w = jnp.ones((E, B), dt)
    else:
        assert weights.shape == (E, B), (weights.shape, (E, B))
        new_w = weights.astype(dt)

    # Pre-saturation: append in stream order (matches the reference, whose
    # store is unbounded). At capacity: reservoir sampling (Vitter's R) —
    # scenario number t replaces a uniform slot with prob S/t — so the
    # stored panel stays a uniform i.i.d. subsample of the full stream,
    # which is what build_sasa_cut's sample-average rationale assumes
    # (ADVICE r1: overwriting a fixed trailing slot froze the estimator
    # past capacity). Weighted streams keep UNIFORM inclusion and store
    # the weight alongside: the panel is then a uniform subsample of the
    # weighted stream and the stored-weight-normalized sample average in
    # build_sasa_cut stays a consistent (ratio) estimator — inclusion
    # proportional to weight would double-count the weights.
    res_keys = jax.random.split(jax.random.fold_in(k_sample, 0x5eed), E)

    def append_one(rkey, store, weights_, n, n_str, new, w_new):
        for i in range(B):
            ku, kj = jax.random.split(jax.random.fold_in(rkey, i))
            t = (n_str + (i + 1)).astype(dt)            # stream position
            j = jax.random.randint(kj, (), 0, S)
            pre = n + i < S
            take = jax.random.uniform(ku, dtype=dt) * t < S
            idx = jnp.where(pre, jnp.minimum(n + i, S - 1), j)
            write = jnp.logical_or(pre, take)
            store = store.at[idx].set(
                jnp.where(write, new[i], store[idx]))
            weights_ = weights_.at[idx].set(
                jnp.where(write, w_new[i], weights_[idx]))
        return store, weights_, jnp.minimum(n + B, S)

    scen_deltas, scen_weights, n_scen = jax.vmap(append_one)(
        res_keys, state.scen_deltas, state.scen_weights, state.n_scen,
        state.n_stream, new_deltas, new_w)
    overflow = jnp.sum(jnp.maximum(state.n_scen + B - S, 0)).astype(
        state.scen_dropped.dtype)
    total_weight = state.total_weight + jnp.sum(new_w, axis=1)
    n_stream = state.n_stream + B

    # ---- 2+3. batched subproblem solves at candidate AND incumbent
    flat_deltas = new_deltas.reshape(E * B, model.n_rv)
    h_cand = _scenario_rhs(arrays, model, flat_deltas, state.x_candidate)
    h_inc = _scenario_rhs(arrays, model, flat_deltas, state.x_incumbent)
    # Order [E, (cand, inc), B] so pool pushes match the reference's
    # per-epigraph cand-then-inc sequence (algorithm.jl:49-54).
    H = jnp.stack([h_cand.reshape(E, B, m2), h_inc.reshape(E, B, m2)],
                  axis=1).reshape(2 * E * B, m2)
    if model.has_cost:
        # per-scenario objective q_s (reference TODO 6); same scenarios at
        # both evaluation points, tiled in the H panel's order
        from sqlp_tpu.models.scenario import cost_panel
        n2 = arrays.q.shape[0]
        Qc = cost_panel(model, flat_deltas, arrays.q).reshape(E, B, n2)
        Q = jnp.stack([Qc, Qc], axis=1).reshape(2 * E * B, n2)
    else:
        Q = None
    if config.pool_dual_warm_start:
        # dual warm start from the pool: the argmax vertex for each RHS
        # (same [D, m2] x [m2, P] shape family as the cut-build scoring,
        # so the matmul is noise next to the PDHG iterations it saves).
        # Scores are quantized before the argmax: any vertex within 1e-4
        # (relative) of the best is an equally good warm start, and the
        # floor makes the pick invariant to matmul tiling — mesh-sharded
        # and single-device runs otherwise flip near-ties and bitwise
        # trajectory equality (tests/test_parallel.py) breaks.
        D = config.max_dual_vertices
        live = jnp.arange(D)[:, None] < state.n_duals
        scores = jnp.where(live, jnp.matmul(state.duals, H.T,
                                            precision=_PREC), -jnp.inf)
        quantum = 1e-4 * (1.0 + jnp.abs(jnp.max(scores, axis=0)))
        L0_pool = state.duals[jnp.argmax(jnp.floor(scores / quantum),
                                         axis=0)]
        L0 = jnp.where(state.n_duals > 0, L0_pool, state.sub_warm_L)
    else:
        L0 = state.sub_warm_L

    store = dict(scen_deltas=scen_deltas, scen_weights=scen_weights,
                 n_scen=n_scen, n_stream=n_stream,
                 total_weight=total_weight, overflow=overflow)
    return key, store, H, L0, Q


def _sharpen_flat(arrays: InstanceArrays, H: jax.Array, sub_Y: jax.Array,
                  Pi: jax.Array, live_el: jax.Array | None):
    """Crossover on a flat element batch with an optional per-element live
    mask (no lax.cond: callers whose elements disagree on the dry gate —
    the replicated step — mask instead of branching)."""
    from sqlp_tpu.ops.crossover import sharpen_duals

    Pi_sharp, accept = sharpen_duals(
        arrays.W, arrays.q, arrays.senses2, arrays.lb2, arrays.ub2,
        H, sub_Y, Pi)
    if live_el is not None:
        Pi_sharp = jnp.where(live_el[:, None], Pi_sharp, Pi)
        accept = jnp.logical_and(accept, live_el)
    return Pi_sharp, accept


def _finish(arrays: InstanceArrays, model: ScenarioModel,
            espec: EpigraphSpec, state: SDState, config: SDConfig,
            key: jax.Array, store: dict,
            sub_obj: jax.Array, sub_Y: jax.Array, Pi: jax.Array,
            Pi_sharp: jax.Array, pdhg_valid: jax.Array,
            xover_dry: jax.Array, crossover_accepted: jax.Array,
            qp_config=None) -> Tuple[SDState, dict]:
    """Steps 3-8 of the SD iteration: dual-pool push, cut prune/build,
    incumbent selection, schedule, master solve. Pure per-replication
    arithmetic — the replicated step vmaps this phase (with a
    ``qp_config`` override that drops vmap-hostile master branches)."""
    if qp_config is None:
        qp_config = config.qp
    E = espec.n_epi
    B = config.scenarios_per_iter
    S = config.max_scenarios
    K = config.max_cuts
    n1 = arrays.c.shape[0]
    m1 = arrays.b1.shape[0]
    scen_deltas = store["scen_deltas"]
    scen_weights = store["scen_weights"]
    n_scen = store["n_scen"]
    n_stream = store["n_stream"]
    total_weight = store["total_weight"]
    overflow = store["overflow"]
    sub_stats = {"crossover_accepted": crossover_accepted}

    duals, duals_rounded, n_duals, duals_dropped, duals_score = push_duals(
        state.duals, state.duals_rounded, state.n_duals, Pi_sharp,
        state.duals_dropped, config.dual_sig_bits,
        valid=pdhg_valid, score=state.duals_score)

    # ---- 4. prune near-zero-dual cuts (algorithm.jl:57-69). The
    # reference's threshold is absolute (1e-3 on exact CPLEX duals); ours
    # is max(absolute, relative-to-largest-multiplier) so it stays
    # meaningful under objective normalization and f32 dual noise.
    mu_scale = jnp.max(jnp.where(state.cut_live,
                                 jnp.abs(state.cut_dual), 0.0),
                       initial=0.0)
    prune_tol = jnp.maximum(config.cut_remove_tolerance, 1e-3 * mu_scale)
    prune = jnp.logical_and(
        state.master_solved,
        jnp.abs(state.cut_dual) < prune_tol)
    cut_live = jnp.logical_and(state.cut_live, ~prune)

    # state with scenarios appended + cuts pruned, before new cuts: this is
    # the f_{k-1} snapshot (algorithm.jl:74-76).
    state_last = _dc.replace(
        state, scen_deltas=scen_deltas, scen_weights=scen_weights,
        n_scen=n_scen, n_stream=n_stream, total_weight=total_weight,
        cut_live=cut_live,
        duals=duals, duals_rounded=duals_rounded, n_duals=n_duals)
    last_cand_eval = evaluate_multi_epigraph(state_last, espec,
                                             state.x_candidate)
    last_inc_eval = evaluate_multi_epigraph(state_last, espec,
                                            state.x_incumbent)

    # ---- 5. SASA cuts at the candidate, one per epigraph (epigraph.jl:125)
    def build_at(x):
        return jax.vmap(
            lambda sd, sw, tw: build_sasa_cut(
                arrays, model, duals, n_duals, sd, sw, tw, x,
                with_counts=True)
        )(scen_deltas, scen_weights, total_weight)

    if config.update_incumbent_cut:
        # one fused argmax pass over both evaluation points: the candidate
        # and incumbent builds share the [D,R]x[R,S] score matmul shape, so
        # batching them roughly halves the per-iteration cut-build cost
        # (the argmax is the fixed-cost floor on small instances)
        cuts2, counts2 = jax.vmap(build_at)(
            jnp.stack([state.x_candidate, state.x_incumbent]))
        cand_cut = Cut(cuts2.alpha[0], cuts2.beta[0])
        argmax_counts = jnp.sum(counts2, axis=(0, 1))       # [D]
    else:
        cand_cut, cand_counts = build_at(state.x_candidate)
        argmax_counts = jnp.sum(cand_counts, axis=0)        # [D]

    # insert: first dead slot, else evict the smallest-|dual| live cut
    slot_score = jnp.where(cut_live, jnp.abs(state.cut_dual), -jnp.inf)
    slots = jnp.argmin(slot_score, axis=1)                  # [E]
    e_idx = jnp.arange(E)
    cut_alpha = state.cut_alpha.at[e_idx, slots].set(cand_cut.alpha)
    cut_beta = state.cut_beta.at[e_idx, slots].set(cand_cut.beta)
    cut_mark = state.cut_mark.at[e_idx, slots].set(total_weight)
    cut_dual = state.cut_dual.at[e_idx, slots].set(jnp.inf)
    cut_live = cut_live.at[e_idx, slots].set(True)
    cut_x = state.cut_x.at[e_idx, slots].set(
        jnp.broadcast_to(state.x_candidate,
                         (E,) + state.x_candidate.shape))

    # ---- 6. refresh incumbent cut (epigraph.jl:83; algorithm.jl:82-84)
    if config.update_incumbent_cut:
        inc_alpha, inc_beta = cuts2.alpha[1], cuts2.beta[1]
        inc_valid = jnp.ones((E,), bool)
    else:
        inc_alpha, inc_beta = state.inc_alpha, state.inc_beta
        inc_valid = state.inc_valid
    duals_score = config.dual_score_decay * duals_score + argmax_counts

    state_now = _dc.replace(
        state_last, cut_alpha=cut_alpha, cut_beta=cut_beta,
        cut_mark=cut_mark, cut_dual=cut_dual, cut_live=cut_live,
        cut_x=cut_x,
        inc_alpha=inc_alpha, inc_beta=inc_beta, inc_valid=inc_valid)

    # ---- 7. incumbent selection (check_improvement, improvement.jl:19-49)
    f_cand = jnp.matmul(arrays.c, state.x_candidate, precision=_PREC)
    f_inc = jnp.matmul(arrays.c, state.x_incumbent, precision=_PREC)
    cand_est = evaluate_multi_epigraph(state_now, espec, state.x_candidate) + f_cand
    inc_est = evaluate_multi_epigraph(state_now, espec, state.x_incumbent) + f_inc
    last_cand_est = last_cand_eval + f_cand
    last_inc_est = last_inc_eval + f_inc
    req = config.incumbent_q * (last_cand_est - last_inc_est)
    is_improved = cand_est < inc_est + req
    # Defense in depth: never promote a first-stage-INFEASIBLE candidate to
    # incumbent. The candidate is repaired to row feasibility after every
    # master solve (below), but a master that exits far from optimality can
    # in principle leave residual violation; an infeasible incumbent has a
    # spuriously low model value (it sits outside the cut-supported region),
    # wins the improvement test, and then sticks forever while the MC
    # evaluator's recourse LPs at it come back infeasible. The reference
    # crashes outright on a failed master (algorithm.jl:104-110); we keep
    # the previous incumbent and let SD continue from the repaired point.
    Ax_c = jnp.matmul(arrays.A1, state.x_candidate, precision=_PREC)
    res_c = Ax_c - arrays.b1
    viol_c = jnp.where(
        arrays.senses1 == 1, jnp.maximum(-res_c, 0.0),
        jnp.where(arrays.senses1 == -1, jnp.maximum(res_c, 0.0),
                  jnp.abs(res_c)))
    cand_feasible = jnp.all(viol_c <= 1e-4 * (1.0 + jnp.abs(arrays.b1)))
    is_improved = jnp.logical_and(is_improved, cand_feasible)

    state_now = _dc.replace(state_now, is_improved=is_improved,
                            cand_est=cand_est, inc_est=inc_est,
                            req_improvement=req)

    # ---- schedule BEFORE incumbent replacement (algorithm.jl:92-94)
    rho, quad_scalar, normDk_1, normDk_init = _quad_scalar_schedule(
        state_now, config)

    x_incumbent = jnp.where(is_improved, state.x_candidate, state.x_incumbent)
    state_now = _dc.replace(state_now, x_incumbent=x_incumbent,
                            quad_scalar=quad_scalar, normDk_1=normDk_1,
                            normDk_init=normDk_init)

    # ---- 8. regularized master solve (algorithm.jl:101-112)
    p_diag, g, A, l, u, is_eq = assemble_master(arrays, espec, state_now, rho)
    z, mu, qp_stats = solve_qp(p_diag, g, A, l, u, is_eq, qp_config,
                               z0=state.master_z, mu0=state.master_mu,
                               rho_init=state.master_rho)
    # ADMM converges in a relative sense; clip residual bound violations so
    # the candidate is always box-feasible (a slightly-negative component
    # made storm's recourse infeasible and poisoned the dual pool), then
    # repair residual general-row violations by a few relaxed hyperplane
    # -projection sweeps: a candidate short of a stage-1 row by ~1e-6
    # (the master's stall-exit tolerance on lands' capacity row) has an
    # INFEASIBLE second stage at exact-oracle tolerances. Violations are
    # already tiny, so the O(violation) move is objective-neutral and a
    # handful of sweeps reaches oracle feasibility.
    x_candidate = jnp.clip(z[:n1], arrays.lb1, arrays.ub1)
    rownorm2 = jnp.maximum(jnp.sum(arrays.A1 * arrays.A1, axis=1), 1e-30)

    def _row_viol(x):
        resid = jnp.matmul(arrays.A1, x, precision=_PREC) - arrays.b1
        return jnp.where(
            arrays.senses1 == 1, jnp.minimum(resid, 0.0),        # '>='
            jnp.where(arrays.senses1 == -1,
                      jnp.maximum(resid, 0.0), resid))           # '<=' / '=='

    def _repair_sweep(_, x):
        x = x - jnp.matmul(arrays.A1.T, _row_viol(x) / rownorm2,
                           precision=_PREC)
        return jnp.clip(x, arrays.lb1, arrays.ub1)

    x_candidate = jax.lax.fori_loop(0, 4, _repair_sweep, x_candidate)

    # Failure regime only: a master that exits far from optimality can
    # leave whole-unit row violations that 4 sweeps cannot close (they are
    # sized for ~1e-6 stall-exit residuals), and every downstream consumer
    # — recourse solves, cut validity, the MC evaluator — assumes a
    # stage-1-feasible candidate. The extra loop is entered only when the
    # post-sweep violation exceeds a threshold orders of magnitude above
    # fp noise, so healthy iterations stay BITWISE identical to the fixed
    # 4-sweep path (the sharded-vs-single trajectory tests pin that), while
    # broken ones are projected to feasibility.
    feas_big = 1e-6 * (1.0 + jnp.abs(arrays.b1))

    def _repair_cond(carry):
        it, x = carry
        return jnp.logical_and(it < 60,
                               jnp.any(jnp.abs(_row_viol(x)) > feas_big))

    _, x_candidate = jax.lax.while_loop(
        _repair_cond, lambda c: (c[0] + 1, _repair_sweep(0, c[1])),
        (jnp.zeros((), jnp.int32), x_candidate))
    cut_dual = cut_dual_slice(mu, m1, n1, E, K)

    new_state = _dc.replace(
        state_now,
        key=key,
        it=state.it + 1,
        x_candidate=x_candidate,
        xover_dry=xover_dry,
        cut_dual=cut_dual,
        master_solved=qp_stats["qp_converged"],
        master_z=z,
        master_mu=mu,
        master_rho=qp_stats["qp_rho"],
        scen_dropped=state.scen_dropped + overflow,
        duals_dropped=duals_dropped,
        duals_score=duals_score,
        sub_warm_Y=sub_Y,
        sub_warm_L=Pi,
    )

    stats = {
        "it": new_state.it,
        "cand_est": cand_est,
        "inc_est": inc_est,
        "is_improved": is_improved,
        "rho": rho,
        "n_duals": n_duals,
        "n_cuts_live": jnp.sum(cut_live),
        "sub_obj_mean": jnp.mean(sub_obj),
        "x_candidate": x_candidate,
        **sub_stats,
        **qp_stats,
    }
    return new_state, stats


@partial(jax.jit, static_argnames=("config",))
def sd_step(arrays: InstanceArrays, model: ScenarioModel, espec: EpigraphSpec,
            prep_sub: PreparedLP, state: SDState, config: SDConfig,
            deltas: jax.Array | None = None,
            weights: jax.Array | None = None,
            proposal: ScenarioModel | None = None) -> Tuple[SDState, dict]:
    """One SD iteration. Pure: (state, key) -> (state', stats).

    ``deltas`` ([E, B, R], optional) supplies the iteration's scenarios
    externally instead of sampling from the scenario model — the
    reference's driver-supplied ``scenario_list`` surface
    (``sd_iteration!(cell, scenario_list)``, algorithm.jl:39-45).
    ``weights`` ([E, B], optional, default 1) is the per-scenario weight of
    ``add_scenario!(epi, scenario, weight)`` (epigraph.jl:81-96) — the
    importance-sampling hook the reference documents in its TODO list
    (readme.md items 5/8). All downstream cut math (probability
    normalization, weight_mark discounting) already carries weights.

    ``proposal`` (optional ScenarioModel over the same positions) runs
    importance sampling fully inside the jitted step: scenarios draw from
    the proposal, weights are the exact density ratios
    p_model / p_proposal — no per-iteration host round trip, so IS runs
    at full chunked speed. Mutually exclusive with explicit deltas.
    """
    if config.cut_refresh_every > 0:
        state = _maybe_refresh(arrays, model, state, config, state.it)

    key, store, H, L0, Q = _sample_and_rhs(arrays, model, espec, state,
                                           config, deltas, weights, proposal)

    # ---- 2+3. batched subproblem solves at candidate AND incumbent
    sub_obj, sub_Y, Pi, sub_stats = solve_batch(
        prep_sub, H, config.pdhg, Y0=state.sub_warm_Y, L0=L0, Q=Q)

    if config.dual_crossover and not model.has_cost:
        # round interior-ish first-order duals to basic vertices (cut
        # sharpness parity with the reference's simplex duals); rejected
        # elements keep their PDHG dual. Adaptive gate: once the
        # acceptance test has rejected every dual for crossover_dry_limit
        # consecutive iterations, lax.cond skips the batched [m2, m2]
        # active-set solves entirely (a large share of the storm step,
        # where f32 never passes the 1e-6 dual-feasibility acceptance; accepted
        # iterations reset the counter so lands/ssn keep their gains).
        def _run_xover(_):
            return _sharpen_flat(arrays, H, sub_Y, Pi, None)

        def _run_xover_f64(_):
            # f64 rounding for panels whose f32 acceptance is
            # floored (storm: dual-feasibility residuals stall ~1e-5
            # against the 1e-6 acceptance; f64 has no such floor). The
            # SD panel is tiny (2EB elements), so the f64 [m2, m2]
            # factorizations are a fixed per-iteration cost — gated
            # behind config.crossover_f64_fallback after the A/B.
            from sqlp_tpu.ops.crossover import sharpen_duals
            f8 = jnp.float64
            Pi64, accept = sharpen_duals(
                arrays.W.astype(f8), arrays.q.astype(f8), arrays.senses2,
                arrays.lb2.astype(f8), arrays.ub2.astype(f8),
                H.astype(f8), sub_Y.astype(f8), Pi.astype(f8))
            return Pi64.astype(Pi.dtype), accept

        def _skip_xover(_):
            return Pi, jnp.zeros((Pi.shape[0],), bool)

        if config.crossover_dry_limit > 0:
            live = state.xover_dry < config.crossover_dry_limit
            dry_branch = (_run_xover_f64 if config.crossover_f64_fallback
                          else _skip_xover)
            Pi_sharp, xover = jax.lax.cond(live, _run_xover, dry_branch,
                                           None)
        else:
            live = jnp.asarray(True)
            Pi_sharp, xover = _run_xover(None)
        n_acc = jnp.sum(xover)
        # With the f64 fallback, acceptances on the DRY branch must not
        # reset the counter — that would bounce the next iteration back
        # to the floored f32 path and fire f64 only once per dry cycle.
        reset = jnp.logical_and(live, n_acc > 0) \
            if config.crossover_f64_fallback else (n_acc > 0)
        xover_dry = jnp.where(reset, 0, state.xover_dry + 1)
    else:
        Pi_sharp = Pi
        xover_dry = state.xover_dry
        n_acc = jnp.zeros((), jnp.int32)

    new_state, stats = _finish(arrays, model, espec, state, config,
                               key, store, sub_obj, sub_Y, Pi, Pi_sharp,
                               sub_stats["pdhg_valid"], xover_dry, n_acc)
    stats.update(sub_stats)
    return new_state, stats


@partial(jax.jit, static_argnames=("config",))
def sd_step_replicated(arrays: InstanceArrays, model: ScenarioModel,
                       espec: EpigraphSpec, prep_sub: PreparedLP,
                       states: SDState, config: SDConfig,
                       proposal: ScenarioModel | None = None
                       ) -> Tuple[SDState, dict]:
    """One SD iteration on R stacked replications.

    ``states`` carries a leading replication axis R on every leaf.
    A naive ``jax.vmap(sd_step)`` runs about R times slower per
    iteration than a single run: the PDHG while_loop rounds under vmap
    degrade to per-replication serial work. Here only the cheap
    arithmetic phases are vmapped; the LP solves flatten the replication
    axis into ONE [R*2EB]-row solve_batch call (one while_loop, one
    compaction ladder, one wide matmul per operator application) and the
    crossover masks its per-replication dry gate instead
    of branching. Same per-replication semantics; stats are [R]-shaped,
    with panel-global PDHG scalars (rounds/err/converged) broadcast —
    the solve is shared, so they are genuinely global.
    """
    R = states.cut_alpha.shape[0]
    m2 = arrays.r.shape[0]

    if config.cut_refresh_every > 0:
        # replications run in lockstep, so the gate is uniform: cond on
        # replication 0's counter, refresh all under vmap when it fires
        do = jnp.logical_and(
            states.it[0] > 0,
            states.it[0] % config.cut_refresh_every == 0)
        states = jax.lax.cond(
            do,
            lambda ss: jax.vmap(
                lambda s: _refresh_cuts(arrays, model, s, scan_k=True)
            )(ss),
            lambda ss: ss, states)

    key, store, H, L0, Q = jax.vmap(
        lambda st: _sample_and_rhs(arrays, model, espec, st, config,
                                   None, None, proposal))(states)
    P = H.shape[1]                                      # 2*E*B per rep
    H_flat = H.reshape(R * P, m2)
    sub_obj, sub_Y, Pi, sub_stats = solve_batch(
        prep_sub, H_flat, config.pdhg,
        Y0=states.sub_warm_Y.reshape(R * P, -1),
        L0=L0.reshape(R * P, m2),
        Q=None if Q is None else Q.reshape(R * P, -1))

    if config.dual_crossover and not model.has_cost:
        if config.crossover_dry_limit > 0:
            live = states.xover_dry < config.crossover_dry_limit   # [R]
            live_el = jnp.repeat(live, P)
            # skip the batched active-set solves entirely only when EVERY
            # replication's gate is dry (replications disagreeing is the
            # common case, handled by the per-element mask)
            Pi_sharp, accept = jax.lax.cond(
                jnp.any(live),
                lambda _: _sharpen_flat(arrays, H_flat, sub_Y, Pi, live_el),
                lambda _: (Pi, jnp.zeros((Pi.shape[0],), bool)),
                None)
        else:
            Pi_sharp, accept = _sharpen_flat(arrays, H_flat, sub_Y, Pi,
                                             None)
        n_acc = jnp.sum(accept.reshape(R, P), axis=1)              # [R]
        xover_dry = jnp.where(n_acc > 0, 0, states.xover_dry + 1)
    else:
        Pi_sharp = Pi
        xover_dry = states.xover_dry
        n_acc = jnp.zeros((R,), jnp.int32)

    # the master drops its cold-retry fallback under vmap: lax.cond lowers
    # to a select there, so every replication would pay the full second
    # ADMM loop on every master solve; the stall caps + sd_step's
    # feasibility guard/repairs remain
    qp_cfg = _dc.replace(config.qp, warm_retry=False)
    new_states, stats = jax.vmap(
        lambda st, k, sto, so, sy, pi, ps, pv, xd, na: _finish(
            arrays, model, espec, st, config, k, sto, so, sy, pi, ps,
            pv, xd, na, qp_config=qp_cfg)
    )(states, key, store, sub_obj.reshape(R, P),
      sub_Y.reshape(R, P, -1), Pi.reshape(R, P, m2),
      Pi_sharp.reshape(R, P, m2), sub_stats["pdhg_valid"].reshape(R, P),
      xover_dry, n_acc)

    for k, v in sub_stats.items():
        if k in ("pdhg_done", "pdhg_valid", "pdhg_err"):
            stats[k] = v.reshape(R, P)
        else:
            # panel-global scalars (and the [n_phases] ladder trace):
            # broadcast with a leading R axis so the packed [R]-schema
            # keeps them and higher-rank entries stay excluded
            stats[k] = jnp.broadcast_to(v, (R,) + v.shape)
    return new_states, stats


def scalar_stat_keys(arrays: InstanceArrays, model: ScenarioModel,
                     espec: EpigraphSpec, prep_sub: PreparedLP,
                     state: SDState, config: SDConfig,
                     ndim: int = 0) -> Tuple[str, ...]:
    """Sorted names of sd_step's scalar stats (``ndim``-dimensional
    entries; 1 for replicated states, where every scalar carries a leading
    [R] axis). Column order of the packed accumulator below."""
    return tuple(k for k, _ in scalar_stat_schema(
        arrays, model, espec, prep_sub, state, config, ndim))


def scalar_stat_schema(arrays, model, espec, prep_sub, state, config,
                       ndim: int = 0):
    """((name, dtype), ...) of sd_step's scalar stats in packed-column
    order — dtypes let the driver restore int/bool semantics after the
    float32 packed readback."""
    if ndim == 1:                     # replication-batched state pytree
        f = lambda st: sd_step_replicated(arrays, model, espec, prep_sub,
                                          st, config)[1]
    else:
        f = lambda st: sd_step(arrays, model, espec, prep_sub, st,
                               config)[1]
    shapes = jax.eval_shape(f, state)
    return tuple((k, shapes[k].dtype)
                 for k in sorted(shapes) if shapes[k].ndim == ndim)


@partial(jax.jit, static_argnames=("config", "n_steps"))
def sd_run(arrays: InstanceArrays, model: ScenarioModel, espec: EpigraphSpec,
           prep_sub: PreparedLP, state: SDState, config: SDConfig,
           n_steps: int, n: jax.Array | None = None,
           proposal: ScenarioModel | None = None
           ) -> Tuple[SDState, jax.Array]:
    """Run up to n_steps SD iterations fully on device.

    A per-step host round trip would put a dispatch and a device->host
    sync on every iteration; chunking the loop into one jit amortizes
    them to one sync per chunk. Returns the final state plus ONE packed
    [n_steps, n_keys] float32 panel of the per-iteration scalar stats
    (column j = ``scalar_stat_keys(...)[j]``): returning a dict of ~30
    scalar streams would make the driver issue ~30 separate
    device->host transfers per chunk. One packed buffer is one
    transfer.

    ``n_steps`` (static) sizes the stats buffers; ``n`` (dynamic, defaults
    to n_steps) is the actual trip count, so a final partial chunk reuses
    the compiled full-chunk executable instead of recompiling — the
    recompile used to cost more than the chunk's compute. Entries past
    ``n`` in the returned stats are zero.
    """
    keys = scalar_stat_keys(arrays, model, espec, prep_sub, state, config)
    acc = jnp.zeros((n_steps, len(keys)), jnp.float32)

    def body(i, carry):
        state, acc = carry
        state, stats = sd_step(arrays, model, espec, prep_sub, state,
                               config, proposal=proposal)
        row = jnp.stack([stats[k].astype(jnp.float32) for k in keys])
        return state, acc.at[i].set(row)

    state, acc = jax.lax.fori_loop(
        0, n_steps if n is None else jnp.minimum(n, n_steps),
        body, (state, acc))
    return state, acc


@partial(jax.jit, static_argnames=("config", "n_steps"))
def sd_run_replicated(arrays: InstanceArrays, model: ScenarioModel,
                      espec: EpigraphSpec, prep_sub: PreparedLP,
                      states: SDState, config: SDConfig,
                      n_steps: int, n: jax.Array | None = None,
                      proposal: ScenarioModel | None = None
                      ) -> Tuple[SDState, dict]:
    """Advance R independent SD replications together, fully on device.

    ``states`` is an SDState pytree with a leading replication axis R
    (tree-stacked). One batched program runs all replications in lockstep:
    subproblem panels solve as [R, 2EB] batched PDHG and the R master QPs
    batch their matvecs — R-fold device utilization vs sequential
    replications on an underfilled chip (the compromise-decision workflow,
    sd/compromise.py, needs R independent runs by construction).

    Trajectories are deterministic for fixed (seeds, R) but not bitwise
    equal to sequential runs: the replication axis flattens into one
    shared LP solve (sd_step_replicated), whose per-element restart and
    compaction decisions see the merged panel, and the R master QPs
    step in lockstep until the slowest one's stopping test — the
    best-iterate latches inside the PDHG/QP solvers can only improve
    with the extra rounds.

    Returns (states, acc) with the per-iteration, per-replication scalar
    stats packed as ONE [n_steps, n_keys, R] float32 panel (one transfer
    per chunk, see sd_run; column j = ``scalar_stat_keys(..., ndim=1)[j]``);
    entries past ``n`` are zero.
    """
    step = lambda st: sd_step_replicated(arrays, model, espec, prep_sub,
                                         st, config, proposal=proposal)
    keys = scalar_stat_keys(arrays, model, espec, prep_sub, states, config,
                            ndim=1)
    R = states.cut_alpha.shape[0]
    acc = jnp.zeros((n_steps, len(keys), R), jnp.float32)

    def body(i, carry):
        states, acc = carry
        states, stats = step(states)
        row = jnp.stack([stats[k].astype(jnp.float32) for k in keys])
        return states, acc.at[i].set(row)

    states, acc = jax.lax.fori_loop(
        0, n_steps if n is None else jnp.minimum(n, n_steps),
        body, (states, acc))
    return states, acc
