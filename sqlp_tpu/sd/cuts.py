"""Cut machinery: argmax procedure, SASA cut assembly, epigraph evaluation.

Port of record:
  * ``argmax_procedure`` (src/sd_algorithm/subprob.jl:141-169) — the
    reference's O(S·D·m2) double loop becomes one [D,R]x[R,S] matmul plus a
    masked argmax over the dual axis (the matmul hot loop of the solver);
  * ``build_sasa_cut`` (src/sd_algorithm/epigraph.jl:125-146) — alpha/beta
    assembly from the per-scenario argmax duals, probability-weighted;
  * ``evaluate_epigraph`` / ``evaluate_multi_epigraph``
    (src/sd_algorithm/epigraph.jl:177-228) — pointwise max over discounted
    cuts, the undiscounted incumbent cut, and the lower bound.

MIN_SENSE only: the reference's MAX branch is dead/buggy (SURVEY.md quirk 2;
subprob.jl:152-161 can never replace -Inf) and its cell constructor rejects
non-MIN problems (cell.jl:45-49).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sqlp_tpu.models.instance import InstanceArrays
from sqlp_tpu.models.scenario import ScenarioModel, effective_rhs_deltas

_PREC = jax.lax.Precision.HIGHEST


def _dot(a, b):
    return jnp.matmul(a, b, precision=_PREC)


class Cut(NamedTuple):
    """eta >= alpha + beta @ x, stored unscaled (epigraph.jl:5-12)."""

    alpha: jax.Array  # scalar or [E]
    beta: jax.Array   # [n1] or [E, n1]


def quantized_argmax(scores: jax.Array) -> jax.Array:
    """Tiling-invariant argmax over axis 0 of a [D, S] score panel.

    Matmul-produced scores carry reassociation noise that depends on how
    XLA tiles the reduction, so a near-tied exact argmax flips between
    mesh-sharded and single-device runs (and between device counts),
    breaking bitwise trajectory equality (tests/test_parallel.py,
    __graft_entry__.dryrun_multichip). Scores are therefore floored to a
    quantum relative to the per-scenario best before the argmax — any
    vertex within the quantum of the best is an equally good cut
    contributor, and ties inside a cell resolve to the lowest pool index
    on every tiling. The max reduction itself is exact under any
    association, so the quantum is tiling-invariant too. Same pattern as
    the pool warm-start pick (sd/algorithm.py), with a dtype-matched
    quantum: reassociation noise is ~1e-6 relative in f32 (HIGHEST
    precision) and ~1e-15 in f64, so the quantum stays far above the
    noise and far below cut-quality relevance.
    """
    eps = 1e-4 if scores.dtype == jnp.float32 else 1e-9
    best = jnp.max(scores, axis=0)                         # [S], exact
    # empty-pool / all-masked columns have best = -inf; a finite fallback
    # quantum keeps floor() out of nan territory (argmax then yields 0,
    # matching the exact argmax on an all--inf column)
    quantum = jnp.where(jnp.isfinite(best),
                        eps * (1.0 + jnp.abs(best)), 1.0)
    return jnp.argmax(jnp.floor(scores / quantum), axis=0)


def argmax_duals(duals: jax.Array, n_duals: jax.Array,
                 base: jax.Array, rv_row: jax.Array,
                 eff_deltas: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Per-scenario argmax over the dual pool.

    scores[d, s] = pi_d @ (base + scatter(eff_deltas[s])) computed as a base
    matvec plus a [D,R]x[R,S] matmul over the random positions only — the
    delta panel never materializes dense [S, m2] (the reference's per-
    scenario sparse delta dot, subprob.jl:128-131, vectorized). The pick
    is the tiling-invariant quantized argmax (:func:`quantized_argmax`);
    the returned value is the exact maximum.

    Args:
      duals: [D, m2] pool; n_duals: live count.
      base: [m2] = r - T x.
      rv_row: [R] row index of each random position.
      eff_deltas: [S, R] effective RHS deltas at this x.

    Returns: (max_val [S], argmax index [S]).
    """
    D = duals.shape[0]
    base_scores = _dot(duals, base)                        # [D]
    delta_scores = _dot(duals[:, rv_row], eff_deltas.T)    # [D, S]
    scores = base_scores[:, None] + delta_scores
    live = (jnp.arange(D) < n_duals)[:, None]
    scores = jnp.where(live, scores, -jnp.inf)
    return jnp.max(scores, axis=0), quantized_argmax(scores)


def build_sasa_cut(arrays: InstanceArrays, model: ScenarioModel,
                   duals: jax.Array, n_duals: jax.Array,
                   scen_deltas: jax.Array, scen_weights: jax.Array,
                   total_weight: jax.Array, x: jax.Array,
                   with_counts: bool = False) -> Cut:
    """Build one SASA cut for one epigraph at x (epigraph.jl:125-146).

    alpha = sum_s p_s pi_s @ (r + dr_s)
    beta  = -sum_s p_s (T + dT_s)' pi_s
    with p_s = weight_s / sum(weights) and pi_s the pool argmax for s.

    Until the scenario store saturates, sum(weights) == total_weight and
    this is exactly the reference's p_s = w_s/total_weight. After
    saturation the stored panel is an i.i.d. subsample of the scenario
    stream, and normalizing by the STORED weight sum keeps the cut a
    full-strength unbiased SAA estimate. Normalizing by the ever-growing
    total_weight instead would scale every new cut by stored/total -> 0,
    collapsing the model toward the epigraph lower bound (observed on
    ssn with B=8: lb estimate peaked at 9.89 exactly when 8*iter hit
    max_scenarios=4096, then decayed like 9.9 * 4096/(8*iter)).

    Dead scenario slots carry weight 0 and contribute nothing.

    With ``with_counts`` also returns the per-vertex argmax win mass
    counts[d] = sum of p_s over scenarios whose argmax is vertex d — the
    usage signal for the dual pool's eviction policy (dual_pool.py).

    Random-cost instances (``model.has_cost``; reference TODO 6): the dual
    objective pi'(r_s - T_s x) never involves q, so the cut assembly is
    unchanged — but a pool vertex is only a VALID lower bound for scenario
    s if it is dual-feasible there, i.e. (W'pi)_j <= q_s[j] at the random
    cost columns (elsewhere q is shared and every pool dual is
    epsilon-feasible by construction). The argmax therefore masks
    inadmissible (dual, scenario) pairs; ``model.seed_dual`` — feasible
    for every scenario by construction (scenario.py:_compute_seed_dual) —
    rides along as a virtual pool row so the masked argmax always has a
    candidate.
    """
    eff = effective_rhs_deltas(model, scen_deltas, x)       # [S, R]
    base = arrays.r - _dot(arrays.T, x)                     # [m2]
    if model.has_cost:
        duals = jnp.concatenate(
            [duals, model.seed_dual[None, :].astype(duals.dtype)], axis=0)
        D = duals.shape[0]
        base_scores = _dot(duals, base)                     # [D+1]
        delta_scores = _dot(duals[:, model.rv_row], eff.T)  # [D+1, S]
        scores = base_scores[:, None] + delta_scores
        live = jnp.concatenate(
            [jnp.arange(D - 1) < n_duals, jnp.ones((1,), bool)])
        scores = jnp.where(live[:, None], scores, -jnp.inf)
        # admissibility mask, unrolled over the (few) cost positions:
        # slack_d = (W'pi_d)_j - q_template_j must stay <= dq_s within a
        # relative tolerance (pool duals are epsilon-feasible to begin
        # with — PDHG valid_tol — so the mask uses the same order)
        for k, j in model.cost_idx:
            slack = _dot(duals, arrays.W[:, j]) - model.base[k]   # [D+1]
            tol_k = 1e-4 * (1.0 + jnp.abs(model.base[k]))
            viol = slack[:, None] > scen_deltas[:, k][None, :] + tol_k
            scores = jnp.where(viol, -jnp.inf, scores)
        best = quantized_argmax(scores)                     # [S]
    else:
        _, best = argmax_duals(duals, n_duals, base, model.rv_row, eff)

    wsum = jnp.sum(scen_weights)
    p = scen_weights / jnp.maximum(wsum, 1e-30)             # [S]

    # Never materialize Pi = duals[best] ([S, m2], the dominant HBM
    # traffic of the cut build): every per-scenario term either collapses
    # onto the argmax win-mass per vertex (counts[d] = sum of p_s over
    # scenarios won by vertex d — then sum_s p_s pi_s = counts @ duals) or
    # only touches the R random rows ([S, R] gather, R << m2).
    counts = jnp.zeros((duals.shape[0],), p.dtype).at[best].add(p)  # [D]
    pi_at_rows = duals[:, model.rv_row][best]               # [S, R]

    # alpha: pi @ r plus RHS-delta corrections at the random rows.
    rhs_delta = jnp.where(model.rv_is_rhs[None, :], scen_deltas, 0.0)  # [S, R]
    alpha = (_dot(counts, _dot(duals, arrays.r))
             + jnp.sum(p * jnp.sum(rhs_delta * pi_at_rows, axis=1)))

    # beta: -T' (sum_s p_s pi_s) plus transfer-delta corrections (cost
    # positions patch q, not T — they contribute to neither alpha nor beta;
    # q never appears in the dual objective)
    pi_bar = _dot(counts, duals)                            # [m2]
    beta = -_dot(arrays.T.T, pi_bar)                        # [n1]
    not_tr = jnp.logical_or(model.rv_is_rhs, model.rv_is_cost) \
        if model.has_cost else model.rv_is_rhs
    tr_contrib = jnp.where(not_tr[None, :], 0.0,
                           p[:, None] * scen_deltas * pi_at_rows)  # [S, R]
    beta = beta.at[model.rv_col].add(-jnp.sum(tr_contrib, axis=0))
    cut = Cut(alpha=alpha, beta=beta)
    if with_counts:
        # eviction scores cover pool slots only — drop the virtual seed row
        return cut, (counts[:-1] if model.has_cost else counts)
    return cut


def eval_dual(arrays: InstanceArrays, model: ScenarioModel,
              delta: jax.Array, x: jax.Array, pi: jax.Array) -> jax.Array:
    """pi' ((r + dr) - (T + dT) x) for one scenario delta [R] — the dual
    objective value the argmax maximizes (``eval_dual``,
    src/sd_algorithm/subprob.jl:128-131; validated against the solver
    objective in the reference's test/sd_test.jl:62-65)."""
    eff = effective_rhs_deltas(model, delta[None, :], x)[0]     # [R]
    base = arrays.r - _dot(arrays.T, x)
    return _dot(pi, base) + _dot(pi[model.rv_row], eff)


def evaluate_epigraph(cut_alpha: jax.Array, cut_beta: jax.Array,
                      cut_mark: jax.Array, cut_live: jax.Array,
                      inc_alpha: jax.Array, inc_beta: jax.Array,
                      inc_valid: jax.Array, total_weight: jax.Array,
                      lower_bound: jax.Array, x: jax.Array) -> jax.Array:
    """Pointwise max over discounted cuts / incumbent cut / lb for ONE
    epigraph, unweighted (epigraph.jl:177-205).

    Cut value: d*(alpha + beta@x) + (1-d)*lb with d = weight_mark/total;
    incumbent cut evaluated undiscounted (epigraph.jl:193-195).
    """
    d = cut_mark / jnp.maximum(total_weight, 1e-30)         # [K]
    vals = d * (cut_alpha + _dot(cut_beta, x)) + (1.0 - d) * lower_bound
    vals = jnp.where(cut_live, vals, -jnp.inf)
    best = jnp.maximum(lower_bound, jnp.max(vals, initial=-jnp.inf))
    inc_val = inc_alpha + _dot(inc_beta, x)
    return jnp.maximum(best, jnp.where(inc_valid, inc_val, -jnp.inf))


def evaluate_multi_epigraph(state, espec, x: jax.Array) -> jax.Array:
    """Objective-weighted sum over epigraphs (epigraph.jl:210-228)."""
    per_epi = jax.vmap(evaluate_epigraph)(
        state.cut_alpha, state.cut_beta, state.cut_mark, state.cut_live,
        state.inc_alpha, state.inc_beta, state.inc_valid,
        state.total_weight, espec.lower_bound,
        jnp.broadcast_to(x, (state.cut_alpha.shape[0],) + x.shape))
    return jnp.sum(espec.obj_weight * per_epi)
