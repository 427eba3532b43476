"""On-device scenario model: padded marginal tables + batched sampler.

On-device replacement for the reference's per-iteration host sampling
(``rand(sto)``, src/smps/smps_sto.jl:117-149) and per-scenario sparse delta
extraction (``delta_coefficients``, src/sd_algorithm/subprob.jl:104-121).

Every independent random position k (order of first appearance in the sto
file) carries:
  * an index into the stage-2 constraint rows (``rv_row[k]``),
  * whether it patches the RHS or a transfer-matrix entry (``rv_is_rhs[k]``),
  * for transfer positions, the last-stage column index (``rv_col[k]``),
  * the template value at that position (``base[k]``), so that a sampled
    value v yields the delta v - base[k] directly (the reference stores
    sparse delta vectors per scenario; we store one [S, R] dense delta
    panel — R is the number of random positions, <= 117 on all shipped
    instances).

Positions addressing the cor OBJECTIVE row are random COST coefficients
(``rv_is_cost[k]``, current-stage column ``rv_ycol[k]``) — the feature the
reference leaves open as TODO 6 ("Allow randomness in cost coefficients q",
readme.md:25-26). Random q never changes the dual objective pi'(r - Tx); it
only restricts dual feasibility to {pi : W'pi <= q_s}, so the SASA cut math
is unchanged except that the argmax over the dual pool must mask
inadmissible (dual-infeasible-for-that-scenario) vertices — see
sd/cuts.py. ``seed_dual`` is a dual vector feasible for EVERY scenario
(computed against the elementwise support-minimum cost q_min), guaranteeing
the masked argmax always has one admissible candidate.

Sampling is inverse-CDF over padded discrete tables, or affine transforms of
normal/uniform draws, fully vmapped: one ``sample_deltas`` call produces a
[B, R] batch.
"""

from __future__ import annotations

import dataclasses
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from sqlp_tpu.models.smps_sto import (DiscreteDistribution,
                                      NormalDistribution, StoData,
                                      UniformDistribution)
from sqlp_tpu.models.smps_tim import Position
from sqlp_tpu.models.stage import StageLP

DIST_DISCRETE, DIST_NORMAL, DIST_UNIFORM = 0, 1, 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScenarioModel:
    """Padded per-position marginals, ready for batched device sampling."""

    # static index metadata
    rv_row: jax.Array        # [R] int32, stage-2 constraint row index
    rv_is_rhs: jax.Array     # [R] bool
    rv_col: jax.Array        # [R] int32 (0 where is_rhs)
    base: jax.Array          # [R] template value at the position
    dist_type: jax.Array     # [R] int32 in {DISCRETE, NORMAL, UNIFORM}
    # discrete tables, padded to the max outcome count
    values: jax.Array        # [R, V] outcome values (padded with last value)
    cdf: jax.Array           # [R, V] normalized inclusive CDF (padded with 1)
    # normal / uniform parameters
    mean: jax.Array          # [R]
    std: jax.Array           # [R]
    left: jax.Array          # [R]
    width: jax.Array         # [R]
    # random COST positions (reference TODO 6): position k patches the
    # stage-2 objective coefficient of column rv_ycol[k]
    rv_is_cost: jax.Array = None   # [R] bool
    rv_ycol: jax.Array = None      # [R] int32 (0 where not cost)
    # a dual vector feasible for every scenario's {pi : W'pi <= q_s}
    # (zeros when the instance has no cost randomness or none was found)
    seed_dual: jax.Array = None    # [m2]
    # static metadata: compile-time branch flags + the cost-position
    # indices as Python ints (the admissibility mask unrolls over them)
    has_cost: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    seed_valid: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    cost_idx: tuple = dataclasses.field(       # ((position k, ycol j), ...)
        default=(), metadata=dict(static=True))

    @property
    def n_rv(self) -> int:
        return int(self.rv_row.shape[0])


def build_scenario_model(sto: StoData, sp2: StageLP,
                         dtype=jnp.float32,
                         dual_system=None) -> ScenarioModel:
    """Compile a parsed sto file against the stage-2 template.

    ``dual_system`` ((W, r, senses), optional): the COMPILED recourse
    system to compute the seed dual against when it differs from sp2's —
    instance compilation appends bound-folding rows (instance.py), and a
    seed dual must be feasible for the system the solver actually uses.
    """
    positions: List[Position] = list(sto.indep.keys())
    R = len(positions)
    row_lookup = sp2.row_lookup
    col_lookup = sp2.col_lookup
    cur_lookup = sp2.cur_lookup

    v_max = 1
    for d in sto.indep.values():
        if isinstance(d, DiscreteDistribution):
            v_max = max(v_max, len(d.value))

    rv_row = np.zeros(R, np.int32)
    rv_is_rhs = np.zeros(R, bool)
    rv_col = np.zeros(R, np.int32)
    rv_is_cost = np.zeros(R, bool)
    rv_ycol = np.zeros(R, np.int32)
    base = np.zeros(R, np.float64)
    dist_type = np.zeros(R, np.int32)
    values = np.zeros((R, v_max), np.float64)
    cdf = np.ones((R, v_max), np.float64)
    mean = np.zeros(R, np.float64)
    std = np.zeros(R, np.float64)
    left = np.zeros(R, np.float64)
    width = np.zeros(R, np.float64)

    for k, pos in enumerate(positions):
        if pos.row_name == sp2.obj_row_name and sp2.obj_row_name:
            # random cost coefficient (reference TODO 6, readme.md:25-26)
            assert pos.col_name in cur_lookup, (
                f"Cost position col {pos.col_name} not a stage-2 var")
            j = cur_lookup[pos.col_name]
            rv_is_cost[k] = True
            rv_ycol[k] = j
            base[k] = sp2.c[j]
        else:
            assert pos.row_name in row_lookup, (
                f"Random position row {pos.row_name} not in stage-2 template")
            i = row_lookup[pos.row_name]
            rv_row[k] = i
            if pos.col_name in ("RHS", "rhs"):
                rv_is_rhs[k] = True
                base[k] = sp2.rhs[i]
            else:
                assert pos.col_name in col_lookup, (
                    f"Random position col {pos.col_name} not a last-stage var")
                j = col_lookup[pos.col_name]
                rv_col[k] = j
                base[k] = sp2.T[i, j]

        d = sto.indep[pos]
        if isinstance(d, DiscreteDistribution):
            dist_type[k] = DIST_DISCRETE
            vals = np.asarray(d.value, np.float64)
            probs = np.asarray(d.probability, np.float64)
            n = len(vals)
            values[k, :n] = vals
            values[k, n:] = vals[-1]
            c = np.cumsum(probs) / probs.sum()
            cdf[k, :n] = c
            cdf[k, n:] = 1.0
        elif isinstance(d, NormalDistribution):
            dist_type[k] = DIST_NORMAL
            mean[k] = d.mean
            std[k] = np.sqrt(d.variance)
        elif isinstance(d, UniformDistribution):
            dist_type[k] = DIST_UNIFORM
            left[k] = d.left
            width[k] = d.right - d.left
        else:
            raise TypeError(f"Unknown distribution {type(d)}")

    has_cost = bool(rv_is_cost.any())
    if dual_system is None:
        dual_system = (sp2.W, sp2.rhs, sp2.senses)
    m2 = len(dual_system[1])
    seed_dual = np.zeros(m2, np.float64)
    seed_valid = False
    if has_cost:
        seed_dual, seed_valid = _compute_seed_dual(
            sp2, dual_system, rv_is_cost, rv_ycol, dist_type, values,
            mean, std, left)

    f = lambda a: jnp.asarray(a, dtype=dtype)
    return ScenarioModel(
        rv_row=jnp.asarray(rv_row), rv_is_rhs=jnp.asarray(rv_is_rhs),
        rv_col=jnp.asarray(rv_col), base=f(base),
        dist_type=jnp.asarray(dist_type),
        values=f(values), cdf=f(cdf), mean=f(mean), std=f(std),
        left=f(left), width=f(width),
        rv_is_cost=jnp.asarray(rv_is_cost), rv_ycol=jnp.asarray(rv_ycol),
        seed_dual=f(seed_dual),
        has_cost=has_cost, seed_valid=seed_valid,
        cost_idx=tuple((int(k), int(rv_ycol[k]))
                       for k in np.flatnonzero(rv_is_cost)),
    )


def _compute_seed_dual(sp2: StageLP, dual_system, rv_is_cost, rv_ycol,
                       dist_type, values, mean, std, left,
                       normal_sigmas: float = 10.0):
    """A dual vector feasible for EVERY scenario's dual polytope.

    With random cost the dual feasible set {pi : W'pi <= q_s} varies per
    scenario; a pool vertex collected under one scenario's q may be
    infeasible (hence cut-invalid) for another. Any pi with
    W'pi <= q_min — q_min the elementwise support-minimum cost — is
    feasible for ALL scenarios, so seeding the argmax with one such vector
    guarantees every scenario has at least one admissible dual
    (sd/cuts.py masks the rest). One host LP, solved once at compile:

        max r'pi  s.t.  W'pi <= q_min,  pi_i >= 0 ('>=' rows),
                        pi_i <= 0 ('<=' rows), free ('==' rows).

    NORMAL cost positions have unbounded support; their q_min is taken at
    mean - normal_sigmas*sigma (the device sampler is inverse-CDF f32, so
    draws beyond ~6 sigma cannot occur — same convention as
    routines.recourse_lower_bound). Returns (pi, valid); an infeasible LP
    (recourse unbounded under q_min) returns valid=False with a warning —
    SD then refuses to run (driver), EF/evaluate still work.
    """
    import warnings

    import scipy.optimize

    q_min = np.asarray(sp2.c, np.float64).copy()
    for k in np.flatnonzero(rv_is_cost):
        j = int(rv_ycol[k])
        if dist_type[k] == DIST_DISCRETE:
            lo = float(values[k].min())
        elif dist_type[k] == DIST_NORMAL:
            lo = float(mean[k] - normal_sigmas * std[k])
        else:
            lo = float(left[k])
        q_min[j] = min(q_min[j], lo)

    W_sys, r_sys, s_sys = dual_system
    W = np.asarray(W_sys, np.float64)
    r = np.asarray(r_sys, np.float64)
    senses = np.asarray(s_sys)
    from sqlp_tpu.models.stage import SENSE_G, SENSE_L
    bounds = [(0.0, None) if s == SENSE_G else
              (None, 0.0) if s == SENSE_L else (None, None)
              for s in senses]
    for c_obj in (-r, np.zeros_like(r)):  # maximize r'pi; fallback: feasibility
        res = scipy.optimize.linprog(c_obj, A_ub=W.T, b_ub=q_min,
                                     bounds=bounds, method="highs")
        if res.status == 0:
            return np.asarray(res.x, np.float64), True
        if res.status != 3:    # not unbounded -> infeasible/failed
            break
    warnings.warn(
        "no universally feasible dual exists for the random-cost support "
        "(recourse unbounded at the support-minimum cost q_min); SD cut "
        "generation cannot be certified — use the extensive-form solver "
        "or tighten the cost distribution's support")
    return np.zeros(len(r), np.float64), False


def _uniform_panel(key: jax.Array, batch: int, R: int, dt,
                   method: str) -> jax.Array:
    """[batch, R] uniforms under the chosen variance-reduction scheme.

    The reference leaves sampling methods as a TODO ("Implement SMPS
    sampling methods (antithetic, stratified)", readme.md:27); here they
    are one transform on the uniform panel every marginal consumes:

      * "iid"        — plain i.i.d. draws;
      * "antithetic" — pairs (u, 1-u): rows [0, B/2) are i.i.d., rows
        [B/2, B) their reflections. Falls back to iid for odd batches.
      * "stratified" — per position, one draw from each of `batch` equal
        strata of [0, 1), independently shuffled across positions (Latin
        hypercube): marginal stratification without coupling positions.
    """
    if method == "antithetic" and batch % 2 == 0 and batch > 1:
        half = batch // 2
        u0 = jax.random.uniform(key, (half, R), dtype=dt)
        return jnp.concatenate([u0, 1.0 - u0], axis=0)
    if method == "stratified" and batch > 1:
        k_v, k_p = jax.random.split(key)
        v = jax.random.uniform(k_v, (batch, R), dtype=dt)
        # independent stratum permutation per position (vmapped over R)
        perm = jax.vmap(lambda k: jax.random.permutation(k, batch))(
            jax.random.split(k_p, R)).T                    # [batch, R]
        return (perm.astype(dt) + v) / batch
    assert method in ("iid", "antithetic", "stratified"), method
    return jax.random.uniform(key, (batch, R), dtype=dt)


def sample_values(key: jax.Array, model: ScenarioModel, batch: int,
                  method: str = "iid", complement: bool = False
                  ) -> jax.Array:
    """Draw a [batch, R] panel of raw scenario values.

    Discrete positions use inverse-CDF lookup on the padded table; normal
    and uniform are affine transforms of the uniform panel. ``method``
    selects the uniform-panel scheme (see ``_uniform_panel``); under
    "iid" the normal positions keep their own direct normal draws (the
    original RNG stream — pinned trajectories depend on it), while the
    variance-reduction methods push the structured uniforms through the
    normal inverse CDF so the scheme carries through every marginal type.

    ``complement=True`` returns the ANTITHETIC complement of the panel
    the same (key, method) would draw: u -> 1-u, z -> -z. Two calls with
    the same key and opposite ``complement`` give a negatively-coupled
    pair of identically-distributed panels — the cross-replication
    pairing the certified-bound machinery uses to shrink the Student-t
    spread (a complemented stratified/LHS panel is itself a valid
    stratified/LHS panel, so per-panel variance reduction is preserved).
    """
    k_u, k_z = jax.random.split(key)
    R = model.n_rv
    dt = model.values.dtype

    if method == "iid" or batch <= 1:
        u = jax.random.uniform(k_u, (batch, R), dtype=dt)
        z = jax.random.normal(k_z, (batch, R), dtype=dt)
        if complement:
            u = 1.0 - u
            z = -z
    else:
        from jax.scipy.special import ndtri
        u = _uniform_panel(k_u, batch, R, dt, method)
        u_z = _uniform_panel(k_z, batch, R, dt, method)
        if complement:
            u = 1.0 - u
            u_z = 1.0 - u_z
        # clamp away exact 0/1 (ndtri(0/1) = -+inf); stratified/antithetic
        # panels can land arbitrarily close to the endpoints
        tiny = jnp.asarray(1e-7, dt)
        z = ndtri(jnp.clip(u_z, tiny, 1.0 - tiny)).astype(dt)

    # inverse CDF: index = #{j : cdf[j] <= u}; u < cdf[0] -> 0
    idx = jnp.sum(u[:, :, None] >= model.cdf[None, :, :], axis=-1)
    idx = jnp.clip(idx, 0, model.values.shape[1] - 1)
    discrete = jnp.take_along_axis(
        jnp.broadcast_to(model.values, (batch, R, model.values.shape[1])),
        idx[:, :, None], axis=-1)[..., 0]
    normal = model.mean + model.std * z
    uniform = model.left + model.width * u

    vals = jnp.where(model.dist_type == DIST_DISCRETE, discrete,
                     jnp.where(model.dist_type == DIST_NORMAL, normal,
                               uniform))
    return vals


def sample_deltas(key: jax.Array, model: ScenarioModel, batch: int,
                  method: str = "iid", complement: bool = False
                  ) -> jax.Array:
    """Draw a [batch, R] panel of deltas vs the template (value - base).

    This is the device analog of ``delta_coefficients``
    (src/sd_algorithm/subprob.jl:104-121) fused with sampling.
    """
    return sample_values(key, model, batch, method=method,
                         complement=complement) - model.base


def values_to_deltas(model: ScenarioModel, values: jax.Array) -> jax.Array:
    """Convert raw scenario values [..., R] (position order = order of
    first appearance in the sto file, like the reference's
    ``spSmpsScenario``) into the delta panels the solver consumes."""
    return jnp.asarray(values, model.base.dtype) - model.base


def scenario_log_pdf(model: ScenarioModel, values: jax.Array) -> jax.Array:
    """log p(values) under the model, summed over independent positions.

    values: [..., R] raw scenario values -> [...] log densities (discrete
    positions contribute log pmf; a value off a discrete support returns
    -inf). The importance-sampling weight for scenarios drawn from a
    proposal model q is exp(log_pdf_target - log_pdf_q)
    (``sample_importance``) — the reference names this workflow in its
    TODO list (readme.md:24-26: override scenario weight / importance
    sampling) but never implements it.
    """
    dt = model.values.dtype
    v = jnp.asarray(values, dt)[..., None]                  # [..., R, 1]
    # discrete pmf: probability mass of the nearest table entry (within a
    # relative tolerance), -inf otherwise
    pmf = jnp.diff(model.cdf, axis=-1, prepend=0.0)         # [R, V]
    close = jnp.abs(model.values - v) <= 1e-6 * (1.0 + jnp.abs(model.values))
    p_disc = jnp.max(jnp.where(close, pmf, 0.0), axis=-1)   # [..., R]
    log_disc = jnp.log(jnp.maximum(p_disc, 1e-300))
    vr = v[..., 0]
    z = (vr - model.mean) / jnp.maximum(model.std, 1e-30)
    log_norm = (-0.5 * z * z - 0.5 * jnp.log(2.0 * jnp.pi)
                - jnp.log(jnp.maximum(model.std, 1e-30)))
    in_box = jnp.logical_and(vr >= model.left,
                             vr <= model.left + model.width)
    log_unif = jnp.where(in_box,
                         -jnp.log(jnp.maximum(model.width, 1e-30)),
                         -jnp.inf)
    lp = jnp.where(model.dist_type == DIST_DISCRETE, log_disc,
                   jnp.where(model.dist_type == DIST_NORMAL, log_norm,
                             log_unif))
    return jnp.sum(lp, axis=-1)


def sample_importance(key: jax.Array, target: ScenarioModel,
                      proposal: ScenarioModel, batch: int,
                      method: str = "iid"):
    """Importance sampling: draw from ``proposal``, weight for ``target``.

    Returns (deltas [batch, R] vs the TARGET template, weights [batch])
    with w = p_target(v) / p_proposal(v) — ready for
    ``sd_step(..., deltas=..., weights=...)`` /
    ``SDSolver.step_scenarios``. Realizes the reference's importance-
    sampling TODOs (readme.md:24-30 items 5 and 8: override scenario
    weight in add_scenario!, override total_weight) on device.
    """
    vals = sample_values(key, proposal, batch, method=method)
    logw = scenario_log_pdf(target, vals) - scenario_log_pdf(proposal, vals)
    return vals - target.base, jnp.exp(logw)


def deltas_to_rhs(model: ScenarioModel, deltas: jax.Array, m2: int) -> jax.Array:
    """Scatter an RHS-position delta panel [..., R] to dense [..., m2].

    Transfer-matrix positions contribute 0 here; use ``effective_rhs_deltas``
    to fold them in against a fixed x.
    """
    d = jnp.where(model.rv_is_rhs, deltas, 0.0)
    out = jnp.zeros(deltas.shape[:-1] + (m2,), deltas.dtype)
    return out.at[..., model.rv_row].add(d)


def effective_rhs_deltas(model: ScenarioModel, deltas: jax.Array,
                         x: jax.Array) -> jax.Array:
    """Per-position effective RHS contribution at a fixed first-stage x.

    For RHS positions the contribution is the delta itself; for transfer
    positions T[i,j] += d means the row-i RHS of (r - T x) changes by
    -d * x[j]. Cost positions contribute nothing here (q enters the
    subproblem objective, see ``cost_panel``). Returns [..., R]; scattering
    by ``rv_row`` then gives the dense change of h = r - T x. This is how
    scenario randomness enters the argmax scores and the subproblem RHS
    uniformly (cf. ``eval_dual``, src/sd_algorithm/subprob.jl:128-131).
    """
    tr = -deltas * x[..., model.rv_col]
    if model.has_cost:
        tr = jnp.where(model.rv_is_cost, 0.0, tr)
    return jnp.where(model.rv_is_rhs, deltas, tr)


def cost_panel(model: ScenarioModel, deltas: jax.Array,
               q: jax.Array) -> jax.Array:
    """Per-scenario stage-2 objective q_s = q + scatter(cost deltas).

    deltas: [..., R] raw deltas -> [..., n2]. Only meaningful when
    ``model.has_cost``; RHS/transfer positions contribute nothing.
    """
    d = jnp.where(model.rv_is_cost, deltas, 0.0).astype(q.dtype)
    out = jnp.broadcast_to(q, deltas.shape[:-1] + q.shape)
    return out.at[..., model.rv_ycol].add(d)
