"""Dual-vertex crossover: sharpen first-order duals to basic solutions.

The reference gets exact simplex dual vertices from CPLEX/GLPK
(``solve_problem!`` reads constraint duals after a simplex solve,
src/smps/smps_routines.jl:58-61). PDHG converges to epsilon-optimal but
interior-ish duals — valid for cut generation (any dual-feasible point
yields a valid SASA cut) but potentially *slack*: the cut value at the
sampled scenario is the dual objective pi @ h, which an interior point
under-attains vs the optimal vertex.

This module rounds a batch of PDHG dual iterates to vertices of the dual
polyhedron by one active-set least-squares solve (a "crossover" in the
LP-solver sense, done as one batched linear solve instead of serially on
a basis factorization):

  1. read the active structure off the primal-dual pair: rows with tight
     slack (or equality sense) may carry a multiplier; columns strictly
     between their bounds force a zero reduced cost;
  2. solve the masked normal equations for the multiplier supported on
     the active rows that zeroes the reduced costs on the interior
     columns — the complementary-slackness system a basic dual satisfies;
  3. refine the active sets for a few fixed sweeps (a batched active-set
     restoration): columns whose reduced cost violates dual feasibility
     (negative with no upper bound to absorb it / positive with no lower
     bound) join the zero-reduced-cost set; rows whose multiplier lands
     on the wrong side of its sign cone leave the basis. The system is
     re-solved each sweep — the batched analogue of the dual-feasibility
     restoration a simplex crossover performs on one basis at a time;
  4. sign-project onto the dual cone, then accept the rounded point only
     if it is (a) dual-feasible to tolerance and (b) at least as good as
     the input in dual objective. Rejected elements keep their PDHG dual,
     so the step can only tighten cuts, never invalidate them.

Everything is shape-static and batched: [B, m, m] normal systems solved
with batched ``jnp.linalg.solve`` inside a fixed-trip refinement loop.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from sqlp_tpu.models.stage import SENSE_E, SENSE_G, SENSE_L

_PREC = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=())
def sharpen_duals(W: jax.Array, q: jax.Array, senses: jax.Array,
                  lb: jax.Array, ub: jax.Array,
                  H: jax.Array, Y: jax.Array, Pi: jax.Array,
                  feas_tol: float = 1e-6,
                  active_tol: float = 1e-5
                  ) -> Tuple[jax.Array, jax.Array]:
    """Round a batch of duals toward vertices; keep originals when unsafe.

    Args:
      W: [m, n] recourse matrix; q: [n] objective; senses: [m] int
        (+1 '>=', -1 '<=', 0 '=='); lb/ub: [n] variable bounds.
      H: [B, m] right-hand sides; Y: [B, n] primal solutions;
      Pi: [B, m] duals in the d(obj)/d(rhs) convention ('>=' rows >= 0,
        '<=' rows <= 0, '==' free).
      feas_tol: relative dual-feasibility tolerance for acceptance.
      active_tol: relative tightness threshold for rows/bounds.

    Returns:
      (Pi_out [B, m], improved [B] bool — True where the vertex replaced
      the input).
    """
    dt = W.dtype
    m, n = W.shape
    H = H.astype(dt)
    Y = Y.astype(dt)
    Pi = Pi.astype(dt)

    is_eq = senses == SENSE_E
    is_ge = senses == SENSE_G
    is_le = senses == SENSE_L

    # --- 1. active structure -------------------------------------------
    slack = jnp.matmul(Y, W.T, precision=_PREC) - H            # [B, m]
    h_scale = 1.0 + jnp.abs(H)
    row_active = jnp.logical_or(
        is_eq[None, :],
        jnp.logical_or(jnp.abs(slack) <= active_tol * h_scale,
                       jnp.abs(Pi) > active_tol))              # [B, m]

    y_scale = 1.0 + jnp.abs(Y)
    at_lb = jnp.isfinite(lb)[None, :] & (Y - lb[None, :]
                                         <= active_tol * y_scale)
    at_ub = jnp.isfinite(ub)[None, :] & (ub[None, :] - Y
                                         <= active_tol * y_scale)
    interior = ~(at_lb | at_ub)                                # [B, n]

    # --- 2+3. masked normal equations + active-set restoration ---------
    # Each sweep: pi supported on active rows with W[:, interior]^T pi =
    # q[interior] in least squares ((Wc Wc^T) pi = Wc q on the active
    # block, identity pinning pi = 0 on the inactive block), then grow
    # `interior` by dual-infeasible columns and shrink `row_active` by
    # sign-violating rows. Fixed trip count keeps the loop jittable; sets
    # stabilize in a few sweeps (they only move monotonically except for
    # rare row re-activation, which the acceptance test backstops).
    lo_inf = ~jnp.isfinite(lb)
    hi_inf = ~jnp.isfinite(ub)
    q_scale = 1.0 + jnp.abs(q)
    qd = q.astype(dt)

    def solve_ls(interior_f, row_active_b):
        Wc = W[None, :, :] * interior_f[:, None, :]            # [B, m, n]
        M = jnp.matmul(Wc, jnp.swapaxes(Wc, 1, 2),
                       precision=_PREC)                        # [B, m, m]
        ra = row_active_b.astype(dt)
        M = M * ra[:, :, None] * ra[:, None, :]
        diag_reg = jnp.where(row_active_b,
                             1e-8 * (1.0 + jnp.abs(M).max()), 1.0)
        M = M + jax.vmap(jnp.diag)(diag_reg)
        rhs = jnp.matmul(Wc, qd, precision=_PREC) * ra         # [B, m]
        return jnp.linalg.solve(M, rhs[..., None])[..., 0]

    def sweep(carry):
        interior, row_act, _, _, k = carry
        pi = solve_ls(interior.astype(dt), row_act)
        # rows on the wrong side of their sign cone leave the basis
        bad_row = jnp.logical_or(
            jnp.logical_and(is_ge[None, :],
                            pi < -active_tol * (1.0 + jnp.abs(pi))),
            jnp.logical_and(is_le[None, :],
                            pi > active_tol * (1.0 + jnp.abs(pi))))
        row_act1 = jnp.logical_and(row_act, ~bad_row)
        pi = jnp.where(is_ge[None, :], jnp.maximum(pi, 0.0), pi)
        pi = jnp.where(is_le[None, :], jnp.minimum(pi, 0.0), pi)
        # dual-infeasible columns join the zero-reduced-cost set
        g = qd[None, :] - jnp.matmul(pi, W, precision=_PREC)
        viol = jnp.logical_or(
            jnp.logical_and(hi_inf[None, :],
                            g < -active_tol * q_scale[None, :]),
            jnp.logical_and(lo_inf[None, :],
                            g > active_tol * q_scale[None, :]))
        interior1 = jnp.logical_or(interior, viol)
        # Early exit: stable sets reproduce the same pi on the next sweep
        # (solve_ls is deterministic in the sets), so once neither set
        # moved the remaining sweeps are identical re-solves. The batched
        # [B, m, m] factorization dominates sharpen_duals; sets typically
        # stabilize in 2-3 of the 6 sweeps.
        changed = jnp.logical_or(
            jnp.any(interior1 != interior), jnp.any(row_act1 != row_act))
        return interior1, row_act1, pi, changed, k + 1

    _, _, pi_v, _, _ = jax.lax.while_loop(
        lambda c: jnp.logical_and(c[4] < 6, c[3]), sweep,
        (interior, row_active, jnp.zeros_like(Pi), jnp.asarray(True),
         jnp.zeros((), jnp.int32)))

    # --- 4. final sign projection + acceptance test ---------------------
    pi_v = jnp.where(is_ge[None, :], jnp.maximum(pi_v, 0.0), pi_v)
    pi_v = jnp.where(is_le[None, :], jnp.minimum(pi_v, 0.0), pi_v)
    # snap near-zeros so pool dedup sees clean vertices
    pi_v = jnp.where(jnp.abs(pi_v) <= 1e-12 * (1.0 + jnp.abs(pi_v).max()),
                     0.0, pi_v)

    def dual_metrics(P):
        g = q[None, :] - jnp.matmul(P, W, precision=_PREC)     # reduced costs
        lo_inf = ~jnp.isfinite(lb)
        hi_inf = ~jnp.isfinite(ub)
        dviol = (jnp.where(hi_inf[None, :], jnp.maximum(-g, 0.0), 0.0)
                 + jnp.where(lo_inf[None, :], jnp.maximum(g, 0.0), 0.0))
        dres = (jnp.linalg.norm(dviol, axis=-1)
                / (1.0 + jnp.linalg.norm(q)))
        # dual objective incl. finite-bound terms (matches ops/pdhg.py's
        # _kkt_residuals dobj; for the shipped lb=0/ub=inf instances the
        # bound terms vanish and this is pi @ h, the cut contribution)
        lb_term = jnp.where(jnp.isfinite(lb), lb, 0.0)
        ub_term = jnp.where(jnp.isfinite(ub), ub, 0.0)
        dobj = (jnp.sum(P * H, axis=-1)
                + jnp.matmul(jnp.maximum(g, 0.0), lb_term, precision=_PREC)
                - jnp.matmul(jnp.maximum(-g, 0.0), ub_term, precision=_PREC))
        return dres, dobj

    dres_v, dobj_v = dual_metrics(pi_v)
    dres_0, dobj_0 = dual_metrics(Pi)
    obj_scale = 1.0 + jnp.abs(dobj_0)
    accept = jnp.logical_and(
        dres_v <= feas_tol,
        dobj_v >= dobj_0 - 1e-9 * obj_scale)
    # ... and never accept a numerically exploded solve
    accept = jnp.logical_and(accept, jnp.all(jnp.isfinite(pi_v), axis=-1))

    Pi_out = jnp.where(accept[:, None], pi_v, Pi)
    return Pi_out, accept
