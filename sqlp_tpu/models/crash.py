"""Extensive-form (deterministic equivalent) solver: the crash start.

Port of record: ``all_in_one`` (src/crash.jl:18-73). The reference builds
one big JuMP model — root copy + per-scenario second-stage variable/
constraint copies with probability-weighted objective — and the driver
solves it with CPLEX to get a starting x0
(test/instance_test/sd_single_cut_test.jl:42-46). Here the deterministic
equivalent

    min  c@x + sum_s p_s q@y_s
    s.t. A1 x {senses1} b1
         T x + W y_s {senses2} r + dr_s      for each scenario s
         lb1 <= x <= ub1,  lb2 <= y_s <= ub2

is solved by a *structured* PDHG: the constraint operator is applied
blockwise ([S, n2] panels against shared W/T), so the [S*m2, n1+S*n2]
matrix never materializes — the same scenario-batched matmuls as the
subproblem kernel, so the EF runs as wide dense matmuls. Also
usable as a direct SAA solver on a fixed scenario panel.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from sqlp_tpu.config import PDHGConfig
from sqlp_tpu.models.instance import Instance, InstanceArrays
from sqlp_tpu.models.scenario import ScenarioModel, sample_deltas
from sqlp_tpu.models.stage import SENSE_E, SENSE_L

_PREC = jax.lax.Precision.HIGHEST
_BIG = 1e30


def _dot(a, b):
    return jnp.matmul(a, b, precision=_PREC)


def _flip(senses, M, dtype):
    f = jnp.where(senses == SENSE_L, -1.0, 1.0).astype(dtype)
    return f, f[:, None] * M


@partial(jax.jit, static_argnames=("config", "return_duals"))
def solve_extensive_form(arrays: InstanceArrays, model: ScenarioModel,
                         deltas: jax.Array, probs: jax.Array,
                         config: PDHGConfig = PDHGConfig(),
                         return_duals: bool = False,
                         x0: jax.Array | None = None,
                         Y0: jax.Array | None = None,
                         U0: jax.Array | None = None,
                         u00: jax.Array | None = None,
                         omega0: jax.Array | None = None
                         ) -> Tuple[jax.Array, jax.Array, dict]:
    """Solve the extensive form over a fixed scenario panel.

    Args:
      arrays: compiled instance blocks.
      deltas: [S, R] raw scenario deltas (value - template).
      probs: [S] scenario probabilities (sum to 1).
      config: PDHG parameters.
      x0/Y0/U0/u00: optional warm starts in ORIGINAL units (e.g. a previous
        lower-precision solve's outputs — the f64 certificate refinement
        in sd/lower_bound.py continues from the f32 solution).
      return_duals: also return the best iterate's per-scenario EF duals
        [S, m2] AND second-stage blocks [S, n2], unscaled to the original
        rows/columns/objective (duals in the d(obj)/d(rhs) convention,
        like ops/pdhg.py). These are the certificate the SAA lower bound
        builds its aggregate cut from (sd/lower_bound.py:saa_ef_bound):
        W' (pi_s / probs_s) <= q holds to the solve tolerance (the f64
        warm-started refinement pass there pushes the residual to ~1e-6
        relative), and the duality gap bounds how far the aggregate
        cut's model minimum sits below the EF optimum.

    Returns: (x [n1], objective, stats[, duals, Y, u0]) — ``u0`` being
    the stage-1 row duals, accepted back as the ``u00`` warm start.
    """
    dtype = arrays.c.dtype
    S = deltas.shape[0]
    m1, n1 = arrays.A1.shape
    m2, n2 = arrays.W.shape

    # objective normalization (conditioning; see SDConfig.normalize_objective)
    obj_s = jnp.maximum(1.0, jnp.maximum(
        jnp.max(jnp.abs(arrays.c), initial=0.0),
        jnp.max(jnp.abs(arrays.q), initial=0.0)))
    arrays = dataclasses.replace(arrays, c=arrays.c / obj_s,
                                 q=arrays.q / obj_s)

    # --- joint Ruiz equilibration of the structured constraint operator
    # [[A1, 0], [T, W]]: row scales r1/r2, col scales cx/cy. Without this
    # the EF stalls on badly-row-scaled instances (storm: ef_err ~5e2).
    def equi_body(_, carry):
        A1, T, W, r1, r2, cx, cy = carry
        s1 = jnp.sqrt(jnp.maximum(
            jnp.max(jnp.abs(A1), axis=1, initial=0.0), 1e-30))
        s1 = jnp.where(s1 > 1e-12, s1, 1.0)
        s2 = jnp.sqrt(jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(T), axis=1, initial=0.0),
                        jnp.max(jnp.abs(W), axis=1, initial=0.0)), 1e-30))
        s2 = jnp.where(s2 > 1e-12, s2, 1.0)
        A1 = A1 / s1[:, None]
        T = T / s2[:, None]
        W = W / s2[:, None]
        gx = jnp.sqrt(jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(A1), axis=0, initial=0.0),
                        jnp.max(jnp.abs(T), axis=0, initial=0.0)), 1e-30))
        gx = jnp.where(gx > 1e-12, gx, 1.0)
        gy = jnp.sqrt(jnp.maximum(
            jnp.max(jnp.abs(W), axis=0, initial=0.0), 1e-30))
        gy = jnp.where(gy > 1e-12, gy, 1.0)
        A1 = A1 / gx[None, :]
        T = T / gx[None, :]
        W = W / gy[None, :]
        return A1, T, W, r1 / s1, r2 / s2, cx / gx, cy / gy

    A1e, Te, We, r1, r2, cx, cy = jax.lax.fori_loop(
        0, 8, equi_body,
        (arrays.A1, arrays.T, arrays.W,
         jnp.ones((m1,), dtype), jnp.ones((m2,), dtype),
         jnp.ones((n1,), dtype), jnp.ones((n2,), dtype)))
    arrays = dataclasses.replace(
        arrays, A1=A1e, T=Te, W=We,
        c=arrays.c * cx, q=arrays.q * cy,
        b1=arrays.b1 * r1, r=arrays.r * r2,
        lb1=arrays.lb1 / cx, ub1=arrays.ub1 / cx,
        lb2=arrays.lb2 / cy, ub2=arrays.ub2 / cy)

    f1, A1f = _flip(arrays.senses1, arrays.A1, dtype)
    f2, Wf = _flip(arrays.senses2, arrays.W, dtype)
    _, Tf = _flip(arrays.senses2, arrays.T, dtype)
    eq1 = arrays.senses1 == SENSE_E
    eq2 = arrays.senses2 == SENSE_E

    # --- sqrt(p_s) symmetric block scaling. The EF's scenario objective
    # q_s is p_s-weighted while its constraint blocks are O(1), so in the
    # raw formulation the y-blocks' gradient (and dual magnitudes) shrink
    # like 1/S while x's stay O(1): a single global primal weight cannot
    # balance both, and the per-step relative y progress decays like 1/S
    # (measured on storm: S=16 stalls at true objective error 1e-3 after
    # 40k iterations; S=64 was ~30% high at the reported floor). The
    # change of variables y~_s = sqrt(p_s) y_s with scenario rows scaled
    # by sqrt(p_s) keeps W SHARED across blocks (the sqrt cancels in
    # W y_s), scales T/rhs/bounds/objective per block by sqrt(p_s), and
    # makes the relative per-step progress S-independent.
    sp_s = jnp.sqrt(probs.astype(dtype))                              # [S]
    spc = sp_s[:, None]

    # per-scenario flipped rhs: f2 * (r + scatter(delta_r)); transfer-matrix
    # randomness patches Tf per scenario — supported via the effective-rhs
    # trick only for RHS positions; transfer positions contribute through
    # x-dependent terms handled below. Deltas pick up the row (and for
    # transfer entries, column) scaling.
    rhs_delta = jnp.where(model.rv_is_rhs[None, :], deltas, 0.0)      # [S, R]
    rhs_delta = rhs_delta * r2[model.rv_row][None, :]
    r_s = jnp.broadcast_to(arrays.r, (S, m2))
    r_s = r_s.at[:, model.rv_row].add(rhs_delta)
    h2 = r_s * f2[None, :] * spc                                      # [S, m2]
    b1f = arrays.b1 * f1

    # per-scenario transfer deltas (columns of T): dT[s] has entries
    # deltas[s,k] at (rv_row[k], rv_col[k]) for non-RHS, non-cost positions.
    # (all-zero when randomness is RHS-only, the shipped-instance fast path;
    # the scatter then costs one cheap no-op add)
    not_tr = jnp.logical_or(model.rv_is_rhs, model.rv_is_cost)
    tr_delta = jnp.where(not_tr[None, :], 0.0, deltas)                # [S, R]
    tr_delta = tr_delta * (r2[model.rv_row] * cx[model.rv_col])[None, :]

    def T_apply(x):
        """[S, m2] = sqrt(p_s) (Tf + dTf_s) x for all scenarios (scaled
        space)."""
        base = _dot(arrays.T, x)                                      # [m2]
        out = jnp.broadcast_to(base, (S, m2))
        contrib = tr_delta * x[model.rv_col][None, :]                 # [S, R]
        out = out.at[:, model.rv_row].add(contrib)
        return out * f2[None, :] * spc

    def Tt_apply(U):
        """[n1] = sum_s sqrt(p_s) (Tf + dTf_s)' U_s."""
        Uf = U * f2[None, :] * spc
        out = _dot(arrays.T.T, jnp.sum(Uf, axis=0))
        contrib = tr_delta * Uf[:, model.rv_row]                      # [S, R]
        out = out.at[model.rv_col].add(jnp.sum(contrib, axis=0))
        return out

    # spectral norm of the structured operator by power iteration
    def K_apply(x, Y):
        return _dot(A1f, x), T_apply(x) + _dot(Y, Wf.T)

    def Kt_apply(u0, U):
        return (_dot(A1f.T, u0) + Tt_apply(U), _dot(U, Wf))

    def power_body(_, carry):
        x, Y = carry
        u0, U = K_apply(x, Y)
        x, Y = Kt_apply(u0, U)
        nrm = jnp.sqrt(jnp.sum(x * x) + jnp.sum(Y * Y))
        return x / jnp.maximum(nrm, 1e-30), Y / jnp.maximum(nrm, 1e-30)

    # NOTE: fresh names — x0/Y0 are the caller's warm-start parameters
    xp = jnp.cos(jnp.arange(n1, dtype=dtype) * 0.7 + 0.3)
    Yp = jnp.cos(jnp.arange(S * n2, dtype=dtype) * 0.3 + 0.1).reshape(S, n2)
    xv, Yv = jax.lax.fori_loop(0, 48, power_body, (xp, Yp))
    u0, U = K_apply(xv, Yv)
    Kt_x, Kt_Y = Kt_apply(u0, U)
    norm = jnp.sqrt(jnp.sqrt(jnp.sum(Kt_x ** 2) + jnp.sum(Kt_Y ** 2)))
    eta = 0.9 / jnp.maximum(norm, 1e-30)

    lb1 = jnp.where(jnp.isfinite(arrays.lb1), arrays.lb1, -_BIG)
    ub1 = jnp.where(jnp.isfinite(arrays.ub1), arrays.ub1, _BIG)
    lb2 = jnp.where(jnp.isfinite(arrays.lb2), arrays.lb2, -_BIG)
    ub2 = jnp.where(jnp.isfinite(arrays.ub2), arrays.ub2, _BIG)
    # y~-space box: sqrt(p_s)-scaled per scenario
    lb2Y = lb2[None, :] * spc                                 # [S, n2]
    ub2Y = ub2[None, :] * spc

    # per-scenario objective: random COST deltas (reference TODO 6) patch
    # q_s = q + scatter(cost deltas); the deltas pick up the objective
    # normalization (1/obj_s) and the column equilibration (cy) the shared
    # q went through above
    cost_delta = jnp.where(model.rv_is_cost[None, :], deltas, 0.0)    # [S, R]
    cost_delta = cost_delta * (cy[model.rv_ycol] / obj_s)[None, :]
    q_s = jnp.broadcast_to(arrays.q, (S, n2)).at[:, model.rv_ycol].add(
        cost_delta)
    # p_s q_s in y-units becomes sqrt(p_s) q_s in y~-units
    qS = spc * q_s                                                    # [S, n2]

    # PDLP primal-weight initialization (||objective|| / ||rhs||): keeps
    # the primal/dual step balance scale-free — a fixed omega=1 with the
    # normalized objective stalls on storm (same failure as ops/pdhg.py).
    _qn = jnp.sqrt(jnp.sum(arrays.c ** 2) + jnp.sum(qS ** 2))
    _hn = jnp.sqrt(jnp.sum(b1f ** 2) + jnp.sum(h2 ** 2))
    omega_init = jnp.where(jnp.logical_and(_qn > 1e-30, _hn > 1e-30),
                           _qn / jnp.maximum(_hn, 1e-30),
                           jnp.ones((), dtype)).astype(dtype)

    def proj_dual(u0, U):
        u0 = jnp.where(eq1, u0, jnp.maximum(u0, 0.0))
        U = jnp.where(eq2[None, :], U, jnp.maximum(U, 0.0))
        return u0, U

    def pd_round(carry, omega):
        x, Y, u0, U = carry
        tau = eta / omega
        sig = eta * omega

        def body(_, c):
            x, Y, u0, U, xs, Ys, us, Us = c
            gx, gY = Kt_apply(u0, U)
            x1 = jnp.clip(x - tau * (arrays.c - gx), lb1, ub1)
            Y1 = jnp.clip(Y - tau * (qS - gY), lb2Y, ub2Y)
            kx, kY = K_apply(2.0 * x1 - x, 2.0 * Y1 - Y)
            u01, U1 = proj_dual(u0 + sig * (b1f - kx), U + sig * (h2 - kY))
            return (x1, Y1, u01, U1, xs + x1, Ys + Y1, us + u01, Us + U1)

        z = jnp.zeros
        init = (x, Y, u0, U, z(x.shape, dtype), z(Y.shape, dtype),
                z(u0.shape, dtype), z(U.shape, dtype))
        out = jax.lax.fori_loop(0, config.restart_every, body, init)
        x, Y, u0, U = out[:4]
        cnt = jnp.asarray(config.restart_every, dtype)
        return (x, Y, u0, U), tuple(a / cnt for a in out[4:])

    def residual(x, Y, u0, U):
        kx, kY = K_apply(x, Y)
        p1 = jnp.where(eq1, jnp.abs(b1f - kx), jnp.maximum(b1f - kx, 0.0))
        p2 = jnp.where(eq2[None, :], jnp.abs(h2 - kY),
                       jnp.maximum(h2 - kY, 0.0))
        scale = 1.0 + jnp.sqrt(jnp.sum(b1f ** 2) + jnp.sum(h2 ** 2))
        pres = jnp.sqrt(jnp.sum(p1 ** 2) + jnp.sum(p2 ** 2)) / scale
        gx, gY = Kt_apply(u0, U)
        gx = arrays.c - gx
        gY = qS - gY
        dv_x = (jnp.where(~jnp.isfinite(arrays.ub1), jnp.maximum(-gx, 0), 0)
                + jnp.where(~jnp.isfinite(arrays.lb1), jnp.maximum(gx, 0), 0))
        dv_Y = (jnp.where(~jnp.isfinite(arrays.ub2)[None, :],
                          jnp.maximum(-gY, 0), 0)
                + jnp.where(~jnp.isfinite(arrays.lb2)[None, :],
                            jnp.maximum(gY, 0), 0))
        qscale = 1.0 + jnp.sqrt(jnp.sum(arrays.c ** 2) + jnp.sum(qS ** 2))
        dres = jnp.sqrt(jnp.sum(dv_x ** 2) + jnp.sum(dv_Y ** 2)) / qscale
        pobj = _dot(arrays.c, x) + jnp.sum(qS * Y)
        dobj = (jnp.sum(u0 * b1f) + jnp.sum(U * h2)
                + jnp.sum(jnp.maximum(gx, 0) * jnp.where(
                    jnp.isfinite(arrays.lb1), arrays.lb1, 0.0))
                - jnp.sum(jnp.maximum(-gx, 0) * jnp.where(
                    jnp.isfinite(arrays.ub1), arrays.ub1, 0.0))
                + jnp.sum(jnp.maximum(gY, 0) * jnp.where(
                    jnp.isfinite(arrays.lb2), arrays.lb2, 0.0)[None, :]
                    * spc)
                - jnp.sum(jnp.maximum(-gY, 0) * jnp.where(
                    jnp.isfinite(arrays.ub2), arrays.ub2, 0.0)[None, :]
                    * spc))
        gap = jnp.abs(pobj - dobj) / (1.0 + jnp.abs(pobj) + jnp.abs(dobj))
        return jnp.maximum(jnp.maximum(pres, dres), gap), pobj

    n_rounds = max(1, config.max_iters // config.restart_every)

    def cond(c):
        return jnp.logical_and(c[-2] < n_rounds, c[-1] > config.tol)

    def round_step(c):
        (x, Y, u0, U, xb, Yb, Ub, ub0, omega, err_r, err_last, it,
         err_best) = c
        (x1, Y1, u01, U1), (xa, Ya, ua, Ua) = pd_round((x, Y, u0, U), omega)
        ec, _ = residual(x1, Y1, u01, U1)
        ea, _ = residual(xa, Ya, ua, Ua)
        use_avg = ea < ec
        xc = jnp.where(use_avg, xa, x1)
        Yc = jnp.where(use_avg, Ya, Y1)
        uc = jnp.where(use_avg, ua, u01)
        Uc = jnp.where(use_avg, Ua, U1)
        err = jnp.minimum(ea, ec)
        better = err < err_best
        xb = jnp.where(better, xc, xb)
        Yb = jnp.where(better, Yc, Yb)
        Ub = jnp.where(better, Uc, Ub)
        ub0 = jnp.where(better, uc, ub0)
        err_best = jnp.minimum(err, err_best)
        restart = jnp.logical_or(err <= 0.2 * err_r,
                                 jnp.logical_and(err <= 0.8 * err_r,
                                                 err > err_last))
        dprim = jnp.sqrt(jnp.sum((xc - x) ** 2) + jnp.sum((Yc - Y) ** 2))
        ddual = jnp.sqrt(jnp.sum((uc - u0) ** 2) + jnp.sum((Uc - U) ** 2))
        omega_new = jnp.where(
            jnp.logical_and(dprim > 1e-12, ddual > 1e-12),
            jnp.clip(jnp.exp(0.5 * jnp.log(ddual / dprim)
                             + 0.5 * jnp.log(omega)),
                     omega_init * 1e-4, omega_init * 1e4),
            omega)
        x = jnp.where(restart, xc, x1)
        Y = jnp.where(restart, Yc, Y1)
        u0 = jnp.where(restart, uc, u01)
        U = jnp.where(restart, Uc, U1)
        omega = jnp.where(restart, omega_new, omega)
        err_r = jnp.where(restart, err, err_r)
        return (x, Y, u0, U, xb, Yb, Ub, ub0, omega, err_r, err, it + 1,
                err_best)

    if x0 is None:
        xi = jnp.clip(jnp.zeros((n1,), dtype), lb1, ub1)
    else:
        xi = jnp.clip(x0.astype(dtype) / cx, lb1, ub1)
    if Y0 is None:
        Yi = jnp.clip(jnp.zeros((S, n2), dtype), lb2Y, ub2Y)
    else:
        Yi = jnp.clip(Y0.astype(dtype) / cy[None, :] * spc, lb2Y, ub2Y)
    if U0 is None:
        Ui = jnp.zeros((S, m2), dtype)
    else:
        # invert the dual unscaling below (duals = Ub * r2 * f2 * sp * obj_s)
        Ui = proj_dual(jnp.zeros((m1,), dtype),
                       U0.astype(dtype) * f2[None, :]
                       / (r2[None, :] * obj_s * spc))[1]
    if u00 is None:
        u0i = jnp.zeros((m1,), dtype)
    else:
        u0i = proj_dual(u00.astype(dtype) * f1 / (r1 * obj_s), Ui)[0]
    inf = jnp.asarray(jnp.inf, dtype)
    # chained warm restarts (solve_extensive_form_chunked) carry the
    # adapted primal weight as the STARTING omega, but the adaptation
    # clip stays anchored at the norm-based omega_init: re-anchoring the
    # clip at the carried value lets omega drift geometrically downward
    # across chunks (measured 9e-5 -> 2e-9 over 8 chunks, stalling the
    # solve), while a fixed anchor lets it recover.
    omega_start = (omega0.astype(dtype) if omega0 is not None
                   else omega_init)
    err0, _ = residual(xi, Yi, u0i, Ui)
    # best-iterate tracking starts AT the initial point (not at inf with
    # a zero dual): a chunk whose first rounds blow up — tiny carried
    # omega, unbalanced steps — must never return worse than its warm
    # start.
    c0 = (xi, Yi, u0i, Ui,
          xi, Yi, Ui, u0i, omega_start, err0, err0,
          jnp.zeros((), jnp.int32), err0)
    out = jax.lax.while_loop(cond, round_step, c0)
    (x, Y, u0, U, xb, Yb, Ub, ub0, omega, err_r, err_last, rounds,
     err_best) = out

    obj = (_dot(arrays.c, xb) + jnp.sum(qS * Yb)) * obj_s
    stats = {"ef_iters": rounds * config.restart_every,
             "ef_err": err_best,
             "ef_err0": err0,
             "ef_omega": omega,
             "ef_converged": err_best <= config.tol}
    # xb lives in column-scaled space; undo for the caller
    if return_duals:
        # scenario-row duals back to original rows/objective: the rows
        # were scaled by r2, sense-flipped by f2, and sqrt(p_s)-block-
        # scaled; the objective by 1/obj_s — same unscale pattern as
        # ops/pdhg.py (Pi_out = L * row_scale * flip); the y blocks undo
        # the column AND sqrt(p_s) scaling
        duals = Ub * (r2 * f2)[None, :] * obj_s * spc
        return (cx * xb, obj, stats, duals, cy[None, :] * Yb / spc,
                ub0 * (r1 * f1) * obj_s)
    return cx * xb, obj, stats


def solve_extensive_form_chunked(arrays, model, deltas, probs,
                                 config: PDHGConfig = PDHGConfig(),
                                 chunk_iters: int = 16_384,
                                 vmapped: bool = False,
                                 x0=None, Y0=None, U0=None, u00=None):
    """Extensive-form solve as a chain of warm-started shorter solves.

    A single EF program at full ``max_iters`` can run for many minutes
    without a convergence check (a while_loop's stopping test sees only
    its own tolerance). This driver bounds the length of one device
    program: each chunk runs at most
    ``chunk_iters`` PDHG iterations and hands its (x, Y, duals, u0) to
    the next via the warm-start path; convergence is checked on the host
    between chunks. Always returns duals.

    ``vmapped=True`` treats the leading axis of ``deltas`` as a
    replication batch (the certified-bound fleet) — probs shared.
    """
    import dataclasses as _dcl

    import numpy as _np

    total = 0
    om = None
    out = None
    while total < config.max_iters:
        step = min(chunk_iters, config.max_iters - total)
        cfg = _dcl.replace(config, max_iters=step)
        if vmapped:
            names = ("x0", "Y0", "U0", "u00", "omega0")
            warm = [w for w in (x0, Y0, U0, u00, om) if w is not None]
            wnames = [n for n, w in zip(names, (x0, Y0, U0, u00, om))
                      if w is not None]
            fn = jax.vmap(lambda d, *w: solve_extensive_form(
                arrays, model, d, probs, cfg, return_duals=True,
                **dict(zip(wnames, w))))
            out = fn(deltas, *warm)
        else:
            out = solve_extensive_form(
                arrays, model, deltas, probs, cfg, return_duals=True,
                x0=x0, Y0=Y0, U0=U0, u00=u00, omega0=om)
        x0, obj, stats, U0, Y0, u00 = out
        om = stats["ef_omega"]
        total += step
        err = _np.max(_np.asarray(stats["ef_err"]))
        if err <= config.tol:
            break
    return out


def crash_x0(inst: Instance, n_scenarios: int = 10, seed: int = 0,
             config: Optional[PDHGConfig] = None):
    """Sampled-extensive-form starting point (the reference driver's crash
    pattern, sd_single_cut_test.jl:42-46: 10 sampled scenarios, solve,
    take x)."""
    config = config or PDHGConfig(tol=1e-6, max_iters=40_000)
    key = jax.random.PRNGKey(seed)
    deltas = sample_deltas(key, inst.scenario_model, n_scenarios)
    probs = jnp.full((n_scenarios,), 1.0 / n_scenarios,
                     inst.arrays.c.dtype)
    x, obj, stats = solve_extensive_form(
        inst.arrays, inst.scenario_model, deltas, probs, config)
    return x, obj, stats
