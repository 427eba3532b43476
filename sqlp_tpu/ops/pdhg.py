"""Batched first-order LP solver (restarted PDHG, PDLP-style).

This kernel replaces the reference's per-scenario external LP solver
round-trips (JuMP -> MOI -> GLPK/CPLEX, ``solve_problem!``,
src/smps/smps_routines.jl:50-62) — the bottleneck the reference itself
flags (readme.md:15-16). A whole batch of second-stage recourse LPs

    min q @ y   s.t.  W y {>=,<=,==} h_b,   lb <= y <= ub        (b = 1..B)

shares the matrix W and differs only in the right-hand side ``h_b``
(= r - T x + scenario delta; all shipped instances have RHS-only
randomness, SURVEY.md quirk 7). The solver therefore:

  * prepares W once: sense-flip '<=' rows to '>=', Ruiz-equilibrate,
    estimate the spectral norm by power iteration (``prepare_lp``);
  * runs one batched PDHG recursion over the whole panel where every
    operator application is one [B, n] x [n, m] matmul (``solve_batch``);
  * restarts to the Polyak average every ``restart_every`` steps and
    adapts the primal weight omega, following PDLP's restart scheme;
  * returns objectives, primal solutions, and row duals in the JuMP
    d(obj)/d(rhs) sign convention ('>=' rows >= 0, '<=' rows <= 0) that
    the reference's cut math is written against (beta = -T' pi,
    test/sgd_example.jl:28).

Everything is shape-static and jit/vmap/shard_map friendly; the batch axis
can be sharded over the device mesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from sqlp_tpu.config import PDHGConfig
from sqlp_tpu.models.stage import SENSE_E, SENSE_L

_BIG = 1e30  # stand-in for +inf inside where-masks (keeps grads/NaNs away)

# Reduced-precision f32 matmuls (bfloat16 passes, or TF32 on the GPU's
# tensor cores) keep ~8-10 mantissa bits, which caps PDHG at ~5e-3 KKT
# residuals and defeats early termination. HIGHEST forces full-f32
# products.
_PREC = jax.lax.Precision.HIGHEST


def _dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.matmul(a, b, precision=_PREC)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PreparedLP:
    """A stage LP preprocessed for batched PDHG.

    The internal problem is over scaled variables yt = y / col_scale with
    rows flipped so every inequality reads '>='::

        min (q*col_scale) @ yt
        s.t. K yt >= / == row_scale*flip*h,   lb/col_scale <= yt <= ub/col_scale

    where K = diag(row_scale) (flip * W) diag(col_scale).
    """

    K: jax.Array           # [m, n] scaled constraint matrix
    q: jax.Array           # [n] scaled objective
    lb: jax.Array          # [n] scaled lower bounds (may be -inf)
    ub: jax.Array          # [n] scaled upper bounds (may be +inf)
    is_eq: jax.Array       # [m] bool, '==' rows (dual free)
    flip: jax.Array        # [m] +-1 ('-1' marks original '<=' rows)
    row_scale: jax.Array   # [m]
    col_scale: jax.Array   # [n]
    step: jax.Array        # scalar: eta = 0.9 / ||K||_2

    @property
    def m(self) -> int:
        return self.K.shape[0]

    @property
    def n(self) -> int:
        return self.K.shape[1]


def _ruiz_equilibrate(K: jax.Array, iters: int) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Ruiz scaling: iteratively divide rows/cols by sqrt of their inf-norm."""
    m, n = K.shape
    dr = jnp.ones((m,), K.dtype)
    dc = jnp.ones((n,), K.dtype)

    def body(_, carry):
        K, dr, dc = carry
        r = jnp.sqrt(jnp.max(jnp.abs(K), axis=1))
        r = jnp.where(r > 0, r, 1.0)
        K = K / r[:, None]
        c = jnp.sqrt(jnp.max(jnp.abs(K), axis=0))
        c = jnp.where(c > 0, c, 1.0)
        K = K / c[None, :]
        return K, dr / r, dc / c

    K, dr, dc = jax.lax.fori_loop(0, iters, body, (K, dr, dc))
    return K, dr, dc


def _power_iteration(K: jax.Array, iters: int = 64) -> jax.Array:
    """Estimate ||K||_2 by power iteration on K^T K (deterministic start)."""
    n = K.shape[1]
    # Deterministic, generically non-orthogonal start vector.
    v = jnp.cos(jnp.arange(n, dtype=K.dtype) * 0.7 + 0.3)
    v = v / jnp.linalg.norm(v)

    def body(_, v):
        w = _dot(K.T, _dot(K, v))
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = jax.lax.fori_loop(0, iters, body, v)
    return jnp.sqrt(jnp.maximum(jnp.linalg.norm(_dot(K.T, _dot(K, v))), 1e-30))


@partial(jax.jit, static_argnames=("ruiz_iters",))
def prepare_lp(W: jax.Array, senses: jax.Array, q: jax.Array,
               lb: jax.Array, ub: jax.Array, ruiz_iters: int = 10) -> PreparedLP:
    """Preprocess a stage LP for batched solving (once per instance)."""
    dtype = W.dtype
    flip = jnp.where(senses == SENSE_L, -1.0, 1.0).astype(dtype)
    is_eq = senses == SENSE_E
    K0 = flip[:, None] * W
    K, dr, dc = _ruiz_equilibrate(K0, ruiz_iters)
    norm = _power_iteration(K)
    return PreparedLP(
        K=K,
        q=q * dc,
        lb=lb / dc,
        ub=ub / dc,
        is_eq=is_eq,
        flip=flip,
        row_scale=dr,
        col_scale=dc,
        step=(0.9 / norm).astype(dtype),
    )


def _project_dual(lam: jax.Array, is_eq: jax.Array) -> jax.Array:
    """Duals of '>=' rows live in R+; '==' rows are free."""
    return jnp.where(is_eq[None, :], lam, jnp.maximum(lam, 0.0))


def _kkt_residuals(lp: PreparedLP, ht: jax.Array, Y: jax.Array, L: jax.Array,
                   Qs: Optional[jax.Array] = None):
    """Relative primal/dual/gap residuals of a batch of iterates.

    ht: [B, m] scaled rhs; Y: [B, n]; L: [B, m]; Qs: optional [B, n]
    per-element scaled objective (random-cost instances) instead of the
    shared lp.q.
    Returns (err, pobj) where err is the max of the three relative
    residuals per batch element.
    """
    qm = lp.q[None, :] if Qs is None else Qs
    KY = _dot(Y, lp.K.T)                  # [B, m]
    slack = ht - KY
    pviol = jnp.where(lp.is_eq[None, :], jnp.abs(slack), jnp.maximum(slack, 0.0))
    pres = jnp.linalg.norm(pviol, axis=-1) / (1.0 + jnp.linalg.norm(ht, axis=-1))

    g = qm - _dot(L, lp.K)                # [B, n] reduced costs
    # Bound multipliers absorb any sign of g at finite bounds; violation
    # only where the corresponding bound is infinite.
    lo_inf = ~jnp.isfinite(lp.lb)
    hi_inf = ~jnp.isfinite(lp.ub)
    dviol = (jnp.where(hi_inf[None, :], jnp.maximum(-g, 0.0), 0.0)
             + jnp.where(lo_inf[None, :], jnp.maximum(g, 0.0), 0.0))
    qn = jnp.linalg.norm(lp.q) if Qs is None \
        else jnp.linalg.norm(Qs, axis=-1)
    dres = jnp.linalg.norm(dviol, axis=-1) / (1.0 + qn)

    # shared-q path keeps the original matmul so trajectories stay
    # bitwise identical to the pre-random-cost kernel
    pobj = _dot(Y, lp.q) if Qs is None \
        else jnp.sum(Y * Qs, axis=-1)     # [B]
    gpos = jnp.maximum(g, 0.0)
    gneg = jnp.maximum(-g, 0.0)
    lb_term = jnp.where(lo_inf, 0.0, jnp.where(jnp.isfinite(lp.lb), lp.lb, 0.0))
    ub_term = jnp.where(hi_inf, 0.0, jnp.where(jnp.isfinite(lp.ub), lp.ub, 0.0))
    dobj = (jnp.sum(L * ht, axis=-1)
            + _dot(gpos, lb_term) - _dot(gneg, ub_term))
    gap = jnp.abs(pobj - dobj) / (1.0 + jnp.abs(pobj) + jnp.abs(dobj))

    err = jnp.maximum(jnp.maximum(pres, dres), gap)
    # pin the carry dtype: under an x64-enabled runtime some reductions
    # promote to f64, which breaks while_loop carry typing
    return err.astype(lp.K.dtype), pobj.astype(lp.K.dtype)


@partial(jax.jit, static_argnames=("config",))
def solve_batch(lp: PreparedLP, H: jax.Array, config: PDHGConfig = PDHGConfig(),
                Y0: Optional[jax.Array] = None, L0: Optional[jax.Array] = None,
                Q: Optional[jax.Array] = None
                ) -> Tuple[jax.Array, jax.Array, jax.Array, dict]:
    """Solve the LP for a panel of right-hand sides.

    Args:
      lp: prepared stage LP.
      H: [B, m] raw right-hand sides in the *original* row senses.
      config: PDHG parameters (static).
      Y0, L0: optional warm starts in ORIGINAL units (e.g. the previous SD
        iteration's subproblem solutions — x moves slowly under the prox
        term, so the old optimum is a near-feasible start).
      Q: optional [B, n] PER-ELEMENT objective in original units —
        random-cost instances (reference TODO 6), where every scenario LP
        carries its own q_s. Overrides lp.q.

    Returns:
      (obj [B], Y [B, n], Pi [B, m], stats) — Pi in the JuMP d(obj)/d(rhs)
      convention on the original rows; obj/Y/Pi are unscaled.
    """
    B, m = H.shape
    n = lp.n
    dtype = lp.K.dtype
    # under an x64-enabled runtime callers easily produce f64 panels
    # (e.g. jnp.zeros defaults to f64); the kernel dtype is lp's
    H = H.astype(dtype)
    if Q is not None:
        Q = Q.astype(dtype)

    ht = H * (lp.flip * lp.row_scale)[None, :]          # scaled, flipped rhs

    lb = jnp.where(jnp.isfinite(lp.lb), lp.lb, -_BIG)
    ub = jnp.where(jnp.isfinite(lp.ub), lp.ub, _BIG)

    eta = lp.step
    n_rounds = max(1, config.max_iters // config.restart_every)

    halpern = config.scheme == "halpern"

    def pd_round(el):
        """restart_every PDHG steps on one element-state dict.

        omega is per batch element: each scenario LP carries its own
        primal weight (tau = eta/omega, sigma = eta*omega elementwise).

        Returns (Ycarry, Lcarry, candidates) where candidates is a list of
        feasible (Y, L) iterates to consider for restart:
          "average"  — [(last, ), (running average, )] (PDLP);
          "halpern"  — [(T(z), )]: reflected Halpern anchoring (r2HPDHG),
            z_{k+1} = (k+1)/(k+2) (2 T(z_k) - z_k) + 1/(k+2) z_anchor;
            the raw carry z is unprojected, only T(z) is feasible.
        """
        Y, L, ht, omega = el["Y"], el["L"], el["ht"], el["omega"]
        # per-element scaled objective (random cost) or the shared one
        qrow = el["Q"] if "Q" in el else lp.q[None, :]
        tau = (eta / omega)[:, None]
        sig = (eta * omega)[:, None]

        if halpern:
            kh, Yanc, Lanc = el["kh"], el["Yanc"], el["Lanc"]
            def body(t, carry):
                Y, L, _, _ = carry
                G = qrow - _dot(L, lp.K)
                Y1 = jnp.clip(Y - tau * G, lb, ub)
                Yb = 2.0 * Y1 - Y
                S = ht - _dot(Yb, lp.K.T)
                L1 = _project_dual(L + sig * S, lp.is_eq)
                k = (kh + t)[:, None].astype(dtype)
                w = (k + 1.0) / (k + 2.0)
                Y2 = w * Yb + (1.0 - w) * Yanc        # Yb == 2 Y1 - Y
                L2 = w * (2.0 * L1 - L) + (1.0 - w) * Lanc
                return Y2, L2, Y1, L1

            Y, L, Yc, Lc = jax.lax.fori_loop(
                0, config.restart_every, body, (Y, L, Y, L))
            return Y, L, [(Yc, Lc)]

        def body(_, carry):
            Y, L, Ys, Ls, cnt = carry
            G = qrow - _dot(L, lp.K)                     # [B, n]
            Y1 = jnp.clip(Y - tau * G, lb, ub)
            S = ht - _dot(2.0 * Y1 - Y, lp.K.T)          # [B, m]
            L1 = _project_dual(L + sig * S, lp.is_eq)
            return Y1, L1, Ys + Y1, Ls + L1, cnt + 1.0

        init = (Y, L, jnp.zeros_like(Y), jnp.zeros_like(L), jnp.zeros((), dtype))
        Y, L, Ys, Ls, cnt = jax.lax.fori_loop(0, config.restart_every, body, init)
        return Y, L, [(Y, L), (Ys / cnt, Ls / cnt)]

    def round_step(el):
        """One restart round on a dict of per-element state."""
        Ycarry, Lcarry, cands = pd_round(el)
        Qs = el.get("Q")

        Yc, Lc = cands[0]
        err, _ = _kkt_residuals(lp, el["ht"], Yc, Lc, Qs)
        for Yo, Lo in cands[1:]:
            err_o, _ = _kkt_residuals(lp, el["ht"], Yo, Lo, Qs)
            use_o = err_o < err                          # [B]
            Yc = jnp.where(use_o[:, None], Yo, Yc)
            Lc = jnp.where(use_o[:, None], Lo, Lc)
            err = jnp.minimum(err_o, err)

        # Latch the best iterate seen so far per batch element.
        better = err < el["err_best"]
        Yb = jnp.where(better[:, None], Yc, el["Yb"])
        Lb = jnp.where(better[:, None], Lc, el["Lb"])
        # Stagnation: count rounds without a meaningful (>=3%) improvement
        # of the best error — an element at its numeric floor stops
        # consuming rounds toward an unattainable tol.
        meaningful = err < el["err_best"] * 0.97
        stall = jnp.where(meaningful, 0, el["stall"] + 1)
        err_best = jnp.minimum(err, el["err_best"])
        done = jnp.logical_or(err_best <= config.tol,
                              stall >= config.stall_rounds)

        # PDLP-style adaptive restart, PER BATCH ELEMENT: restart when the
        # candidate's KKT error improved sufficiently vs the last restart
        # (0.2x), or improved somewhat (0.8x) but began increasing again.
        # A fixed unconditional restart kills the asymptotic tail on
        # degenerate instances (observed: ssn stalls at ~4e-4 forever).
        restart = jnp.logical_or(
            err <= 0.2 * el["err_r"],
            jnp.logical_and(err <= 0.8 * el["err_r"], err > el["err_last"]))

        # Primal-weight update at restarts (PDLP), elementwise.
        dY = jnp.linalg.norm(Yc - el["Yr"], axis=-1)
        dL = jnp.linalg.norm(Lc - el["Lr"], axis=-1)
        theta = config.omega_smoothing
        omega = el["omega"]
        omega_new = jnp.where(
            jnp.logical_and(dY > 1e-12, dL > 1e-12),
            jnp.exp(theta * jnp.log(dL / jnp.maximum(dY, 1e-30))
                    + (1.0 - theta) * jnp.log(omega)),
            omega)
        # clip RELATIVE to the data-derived initial weight, not to 1.0
        omega_new = jnp.clip(omega_new, el["olo"], el["ohi"])

        r = restart[:, None]
        out = dict(
            el,
            Y=jnp.where(r, Yc, Ycarry), L=jnp.where(r, Lc, Lcarry),
            Yr=jnp.where(r, Yc, el["Yr"]), Lr=jnp.where(r, Lc, el["Lr"]),
            Yb=Yb, Lb=Lb,
            omega=jnp.where(restart, omega_new, omega),
            err_r=jnp.where(restart, err, el["err_r"]),
            err_last=err, err_best=err_best, done=done, stall=stall)
        if halpern:
            # anchor reset + step counter per element: a restarted element
            # re-anchors at its candidate, others keep accumulating k
            out["kh"] = jnp.where(restart, 0.0,
                                  el["kh"] + config.restart_every)
            out["Yanc"] = jnp.where(r, Yc, el["Yanc"])
            out["Lanc"] = jnp.where(r, Lc, el["Lanc"])
        return out

    if Y0 is None:
        Yi = jnp.clip(jnp.zeros((B, n), dtype), lb, ub)
    else:
        Yi = jnp.clip(Y0 / lp.col_scale[None, :], lb, ub)
    if L0 is None:
        Li = jnp.zeros((B, m), dtype)
    else:
        Li = _project_dual(L0 / (lp.row_scale * lp.flip)[None, :], lp.is_eq)
    # PDLP primal-weight initialization: omega ~ ||q|| / ||h|| balances the
    # primal and dual step scales regardless of objective scaling (a
    # normalized objective q/s with omega=1 was observed to stall PDHG on
    # storm at err~1e-1; the fixed [1e-4,1e4] clip around 1.0 could not
    # reach the required balance).
    Qs = None if Q is None else Q * lp.col_scale[None, :]
    qn = jnp.linalg.norm(lp.q) if Qs is None \
        else jnp.linalg.norm(Qs, axis=-1)
    hn = jnp.linalg.norm(ht, axis=-1)
    omega_init = jnp.where(jnp.logical_and(qn > 1e-30, hn > 1e-30),
                           qn / jnp.maximum(hn, 1e-30),
                           jnp.ones((B,), dtype)).astype(dtype)
    err0 = jnp.full((B,), jnp.inf, dtype)

    el = dict(
        ht=ht, Y=Yi, L=Li, Yr=Yi, Lr=Li, Yb=Yi, Lb=Li,
        omega=omega_init, olo=omega_init * 1e-4, ohi=omega_init * 1e4,
        err_r=err0, err_last=err0, err_best=err0,
        done=jnp.zeros((B,), bool), stall=jnp.zeros((B,), jnp.int32),
        orig=jnp.arange(B, dtype=jnp.int32))
    if Qs is not None:
        # travels through the compaction ladder with its element
        el["Q"] = Qs
    if config.scheme == "halpern":
        el.update(kh=jnp.zeros((B,), dtype), Yanc=Yi, Lanc=Li)

    # Batch compaction ladder. PDHG convergence across a scenario panel is
    # heavily skewed (measured on ssn B=4096 tol 1e-4: 55% of elements done
    # by round 40, 95% by round 80, the last element at round 423), so the
    # tail burns full-batch rounds on a handful of stragglers. Run phases of
    # shrinking STATIC batch sizes: when the active count fits the next
    # rung, sort converged elements out (stable argsort on `done`) and
    # continue on the prefix; finished elements are scattered back through
    # `orig`. Every phase is shape-static; per-element state (iterates,
    # restarts, omega, rhs) travels with its element, so trajectories match
    # the uncompacted solver except that done elements stop iterating.
    sizes = [B]
    if config.compaction and B >= config.compact_min_batch:
        floor = 256
        while len(sizes) < 4:
            nxt = -(-max(floor, sizes[-1] // 4) // floor) * floor
            if nxt >= sizes[-1]:
                break
            sizes.append(nxt)

    it = jnp.zeros((), jnp.int32)
    phase_rounds = []
    for phase_i, size in enumerate(sizes):
        stop = sizes[phase_i + 1] if phase_i + 1 < len(sizes) else 0
        if size < el["done"].shape[0]:
            order = jnp.argsort(el["done"].astype(jnp.int32),
                                stable=True)[:size]
            sub = {k: v[order] for k, v in el.items()}
        else:
            sub = el

        def cond(carry, stop=stop):
            s, it = carry
            return jnp.logical_and(it < n_rounds,
                                   jnp.sum(~s["done"]) > stop)

        def body(carry):
            s, it = carry
            return round_step(s), it + 1

        sub, it = jax.lax.while_loop(cond, body, (sub, it))
        phase_rounds.append(it)
        if size < el["done"].shape[0]:
            el = {k: el[k].at[sub["orig"]].set(sub[k]) for k in el}
        else:
            el = sub
    rounds = it

    # Unscale back to the original problem.
    Yb = el["Yb"]
    Lb = el["Lb"]
    err = el["err_best"]
    done = el["done"]
    omega = el["omega"]
    Y_out = Yb * lp.col_scale[None, :]
    Pi_out = Lb * (lp.row_scale * lp.flip)[None, :]
    obj = _dot(Y_out, lp.q / lp.col_scale) if Q is None \
        else jnp.sum(Y_out * Q, axis=-1)

    stats = {
        "pdhg_rounds": rounds,
        # cumulative round count at each compaction-ladder phase boundary
        # (ladder sizes are static per compile; a single-phase solve
        # reports one entry equal to pdhg_rounds)
        "pdhg_phase_rounds": jnp.stack(phase_rounds),
        "pdhg_iters": rounds * config.restart_every,
        "pdhg_err_max": jnp.max(err),
        "pdhg_converged": jnp.all(err <= config.tol),
        "pdhg_omega": jnp.mean(omega),
        # per-element convergence: consumers must not trust duals of
        # unconverged elements (SD cut validity depends on epsilon-feasible
        # duals; a diverged element usually means an infeasible scenario LP)
        "pdhg_done": done,
        # epsilon-validity for cut generation: looser than `tol` so duals
        # at the f32 numeric floor still feed the dual pool (config.valid_tol)
        "pdhg_valid": err <= config.valid_tol,
        "pdhg_err": err,
    }
    return obj, Y_out, Pi_out, stats
