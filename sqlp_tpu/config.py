"""Solver configuration.

The reference scatters configuration across Julia module constants
(``CUT_REMOVE_TOLERANCE`` src/sd_algorithm/algorithm.jl:23,
``INCUMBENT_SELECTION_Q`` src/sd_algorithm/improvement.jl:1,
``SIGNIFICANT_DIGITS`` src/sd_algorithm/dual_set.jl:4), keyword arguments and
closure builders (src/sd_algorithm/quad_scalar.jl). Here everything lives in
one frozen dataclass so it can be closed over by the jitted step and hashed
as a static argument.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class PDHGConfig:
    """Batched first-order LP kernel parameters (subproblem solver)."""

    # Convergence tolerance on the scaled KKT residuals (primal feasibility,
    # dual feasibility, duality gap), relative.
    tol: float = 1e-7
    # Duals with relative KKT error at or below this are epsilon-valid for
    # cut generation / dual-pool admission even when `tol` (the early-exit
    # target) was not reached: a 1e-4-feasible dual still yields a
    # valid-to-tolerance cut, while rejecting it starves the dual pool
    # (observed on storm, where f32 residuals floor near 1e-5 and the pool
    # froze at 2 vertices for 300 iterations).
    valid_tol: float = 1e-4
    # Give up on a batch element once err_best has not improved by >=3%
    # over this many consecutive restart rounds — it has hit its numeric
    # floor and further iterations only burn max_iters.
    stall_rounds: int = 50
    # Inner steps between restarts-to-average.
    restart_every: int = 80
    # Maximum total PDHG iterations per solve.
    max_iters: int = 20_000
    # Primal-weight (omega) adaptation smoothing in [0, 1]; 0 disables.
    omega_smoothing: float = 0.5
    # Ruiz equilibration sweeps applied to W at instance-compile time.
    ruiz_iters: int = 10
    # Batch compaction: convergence across a scenario panel is heavily
    # skewed (ssn B=4096: 95% of LPs done by round 80, the last at 423), so
    # once the active count fits a smaller static batch, sort converged
    # elements out and run the tail on the prefix (ops/pdhg.py ladder).
    compaction: bool = True
    # Smallest batch for which the ladder is built; below this a single
    # full-size phase (the classic loop) runs.
    compact_min_batch: int = 2048
    # Candidate-iterate scheme inside a restart round:
    #   "average" — running Polyak average, restart-to-average (PDLP);
    #   "halpern" — reflected Halpern anchoring (r2HPDHG / cuPDLP+ style):
    #     z_{k+1} = (k+1)/(k+2) * (2 T(z_k) - z_k) + 1/(k+2) * z_anchor,
    #     anchor reset to the candidate at each restart. Typically needs
    #     2-3x fewer iterations than restart-to-average on LP panels.
    scheme: str = "halpern"


@dataclasses.dataclass(frozen=True)
class QPConfig:
    """Master proximal-QP (OSQP-style ADMM) parameters."""

    tol: float = 1e-8
    max_iters: int = 4_000
    check_every: int = 25
    sigma: float = 1e-6
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    over_relax: float = 1.6
    # Windowed stagnation cutoff: every `stall_rounds` check intervals the
    # best KKT error seen must have improved by >=3% over the previous
    # window, else the solve stops — the iterate is at its (dtype) numeric
    # floor and further ADMM rounds only burn max_iters (observed on ssn,
    # where the f32 floor ~2e-4 sits above the clamped tolerance and every
    # master solve ran the full 4000-iteration budget). Windowed rather
    # than consecutive-interval because rho adaptation makes the error
    # oscillate, and lucky dips reset a consecutive counter forever.
    # The GLOBAL defaults stay generous: accuracy-critical one-shot solves
    # (the captured compromise QPs, tests/data) creep below 3%/window and
    # need multiple rho kicks in both directions before giving up. The SD
    # master — where a floored-but-stationary iterate is tolerable because
    # the repair pipeline in sd_step closes residual violations — tightens
    # these to 3/1 via SDConfig's qp override (found on ssn/storm f32
    # masters: 3-round windows with a single probe restart cut mean ADMM
    # iterations ~2.8x with unchanged trajectories and the same converged
    # fraction).
    stall_rounds: int = 6
    # A stalled window first forces a rho rebalance/kick (plateaus are
    # usually rho stuck in the adaptation deadband — seen on the lands
    # compromise QP, which creeps at 1.6x tol for ~4000 iterations until a
    # rebalance unlocks it); only after this many fruitless restarts does
    # the solve give up. Each restart is cheap (best-iterate tracking keeps
    # the pre-kick point).
    stall_restarts: int = 4
    # A stall exit is only allowed when the best error is already within
    # this factor of the (dtype-clamped) tolerance: a true numeric floor
    # sits just above tol (ssn f32: 2e-4 vs 6e-5 = 3.3x; the lands
    # compromise QP creeps at 1.6x), while a stall an order of magnitude
    # out means the iterate is genuinely unfinished — exiting there hands
    # back an x whose KKT error the final polish cannot always close
    # (observed at factor 100 on the lands compromise QP, which exited at
    # 1e-5 against tol 1e-7 and failed). Those solves run their budget.
    stall_tol_factor: float = 10.0
    # Hard cap: after this many CONSECUTIVE non-improving windows, give up
    # regardless of how far the error is from tolerance. 0 disables. Off
    # by default because accuracy-critical one-shot solves (the lands
    # compromise QP) legitimately creep below 3%/window for thousands of
    # iterations before a gentle rho rebalance unlocks them; the SD
    # master enables it (see SDConfig) — a late-run ssn master in f32
    # floors at err ~3e-3, where near_tol blocks the stall exit and the
    # solve burns its full budget (plus the cold retry: 8000 iterations)
    # to return the same 3e-3 iterate a tenth of the budget reaches.
    stall_hard_windows: int = 0
    # Cold-restart fallback when a WARM-started solve misses tolerance
    # (a stale (z, mu) can trap ADMM for its whole budget; see the retry
    # block in solve_qp). Disable under vmap — jax.lax.cond lowers to a
    # select there, so every replication pays the full second ADMM loop
    # every master solve whether or not any needed it; the stall caps
    # and sd_step's feasibility guard/repairs backstop the rare trap
    # instead.
    warm_retry: bool = True
    # ... and only when the warm error is FAR from tolerance: the
    # observed stale-warm-start trap exits at err ~1e-2, while an f32
    # master at its numeric floor sits at a few times the clamped
    # tolerance (storm: 3.8e-4 vs eff_tol 6.1e-5) — there a cold rerun
    # reaches the same floor, and because every storm master floors, the
    # unconditional retry doubled the master cost of every SD iteration.
    # Retry only when err > warm_retry_factor * eff_tol.
    warm_retry_factor: float = 50.0


@dataclasses.dataclass(frozen=True)
class SDConfig:
    """Full SD solver configuration.

    Capacities are static shapes for the jitted step: scenario store, dual
    vertex pool and cut pools are fixed-size arrays with live counts/masks
    (the reference grows Julia vectors unboundedly; under XLA we pre-allocate
    and mask).
    """

    # --- algorithm constants (reference parity) ---
    # Cuts whose master dual multiplier is below this are pruned
    # (src/sd_algorithm/algorithm.jl:23,63).
    cut_remove_tolerance: float = 1e-3
    # Incumbent selection factor q (src/sd_algorithm/improvement.jl:1).
    incumbent_q: float = 0.2
    # Significant binary digits for dual-vertex dedup
    # (src/sd_algorithm/dual_set.jl:4).
    dual_sig_bits: int = 16
    # Per-iteration decay of the dual-vertex usage score (EMA of SASA
    # argmax win mass); at pool capacity the lowest-score vertex is
    # evicted. 1.0 would never forget, 0.0 keeps only the last iteration.
    dual_score_decay: float = 0.95

    # --- prox weight (quad scalar) schedule ---
    # "constant" or "adaptive" (src/sd_algorithm/quad_scalar.jl:4-76).
    quad_schedule: str = "constant"
    quad_scalar_init: float = 0.1
    quad_min: float = 1e-3
    quad_max: float = 1e4
    quad_r2: float = 0.95
    quad_r3: float = 2.0
    quad_tolerance: float = 1e-3

    # --- capacities (static shapes) ---
    max_scenarios: int = 4096    # per epigraph
    max_dual_vertices: int = 2048
    max_cuts: int = 96           # per epigraph, excluding the incumbent cut
    scenarios_per_iter: int = 1  # B; reference adds exactly 1 per epigraph

    # --- scenario sampling scheme for the SD stream ---
    # "iid" (the reference's rand(sto)), "antithetic" (u/1-u pairs; needs
    # even B, else falls back to iid), or "stratified" (Latin-hypercube
    # marginals across the B-batch). The variance-reduction methods the
    # reference lists as TODO 7 (readme.md:27), applied per iteration
    # batch; the MC evaluator takes its own method argument.
    sampling: str = "iid"

    # --- incumbent cut refresh (sd_iteration! kwarg, algorithm.jl:40) ---
    update_incumbent_cut: bool = True

    # --- periodic full-pool cut refresh ---
    # Every N iterations, rebuild every LIVE stored cut at its original
    # generating point (state.cut_x) against the CURRENT dual pool and
    # scenario store, resetting its weight_mark to the current total —
    # undoing the classic SD 1/N cut decay for the whole pool, not just
    # the incumbent cut (generalizes the reference's incumbent-only
    # regeneration, epigraph.jl:83). Refreshed cuts are ordinary SASA
    # cuts at the stored points, so validity is unchanged. Cost: one
    # batched argmax matmul sweep over the E*K stored points per refresh.
    # 0 disables (reference-parity default). The replicated path
    # rebuilds via lax.scan over the K cut slots (one build in the
    # graph, vmapped over R and E) — the fully-vmapped E*K rebuild
    # wedged the remote XLA compiler at flagship sizes (K=96, R=8, ssn).
    cut_refresh_every: int = 0

    # --- subproblem dual warm start ---
    # Warm-start each SD-step subproblem dual at the pool's argmax vertex
    # for its RHS instead of the previous iteration's dual. SD's core
    # premise is that optimal duals repeat across scenarios: once the
    # pool is populated, the argmax vertex is near-optimal for most new
    # draws (measured late-run ssn: ~35% fewer PDHG iterations over 10
    # scenario draws, winning 7/10; early-run it is neutral). Falls back
    # to the previous dual while the pool is empty.
    pool_dual_warm_start: bool = True

    # --- dual-vertex crossover (ops/crossover.py) ---
    # Round PDHG's epsilon-optimal (interior-ish) duals to basic dual
    # vertices before pool admission, recovering the cut sharpness of the
    # reference's exact simplex duals (smps_routines.jl:58-61). A rounded
    # dual is only accepted when it stays dual-feasible and does not lose
    # dual objective, so cuts can only tighten.
    dual_crossover: bool = True
    # Adaptive off-switch: after this many CONSECUTIVE iterations in which
    # the crossover accepted zero duals, stop running it (lax.cond skips
    # the batched [m2, m2] active-set solves — a large share of the storm
    # step, where f32 rounding never passes the dual-feasibility acceptance:
    # measured 0/96 accepted on storm vs 23-50% on lands/transship/ssn).
    # One acceptance resets the counter; once dry past the limit it stays
    # off (a pool that rejected 64 straight rounds will not start
    # accepting as duals get harder). 0 disables the gate.
    crossover_dry_limit: int = 64
    # Once the f32 acceptance runs dry, re-run the rounding in f64 on the
    # SD step's small panel instead of skipping it (VERDICT r3: on storm
    # the f32 test passes 0/96 duals and the gate just turns sharpening
    # off). The f64 active-set solves reach the 1e-6 dual-feasibility
    # acceptance where f32 floors. Costs an f64 [m2, m2] factorization
    # per sweep; off by default — enable per instance after an A/B
    # (RESULTS.md r4 records the storm quality numbers).
    crossover_f64_fallback: bool = False

    # --- numerics ---
    dtype: str = "float32"
    # Solve with objective coefficients normalized to O(1) (c, q divided by
    # max(1, max|c|, max|q|); prox weights rescaled to match). Fixes the
    # master's mixed-scale conditioning on instances like storm (|c| to
    # 4e5 drives cut coefficients to 1e7 against O(100) x bounds, beyond
    # what f32 ADMM can terminate on). All driver outputs are unscaled.
    normalize_objective: bool = True

    # --- nested kernel configs ---
    pdhg: PDHGConfig = dataclasses.field(default_factory=PDHGConfig)
    # Master QP defaults tighten the stall budgets and enable the hard
    # stall cap: the per-iteration master tolerates a floored-but-
    # stationary iterate (the repair pipeline in sd_step closes residual
    # primal violations), so burning the full ADMM budget on an
    # unreachable tolerance only costs time. One-shot accuracy-critical
    # QPs (compromise decisions) use the generous QPConfig() defaults.
    qp: QPConfig = dataclasses.field(
        default_factory=lambda: QPConfig(
            stall_rounds=3, stall_restarts=1, stall_hard_windows=10))

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)

    def replace(self, **kw) -> "SDConfig":
        return dataclasses.replace(self, **kw)


def _pow2ceil(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def autoscale_capacities(config: SDConfig, n_iters: int, n_epi: int = 1,
                         mesh_devices: int = 0) -> SDConfig:
    """Shrink pool capacities to what ``n_iters`` iterations can fill.

    The defaults (S=4096, D=2048) are flagship-sized; on small instances
    or short runs they dominate the per-iteration floor — the argmax
    scores a [D, S] panel and the dual-dedup compares against all D slots
    every step regardless of how many are live. A run of n_iters B-batch
    iterations stores at most n_iters*B scenarios per epigraph and pushes
    at most 2*E*B duals per iteration, so capacities beyond the next
    power of two above those counts are pure padding. Capacities only
    ever shrink (a user-set smaller value wins); pre-saturation
    trajectories are semantically unchanged (capacity only pads dead
    slots), identical up to floating-point reduction order — padding
    changes matmul tiling (measured on lands/256 iters: lb 376.03 vs
    376.00, 15.7 -> 37.5 it/s on CPU). The scenario capacity stays
    divisible by the mesh.
    """
    need_s = max(64, _pow2ceil(n_iters * config.scenarios_per_iter))
    if mesh_devices and mesh_devices > 1:
        need_s = max(need_s, _pow2ceil(mesh_devices))
        need_s += (-need_s) % mesh_devices
    need_d = max(64, _pow2ceil(2 * n_iters * config.scenarios_per_iter
                               * max(n_epi, 1)))
    return config.replace(
        max_scenarios=min(config.max_scenarios, need_s),
        max_dual_vertices=min(config.max_dual_vertices, need_d))
