"""Host-side SD driver: init, iterate, evaluate.

Plays the role of the reference's instance-driver scripts
(test/instance_test/sd_single_cut_test.jl:20-87, ssn_test.jl:24-62): read an
instance, build the cell/epigraphs, loop ``sd_iteration!``, periodically
estimate the Monte-Carlo upper bound. Those scripts are the reference's only
"API"; here the same pattern is a small class around the jitted step.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import warnings
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sqlp_tpu.utils.jaxsetup import configure_jax
from sqlp_tpu.config import SDConfig
from sqlp_tpu.models.instance import Instance, load_instance
from sqlp_tpu.models.routines import project_first_stage, recourse_lower_bound
from sqlp_tpu.ops.pdhg import prepare_lp, solve_batch
from sqlp_tpu.sd.algorithm import _scenario_rhs, sd_step
from sqlp_tpu.sd.state import EpigraphSpec, SDState, default_epigraph_spec, init_state
from sqlp_tpu.models.scenario import sample_deltas

try:
    from math import erfinv as _erfinv  # Python 3.13+ (not in 3.12)
except ImportError:
    from scipy.special import erfinv as _erfinv


class SDSolver:
    """Two-stage regularized SD solver on a compiled instance."""

    # stats keys expressed in (scaled) objective units — unscaled on read
    _OBJ_KEYS = ("cand_est", "inc_est", "req_improvement", "sub_obj_mean",
                 "rho")

    def __init__(self, inst: Instance, config: SDConfig = SDConfig(),
                 espec: Optional[EpigraphSpec] = None,
                 x0=None, seed: int = 0, n_epi: int = 1,
                 mesh_devices: int = 0, shard_duals: bool = False,
                 mesh_shape: Optional[tuple] = None,
                 proposal=None):
        """mesh_devices > 1 builds a 1-D device mesh and shards the
        scenario stores (and, with shard_duals, the dual-vertex pool)
        over it; 0/1 runs single-device. ``mesh_shape=(nd, ns)`` builds a
        2-D (duals x scenarios) mesh instead: the dual pool shards over
        nd devices and the scenario stores over ns (SURVEY §5.7's two
        growth axes each on their own mesh dimension). ``proposal`` (a
        ScenarioModel over the same positions, see
        models.instance.load_proposal) switches the scenario stream to
        on-device importance sampling: draws come from the proposal,
        weights are the exact density ratios. Multi-host setups
        must call jax.distributed.initialize()
        (sqlp_tpu.parallel.distributed) before constructing the solver."""
        configure_jax()
        self.inst = inst
        if inst.scenario_model.has_cost:
            # Random-cost instances (reference TODO 6): cut validity rests
            # on the universally feasible seed dual; without one SD cannot
            # certify its cuts (scenario._compute_seed_dual's warning).
            if not inst.scenario_model.seed_valid:
                raise ValueError(
                    f"instance {inst.name} has random cost coefficients "
                    f"with no universally feasible dual (unbounded support "
                    f"or unbounded recourse at the support-minimum cost); "
                    f"SD cut generation cannot be certified — use the "
                    f"extensive-form solver (cli: ef) instead")
            if config.dual_crossover:
                # the batched active-set crossover restores vertices of the
                # SHARED dual polytope; with per-scenario q it would need a
                # per-element feasibility system — skipped (sd_step gates
                # it off statically; mirror that in config so the stats
                # schema stays consistent)
                config = config.replace(dual_crossover=False)
            if config.normalize_objective:
                # objective normalization divides q by a scale, but the
                # scenario model's cost VALUES are in original units — a
                # scaled template plus unscaled deltas would corrupt every
                # q_s. Cost-random instances run unnormalized.
                config = config.replace(normalize_objective=False)
        # Valid per-scenario recourse lower bound (the reference takes this
        # as a trusted user constant; an invalid one silently corrupts every
        # decayed cut — see recourse_lower_bound's docstring).
        self.recourse_lb = recourse_lower_bound(inst.arrays,
                                                inst.scenario_model)
        if espec is None:
            lb_auto = self.recourse_lb if np.isfinite(self.recourse_lb) \
                else 0.0
            # E weighted epigraphs, each fed an independent scenario stream
            # with weight 1/E (the reference's multiple-weighted-epigraph
            # extension, readme.md:5-9 / bind_epigraph! cell.jl:99-116).
            espec = default_epigraph_spec(n_epi, 1.0 / n_epi, lb_auto,
                                          dtype=config.jdtype)
        elif np.isfinite(self.recourse_lb):
            bad = np.asarray(espec.lower_bound) > self.recourse_lb + 1e-9 * (
                1.0 + abs(self.recourse_lb))
            if bad.any():
                warnings.warn(
                    f"epigraph lower bound {np.asarray(espec.lower_bound)} "
                    f"exceeds the valid recourse bound "
                    f"{self.recourse_lb:.6g}; cuts blended with it are "
                    f"invalid and SD may converge to the wrong point")
        self.espec = espec

        # Objective normalization: run the whole algorithm in units of
        # cost/s. x is never scaled; every objective-unit output (estimates,
        # evaluations, rho) is rescaled by s at this driver boundary.
        s = 1.0
        if config.normalize_objective:
            s = float(max(1.0,
                          np.abs(np.asarray(inst.arrays.c)).max(initial=0.0),
                          np.abs(np.asarray(inst.arrays.q)).max(initial=0.0)))
        self.obj_scale = s
        arrays = inst.arrays
        if s != 1.0:
            arrays = dataclasses.replace(
                arrays, c=arrays.c / s, q=arrays.q / s)
            # the per-epigraph lower bound is in objective units too: it is
            # blended into every cut as (1-d)*lb (epigraph.jl:105-106), so
            # leaving it unscaled poisons all cut values (observed on
            # baa99-20 with the reference driver's lb=-500000)
            self.espec = dataclasses.replace(
                self.espec, lower_bound=self.espec.lower_bound / s)
            config = config.replace(
                quad_scalar_init=config.quad_scalar_init / s,
                quad_min=config.quad_min / s,
                quad_max=config.quad_max / s,
                # master duals are d(obj)/d(rhs): objective units too —
                # an unscaled prune threshold would prune every cut
                cut_remove_tolerance=config.cut_remove_tolerance / s)
        self.arrays = arrays
        # pre-replication copies: evaluation panels are built eagerly on
        # the host and must not mix process-local arrays with globally
        # committed ones (multi-process meshes reject mixed-device ops)
        self.arrays_local = arrays
        self.config = config

        self.prep_sub = prepare_lp(
            arrays.W, arrays.senses2, arrays.q,
            arrays.lb2, arrays.ub2, ruiz_iters=config.pdhg.ruiz_iters)
        if x0 is None:
            x0 = np.zeros(inst.n1)
        # An infeasible start pins the incumbent forever (the improvement
        # test ignores first-stage feasibility) — project onto the
        # first-stage polytope (see project_first_stage's docstring).
        x0, moved = project_first_stage(inst.arrays, x0)
        if moved > 0.0:
            warnings.warn(
                f"x0 violated the first-stage constraints; projected onto "
                f"the feasible set (1-norm distance {moved:.6g})")
        self.state: SDState = init_state(
            inst, self.espec, config, x0, jax.random.PRNGKey(seed))
        self.scenario_model = inst.scenario_model
        self.proposal = proposal
        self.mesh = None
        if mesh_shape is not None or (mesh_devices and mesh_devices > 1):
            from sqlp_tpu.parallel.mesh import (make_mesh, make_mesh_2d,
                                                replicate, shard_state)
            if mesh_shape is not None:
                nd, ns = mesh_shape
                assert config.max_scenarios % ns == 0, (
                    "max_scenarios must divide the scenario mesh axis")
                assert config.max_dual_vertices % nd == 0, (
                    "max_dual_vertices must divide the dual mesh axis")
                mesh = make_mesh_2d(nd, ns)
            else:
                assert config.max_scenarios % mesh_devices == 0, (
                    "max_scenarios must divide the mesh size")
                mesh = make_mesh(mesh_devices)
            self.mesh = mesh
            self.arrays = replicate(self.arrays, mesh)
            self.prep_sub = replicate(self.prep_sub, mesh)
            self.espec = replicate(self.espec, mesh)
            self.scenario_model = replicate(inst.scenario_model, mesh)
            if self.proposal is not None:
                self.proposal = replicate(self.proposal, mesh)
            self.state = shard_state(self.state, mesh,
                                     shard_duals=shard_duals)
        self.history: List[Dict] = []

    def _unscale(self, stats: Dict) -> Dict:
        if self.obj_scale == 1.0:
            return stats
        out = dict(stats)
        for k in self._OBJ_KEYS:
            if k in out:
                out[k] = out[k] * self.obj_scale
        return out

    def step(self) -> Dict:
        """One SD iteration; returns host-side stats dict (objective-unit
        entries unscaled)."""
        self.state, stats = sd_step(
            self.arrays, self.scenario_model, self.espec,
            self.prep_sub, self.state, self.config, proposal=self.proposal)
        return self._unscale(stats)

    def step_scenarios(self, values=None, deltas=None, weights=None) -> Dict:
        """One SD iteration on USER-SUPPLIED scenarios — the reference's
        ``sd_iteration!(cell, scenario_list)`` surface (algorithm.jl:39-45)
        with ``add_scenario!``'s per-scenario weight argument
        (epigraph.jl:81-96).

        ``values``: [n_epi, B, R] raw scenario values in sto-position
        order (the reference's ``spSmpsScenario`` layout), converted
        against the scenario model's template; or pass ``deltas``
        ([n_epi, B, R], value - template) directly. ``weights``
        ([n_epi, B], default 1) supports importance sampling — pair with
        ``models.scenario.sample_importance`` to draw from a proposal
        model and weight for the target. B must equal
        ``config.scenarios_per_iter``.
        """
        from sqlp_tpu.models.scenario import values_to_deltas

        assert (values is None) != (deltas is None), \
            "pass exactly one of values= or deltas="
        if deltas is None:
            deltas = values_to_deltas(self.inst.scenario_model, values)
        deltas = jnp.asarray(deltas, self.config.jdtype)
        if weights is not None:
            weights = jnp.asarray(weights, self.config.jdtype)
        self.state, stats = sd_step(
            self.arrays, self.scenario_model, self.espec,
            self.prep_sub, self.state, self.config,
            deltas=deltas, weights=weights)
        return self._unscale(stats)

    def _stat_schema(self, ndim: int = 0):
        """Packed-stats column schema, cached per config (the abstract
        trace of sd_step behind it is not free)."""
        from sqlp_tpu.sd.algorithm import scalar_stat_schema
        cache_key = (self.config, ndim)
        cached = getattr(self, "_stat_schema_cache", None)
        if cached is not None and cached[0] == cache_key:
            return cached[1]
        schema = scalar_stat_schema(self.arrays, self.scenario_model,
                                    self.espec, self.prep_sub, self.state,
                                    self.config, ndim=ndim)
        self._stat_schema_cache = (cache_key, schema)
        return schema

    def run(self, n_iters: int, log_every: int = 0,
            callback: Optional[Callable[[int, Dict], None]] = None,
            chunk: int = 256) -> Dict:
        """Run n_iters iterations; returns the last iteration's stats.

        Iterations execute in on-device chunks (sd_run) with ONE host sync
        per chunk instead of a host round trip per step (the packed-stats
        readback is a single [chunk, n_keys] buffer, so a bigger chunk
        costs only that buffer; 256 amortizes the per-chunk
        dispatch+transfer on flagship runs). Pass a
        smaller ``chunk`` when host-side work (stopping rules, eval,
        checkpoints) needs finer boundaries. Per-iteration scalar stats for
        the whole run land in ``self.history`` at ``log_every`` granularity.
        """
        from sqlp_tpu.sd.algorithm import sd_run

        schema = self._stat_schema()
        last: Dict = {}
        done = 0
        while done < n_iters:
            n = min(chunk, n_iters - done)
            # always compile the full-chunk executable; a partial final
            # chunk passes its length dynamically instead of recompiling
            self.state, packed = sd_run(
                self.arrays, self.scenario_model, self.espec,
                self.prep_sub, self.state, self.config, min(chunk, n_iters),
                jnp.asarray(n, jnp.int32), proposal=self.proposal)
            packed = np.asarray(packed)         # ONE device->host transfer
            acc = self._unscale(
                {k: packed[:n, j].astype(dt)
                 for j, (k, dt) in enumerate(schema)})
            done += n
            # Failure path (reference: master failure dumps
            # error_model.mof.json and rethrows, algorithm.jl:104-110):
            # a non-finite estimate means the state is poisoned — dump the
            # full solver state for postmortem and stop.
            if not np.all(np.isfinite(acc["cand_est"])):
                from sqlp_tpu.utils.checkpoint import save_state
                dump = os.path.abspath("error_state.npz")
                save_state(dump, self.state, instance=self.inst.name)
                bad = int(acc["it"][np.argmax(~np.isfinite(acc["cand_est"]))])
                raise FloatingPointError(
                    f"non-finite candidate estimate at iteration {bad}; "
                    f"state dumped to {dump} (inspect with "
                    f"sqlp_tpu.utils.checkpoint.load_state)")
            if log_every:
                for j in range(n):
                    it = int(acc["it"][j])
                    if it % log_every == 0:
                        self.history.append(
                            {k: acc[k][j].item() for k in acc})
            last = {k: acc[k][-1] for k in acc}
            if callback:
                callback(done, last)
        return last

    @property
    def x_incumbent(self) -> np.ndarray:
        return np.asarray(self.state.x_incumbent)

    @property
    def x_candidate(self) -> np.ndarray:
        return np.asarray(self.state.x_candidate)

    @property
    def lower_estimate(self) -> float:
        """Candidate objective estimate under current cuts — the lb proxy the
        reference drivers print (sd_single_cut_test.jl:71-77). NOT a valid
        bound (it can sit above the optimum); see
        :meth:`cut_model_lower_bound` for the deterministic SAA bound."""
        return float(self.state.cand_est) * self.obj_scale

    def cut_model_lower_bound(self) -> float:
        """Exact minimum of the current cut model over the first-stage
        polytope, solved on the host by HiGHS in f64 — a DETERMINISTIC
        lower bound on this run's sample-average (SAA) optimum, unlike
        the :attr:`lower_estimate` proxy (sd/lower_bound.py)."""
        from sqlp_tpu.sd.lower_bound import cut_model_min
        return cut_model_min(self.arrays, self.espec, self.state,
                             obj_scale=self.obj_scale)

    def polish_decision(self, x0, n_scenarios: int = 8192,
                        rounds: int = 12, rho: float = 20.0,
                        seed: int = 4242, **kw):
        """Proximal-bundle polish of a first-stage decision on a fresh
        stratified panel (sd/compromise.py:polish_decision), with the
        serious-step values certified by the evaluator's escalation
        ladder. Evaluate the returned x on an INDEPENDENT sample for an
        unbiased cost estimate."""
        from sqlp_tpu.sd.compromise import polish_decision
        # rho is in USER objective units; the internal problem runs in
        # scaled units (same convention as compromise_decision)
        return polish_decision(self.arrays, self.scenario_model,
                               self.prep_sub, self.config, x0,
                               obj_scale=self.obj_scale,
                               n_scenarios=n_scenarios, rounds=rounds,
                               rho=rho / self.obj_scale, seed=seed,
                               values_fn=self._recourse_objs, **kw)

    def saa_lower_bound(self, max_rounds: int = 24,
                        gap_tol: float = 1e-4,
                        extra_scenarios: int = 0, seed: int = 9000) -> Dict:
        """Level-bundle-polished deterministic bound on this run's SAA
        optimum: stabilized Benders rounds on the (optionally extended)
        scenario stream tighten the cut model before taking its exact
        minimum (sd/lower_bound.py:saa_polish). Returns the polish dict;
        ``lb_per_rep[0]`` is the bound."""
        from sqlp_tpu.sd.lower_bound import saa_polish
        return saa_polish(self.arrays, self.scenario_model, self.espec,
                          self.prep_sub, [self.state], self.config,
                          obj_scale=self.obj_scale, max_rounds=max_rounds,
                          gap_tol=gap_tol, extra_scenarios=extra_scenarios,
                          seed=seed)

    def select_decision(self, candidates: Dict, n_samples: int = 16384,
                        seed: int = 31000, batch: int = 8192) -> Dict:
        """Pick the cheapest first-stage decision among ``candidates``
        ({name: x}) on a SHARED stratified selection panel (common
        random numbers: every candidate sees the same scenarios, so
        cost differences are estimated at far lower variance than the
        costs themselves). Each candidate is first projected onto the
        first-stage polytope (epsilon-infeasible iterates — ADMM
        compromise solutions, EF argmins — make recourse LPs
        infeasible otherwise).

        Selection bias: the winner's selection-panel estimate is
        optimistically biased (min over noisy estimates) — re-evaluate
        the returned decision on an INDEPENDENT panel (different seed)
        for the reported upper bound.

        Returns {"name", "x", "table": {name: (mean, half_width,
        projection_distance)}}.
        """
        from sqlp_tpu.models.routines import project_first_stage

        table = {}
        best = None
        for name, x in candidates.items():
            xp, moved = project_first_stage(self.inst.arrays,
                                            np.asarray(x, np.float64))
            mean, hw, _ = self.evaluate_ci(
                x=xp, min_samples=n_samples, max_samples=n_samples,
                seed=seed, batch=batch, sampling="stratified")
            table[name] = (mean, hw, float(moved))
            if best is None or mean < best[2]:
                best = (name, xp, mean)
        return {"name": best[0], "x": best[1], "table": table}

    def sharpen_duals_host(self, k: int = 32, x=None) -> Dict:
        """Host-exact dual sharpening: re-solve the pool's top-``k``
        argmax-winning vertices' home scenarios with HiGHS and push the
        exact basic duals (true simplex vertices) into the pool.

        The reference gets basic dual vertices for free from CPLEX/GLPK
        (smps_routines.jl:58-61); our pool holds valid_tol-feasible
        first-order duals, and on degenerate instances (storm) the
        batched active-set crossover cannot vertex-ify them (measured
        0/96 accepted even in f64 — RESULTS.md r4). This is the second
        mechanism: instead of rounding approximate duals, periodically
        solve EXACTLY the scenarios whose argmax winners carry the most
        win mass (``duals_score`` EMA) and inject the exact optimal
        duals. Any dual-feasible vector is a valid pool entry, so cut
        validity is untouched; the SASA argmax can only improve.

        Returns diagnostics: ``n_solved``, ``n_new`` (pool entries the
        dedup accepted), ``mean_slack``/``max_slack`` — the measured
        optimality slack of the pool's argmax value on the re-solved
        scenarios (scaled objective units), i.e. how much cut value the
        first-order duals were leaving on the table there.
        """
        from sqlp_tpu.models.routines import solve_lp_host
        from sqlp_tpu.sd.dual_pool import push_duals

        assert self.mesh is None, "host sharpening is a single-device path"
        assert not self.inst.scenario_model.has_cost, \
            "random-cost pools carry per-scenario admissibility; " \
            "host sharpening is not defined there"
        state = self.state
        nd = int(state.n_duals)
        if nd == 0:
            return {"n_solved": 0, "n_new": 0, "mean_slack": 0.0,
                    "max_slack": 0.0}
        duals = np.asarray(state.duals, np.float64)[:nd]
        score = np.asarray(state.duals_score, np.float64)[:nd]
        x = np.asarray(self.x_incumbent if x is None else x, np.float64)

        # stored certification scenarios across all epigraphs -> RHS panel
        n_scen = np.asarray(state.n_scen)
        deltas = np.asarray(state.scen_deltas, np.float64)
        H = np.concatenate([
            np.asarray(_scenario_rhs(
                self.arrays_local, self.inst.scenario_model,
                jnp.asarray(deltas[e, :int(n_scen[e])]),
                jnp.asarray(x, self.config.jdtype)), np.float64)
            for e in range(deltas.shape[0]) if int(n_scen[e]) > 0])
        if H.shape[0] == 0:
            return {"n_solved": 0, "n_new": 0, "mean_slack": 0.0,
                    "max_slack": 0.0}
        winners = np.argsort(score)[::-1][:min(k, nd)]
        # each winner's home scenario: where it scores highest
        home = np.unique(np.argmax(duals[winners] @ H.T, axis=1))
        a = self.arrays_local
        q = np.asarray(a.q, np.float64)
        W = np.asarray(a.W, np.float64)
        s2 = np.asarray(a.senses2)
        lb = np.asarray(a.lb2, np.float64)
        ub = np.asarray(a.ub2, np.float64)
        pis, slacks = [], []
        val_pool = (duals @ H[home].T).max(axis=0)     # current argmax value
        for j, s_idx in enumerate(home):
            try:
                obj, _, pi = solve_lp_host(q, W, H[s_idx], s2, lb, ub)
            except RuntimeError:
                continue                      # infeasible at this x: skip
            pis.append(pi)
            slacks.append(obj - val_pool[j])
        if not pis:
            return {"n_solved": 0, "n_new": 0, "mean_slack": 0.0,
                    "max_slack": 0.0}
        n_before = nd
        out = push_duals(
            state.duals, state.duals_rounded, state.n_duals,
            jnp.asarray(np.stack(pis), self.config.jdtype),
            state.duals_dropped, sig_bits=self.config.dual_sig_bits,
            score=state.duals_score)
        self.state = dataclasses.replace(
            state, duals=out[0], duals_rounded=out[1], n_duals=out[2],
            duals_dropped=out[3], duals_score=out[4])
        return {"n_solved": len(pis),
                "n_new": int(out[2]) - n_before,
                "mean_slack": float(np.mean(slacks)),
                "max_slack": float(np.max(slacks))}

    def _warmstart_pool(self) -> Optional[np.ndarray]:
        """Live dual-vertex pool [n_duals, m2] (f64, host) for MC-retry
        warm starts, or None when empty. Overridden by SDReplications,
        whose state carries a leading replication axis."""
        from sqlp_tpu.parallel.mesh import to_host
        n_duals = int(self.state.n_duals)
        if n_duals <= 0:
            return None
        return np.asarray(to_host(self.state.duals)[:n_duals], np.float64)

    @property
    def _prep_sub64(self):
        """f64 PreparedLP for the MC evaluator's escalation re-solve,
        built lazily (most runs never need it)."""
        cached = getattr(self, "_prep_sub64_cache", None)
        if cached is None:
            a = self.arrays_local
            cached = prepare_lp(
                jnp.asarray(np.asarray(a.W, np.float64)),
                a.senses2,
                jnp.asarray(np.asarray(a.q, np.float64)),
                jnp.asarray(np.asarray(a.lb2, np.float64)),
                jnp.asarray(np.asarray(a.ub2, np.float64)),
                ruiz_iters=self.config.pdhg.ruiz_iters)
            self._prep_sub64_cache = cached
        return cached

    def _recourse_objs(self, H, Q=None, obj0=None, valid0=None
                       ) -> np.ndarray:
        """Recourse objectives for an RHS panel, certified per element.
        ``Q`` ([B, n2], optional): per-scenario objectives on random-cost
        instances — threaded through the device solve, the device retries,
        and the exact host fallback.

        The SD step gates dual-pool admission on ``pdhg_valid``; the MC
        estimators must apply the same standard (ADVICE r1: silently
        averaging unconverged elements biases the upper bound that drives
        the --stop-gap rule). Elements the first-order kernel could not
        certify to ``valid_tol`` walk a device escalation ladder —
        (1) re-solve with a pool-argmax dual warm start, (2) re-solve the
        residue in f64 (no f32 residual floor, so ``valid_tol`` is
        reachable) — before the serial exact host
        fallback, which is retained as a guarded exceptional path only
        (VERDICT r3: it used to fire on ~100/4096 elements every bench
        evaluation; the f64 rung clears those on device).
        """
        from sqlp_tpu.models.routines import solve_lp_host

        B = H.shape[0]
        Qn = None if Q is None else np.asarray(Q, np.float64)
        if obj0 is not None:
            assert self.mesh is None, \
                "solve reuse is a single-device path"
            Hn_host = None
            vals = np.array(obj0, np.float64)
            valid = np.asarray(valid0)
        elif self.mesh is not None:
            # shard the panel over the mesh batch axis (SURVEY §5.7: MC
            # evaluation is one of the two sharded parallel axes); pad to
            # the mesh size with copies of row 0, discarded after
            from sqlp_tpu.parallel.mesh import place_batch, to_host
            pad = (-B) % self.mesh.devices.size
            Hn_host = np.asarray(H, np.float64)
            if pad:
                H = jnp.concatenate(
                    [H, jnp.broadcast_to(H[:1], (pad,) + H.shape[1:])])
                if Q is not None:
                    Q = jnp.concatenate(
                        [Q, jnp.broadcast_to(Q[:1], (pad,) + Q.shape[1:])])
            H = place_batch(np.asarray(H), self.mesh)
            if Q is not None:
                Q = place_batch(np.asarray(Q), self.mesh)
            obj, _, _, stats = solve_batch(self.prep_sub, H,
                                           self.config.pdhg, Q=Q)
            vals = to_host(obj).astype(np.float64)[:B]
            valid = to_host(stats["pdhg_valid"])[:B]
        else:
            Hn_host = None
            # pool-argmax dual warm start for the whole panel: the SD
            # premise (optimal duals repeat across scenarios) applies to
            # evaluation panels too, and the scoring matmul is noise next
            # to the PDHG iterations it saves — the same start already
            # converts ~70% of retry stragglers (below)
            L0 = None
            pool = self._warmstart_pool()
            if pool is not None and not self.inst.scenario_model.has_cost:
                pool_j = jnp.asarray(pool, self.config.jdtype)
                L0 = pool_j[jnp.argmax(
                    jnp.matmul(pool_j, H.T,
                               precision=jax.lax.Precision.HIGHEST),
                    axis=0)]
            obj, _, _, stats = solve_batch(self.prep_sub, H,
                                           self.config.pdhg, L0=L0, Q=Q)
            # np.array (copy): with matching dtypes np.asarray returns a
            # READ-ONLY zero-copy view of the device buffer, and the
            # retry/fallback paths below assign into vals in place
            vals = np.array(obj, np.float64)
            valid = np.asarray(stats["pdhg_valid"])
        bad = np.flatnonzero(~valid)
        Hn = Hn_host if Hn_host is not None else np.asarray(H, np.float64)
        if bad.size:
            # Second chance ON DEVICE before the serial host fallback: a
            # fresh solve of the failed subset, dual-warm-started at the
            # pool's argmax vertex for each RHS (near-optimal for most
            # scenarios at an SD iterate), converges ~70% of the
            # stragglers (ssn panel: 420 -> 127 at 10ms/LP host cost
            # avoided each). Batch padded to a power-of-two bucket so
            # retries reuse a handful of compiled shapes.
            # fixed 256 floor: straggler counts vary batch to batch
            # (50-150 on ssn panels) and every distinct bucket size
            # compiles its own ladder; one shared shape amortizes to a
            # single compile
            bucket = max(256, 1 << (int(bad.size) - 1).bit_length())
            idx = np.pad(bad, (0, bucket - bad.size), mode="edge")
            Hb = jnp.asarray(Hn[idx], self.config.jdtype)
            Qb = None if Qn is None else jnp.asarray(Qn[idx],
                                                     self.config.jdtype)
            L0 = None
            pool = self._warmstart_pool()
            if pool is not None:
                L0 = jnp.asarray(pool[np.argmax(pool @ Hn[idx].T, axis=0)],
                                 self.config.jdtype)
            obj_r, Y_r, Pi_r, st_r = solve_batch(self.prep_sub, Hb,
                                                 self.config.pdhg, L0=L0,
                                                 Q=Qb)
            fixed = np.asarray(st_r["pdhg_valid"])[:bad.size]
            vals[bad[fixed]] = np.asarray(obj_r, np.float64)[:bad.size][fixed]
            rem_pos = np.flatnonzero(~fixed)    # retry-bucket positions
            bad = bad[~fixed]
            if bad.size:
                # f64 escalation: the f32 residuals of the remaining
                # stragglers typically FLOOR just above valid_tol (more
                # iterations cannot help); one double-precision re-solve
                # warm-started from the f32 iterate clears them on device
                # (ssn bench panels: ~100/4096 residual host solves -> 0)
                bucket2 = max(256, 1 << (int(bad.size) - 1).bit_length())
                idx2 = np.pad(bad, (0, bucket2 - bad.size), mode="edge")
                pos2 = np.pad(rem_pos, (0, bucket2 - rem_pos.size),
                              mode="edge")
                Y64 = np.asarray(Y_r, np.float64)[pos2]
                P64 = np.asarray(Pi_r, np.float64)[pos2]
                # capped budget for the f64 rung: from the warm f32
                # iterate a successful cleanup needs few f64 iterations —
                # elements that still floor go to the exact host solver
                # (~10 ms each on the host) regardless, so letting them
                # grind the full 80k f64 budget only burns device time
                # (bigger budgets/stall patience were strictly worse)
                cfg64 = dataclasses.replace(
                    self.config.pdhg,
                    max_iters=min(self.config.pdhg.max_iters, 20_000))
                obj2, _, _, st2 = solve_batch(
                    self._prep_sub64, jnp.asarray(Hn[idx2]), cfg64,
                    Y0=jnp.asarray(Y64), L0=jnp.asarray(P64),
                    Q=None if Qn is None else jnp.asarray(Qn[idx2]))
                fixed2 = np.asarray(st2["pdhg_valid"])[:bad.size]
                vals[bad[fixed2]] = \
                    np.asarray(obj2, np.float64)[:bad.size][fixed2]
                bad = bad[~fixed2]
        if bad.size:
            a = self.arrays_local
            q = np.asarray(a.q, np.float64)
            W = np.asarray(a.W, np.float64)
            s2 = np.asarray(a.senses2)
            lb = np.asarray(a.lb2, np.float64)
            ub = np.asarray(a.ub2, np.float64)
            for b in bad:
                try:
                    vals[b], _, _ = solve_lp_host(
                        q if Qn is None else Qn[b], W, Hn[b], s2, lb, ub)
                except RuntimeError as e:
                    raise RuntimeError(
                        f"recourse LP infeasible/unsolvable at the "
                        f"evaluated x for scenario row {b} — the evaluated "
                        f"point is likely outside the induced-feasible "
                        f"region (is x first-stage feasible?): {e}") from e
            # Exceptional path: count it, and warn loudly only when it
            # stops being exceptional (>1% of a panel). A handful of
            # genuinely degenerate LPs per large panel resisting both
            # f32 and capped-f64 device solves is expected noise; their
            # exact host repair is unbiased and costs ~10 ms each. The
            # cumulative count is exposed as ``host_fallback_count``.
            self.host_fallback_count = (
                getattr(self, "host_fallback_count", 0) + int(bad.size))
            if bad.size > 0.01 * len(vals):
                warnings.warn(
                    f"{bad.size}/{len(vals)} recourse LPs missed "
                    f"valid_tol={self.config.pdhg.valid_tol:g} in the MC "
                    f"evaluator even after the full device escalation "
                    f"ladder (pool-warm-started f32 retry, then f64 "
                    f"re-solve) — re-solved exactly on host. At this "
                    f"rate the panel is not healthy; check the PDHG "
                    f"stats")
        return vals

    def _cost_panel(self, deltas):
        """Per-scenario objective panel for the MC evaluators (None unless
        the instance has random cost coefficients)."""
        if not self.inst.scenario_model.has_cost:
            return None
        from sqlp_tpu.models.scenario import cost_panel
        return cost_panel(self.inst.scenario_model, deltas,
                          self.arrays_local.q)

    def evaluate(self, x=None, n_samples: int = 10_000, seed: int = 123,
                 batch: int = 4096, sampling: str = "iid") -> float:
        """Monte-Carlo upper-bound estimate at x (smps_routines.jl:67-82),
        batched on device instead of N serial solver round-trips.
        Uncertified batch elements walk the device escalation ladder
        (see ``_recourse_objs``); the exact host solver remains only as
        a guarded exceptional fallback. ``sampling`` in {"iid",
        "antithetic", "stratified"} selects the variance-reduction
        scheme per device batch (reference TODO 7)."""
        inst = self.inst
        x = jnp.asarray(self.x_incumbent if x is None else x,
                        self.config.jdtype)
        key = jax.random.PRNGKey(seed)
        total = 0.0
        done = 0
        while done < n_samples:
            b = min(batch, n_samples - done)
            key, k = jax.random.split(key)
            deltas = sample_deltas(k, inst.scenario_model, b,
                                   method=sampling)
            H = _scenario_rhs(self.arrays_local, inst.scenario_model,
                              deltas, x)
            Q = self._cost_panel(deltas)
            total += float(self._recourse_objs(H, Q=Q).sum())
            done += b
        first = float(jnp.dot(self.arrays_local.c, x))
        return (first + total / n_samples) * self.obj_scale

    def evaluate_ci(self, x=None, confidence: float = 0.95,
                    target_half_width: float = 0.0,
                    min_samples: int = 2048, max_samples: int = 262_144,
                    seed: int = 123, batch: int = 4096,
                    sampling: str = "iid"):
        """Monte-Carlo estimate with a confidence interval.

        Draws ``min_samples`` first. With ``target_half_width > 0``,
        keeps sampling in device batches until the CI half-width at
        ``confidence`` drops below the target or ``max_samples`` is hit —
        the adaptive-N policy the reference flags as an open TODO
        (readme.md:20-21: N "should be calculated to reflect the
        confidence level"). With ``target_half_width == 0`` (default) it
        stops at ``min_samples``: a fixed-N estimate like :meth:`evaluate`
        but reporting its sampling error.

        ``sampling`` in {"iid", "antithetic", "stratified"}: variance-
        reduced draws per device batch (reference TODO 7). Under a
        variance-reduced scheme the CI half-width is computed from the
        BATCH MEANS once at least 8 equal-size batches have completed:
        each device batch is an independent identically-distributed
        variance-reduced panel (fresh PRNG key per batch), so its mean
        is one i.i.d. observation and the Student-t interval over batch
        means is exactly valid — and it CAPTURES the variance reduction
        the per-element i.i.d. estimator must ignore (measured on ssn
        stratified panels: ~1.9x tighter at equal samples, i.e. ~3.5x
        fewer samples to a target width). With fewer than 8 batches (or
        a ragged final batch, or ``sampling="iid"``) the per-element
        estimator is used; it is CONSERVATIVE under either scheme
        (antithetic pairs are negatively correlated and strata cover
        the marginals, so the true estimator variance is at most the
        i.i.d. one) — the CI never understates.

        Returns (mean, half_width, n_samples).
        """
        import math

        import scipy.stats

        inst = self.inst
        x = jnp.asarray(self.x_incumbent if x is None else x,
                        self.config.jdtype)
        # two-sided normal quantile via inverse erf
        z = math.sqrt(2.0) * float(np.real(_erfinv(confidence)))
        key = jax.random.PRNGKey(seed)
        n = 0
        mean = 0.0
        m2 = 0.0
        batch_means: List[float] = []    # full-size batches only

        def half_width() -> float:
            # batch-mean path: valid t-interval that sees the variance
            # reduction; needs iid batch means (equal sizes — ragged
            # final batches contribute to the mean but not the spread,
            # which only makes the width estimate conservative) and
            # enough of them for a stable spread estimate
            if sampling != "iid" and len(batch_means) >= 8:
                B = len(batch_means)
                t = float(scipy.stats.t.ppf(0.5 * (1.0 + confidence),
                                            B - 1))
                hw = t * float(np.std(batch_means, ddof=1)) \
                    / math.sqrt(B)
            else:
                hw = z * math.sqrt(m2 / max(n - 1, 1) / max(n, 1))
            # the CI covers SAMPLING error only; each element is
            # certified to valid_tol relative, so per-element solver
            # bias up to that scale sits outside it. Floor the width
            # there — binding only when variance reduction drives the
            # sampling error to ~0 (fully stratified small discrete
            # supports), where an unfloored CI would claim near-exact
            # coverage the f32 solves cannot back.
            return max(hw,
                       self.config.pdhg.valid_tol * (1.0 + abs(mean)))

        while True:
            stop_at = min_samples if not target_half_width else max_samples
            b = min(batch, stop_at - n)
            if b <= 0:
                break
            key, k = jax.random.split(key)
            deltas = sample_deltas(k, inst.scenario_model, b,
                                   method=sampling)
            H = _scenario_rhs(self.arrays_local, inst.scenario_model,
                              deltas, x)
            vals = self._recourse_objs(H, Q=self._cost_panel(deltas))
            # Chan et al. parallel-variance merge of the batch's moments
            bn = len(vals)
            bm = float(vals.mean())
            bm2 = float(((vals - bm) ** 2).sum())
            delta = bm - mean
            tot = n + bn
            mean += delta * bn / tot
            m2 += bm2 + delta * delta * n * bn / tot
            n = tot
            if bn == batch:
                batch_means.append(bm)
            if target_half_width and n >= min_samples:
                if half_width() <= target_half_width:
                    break
        hw = half_width()
        first = float(jnp.dot(self.arrays_local.c, x))
        s_ = self.obj_scale
        return (first + mean) * s_, hw * s_, n


def solve_instance(name_or_dir: str, n_iters: int = 1000,
                   config: SDConfig = SDConfig(), x0=None,
                   seed: int = 0, log_every: int = 100,
                   verbose: bool = True) -> SDSolver:
    """Convenience one-call driver (the reference's script pattern)."""
    inst = load_instance(name_or_dir, dtype=config.jdtype)
    solver = SDSolver(inst, config, x0=x0, seed=seed)

    def cb(i, stats):
        if verbose:
            print(f"[{inst.name}] iter {i}: lb_est={stats['cand_est']:.4f} "
                  f"inc_est={stats['inc_est']:.4f} rho={stats['rho']:.4g} "
                  f"duals={stats['n_duals']} cuts={stats['n_cuts_live']}")

    t0 = time.time()
    solver.run(n_iters, log_every=log_every, callback=cb)
    if verbose:
        print(f"[{inst.name}] {n_iters} iters in {time.time() - t0:.1f}s")
    return solver


class SDReplications(SDSolver):
    """R independent SD replications advanced together in one batched
    device program (sd_run_replicated).

    The compromise-decision workflow (sd/compromise.py, the reference's
    empty plugin src/sd_algorithm/plugin/compromise.jl) needs R independent
    runs by construction; running them sequentially leaves the chip
    underfilled at the SD loop's small per-step batch. Here ``self.state``
    carries a leading replication axis R; everything else (instance
    compilation, scaling, projection, evaluation) is inherited.

    Replication r uses PRNGKey(seed + r) — replication 0's trajectory uses
    the same key as a sequential ``SDSolver(seed=seed)`` run, but batched
    trajectories are not bitwise-equal to sequential ones (vmapped inner
    while_loops run every replication until the slowest one's stopping
    test; the best-iterate latches can only improve with extra rounds).
    """

    def __init__(self, inst: Instance, config: SDConfig = SDConfig(),
                 n_replications: int = 2,
                 espec: Optional[EpigraphSpec] = None,
                 x0=None, seed: int = 0, n_epi: int = 1):
        assert n_replications >= 1
        super().__init__(inst, config, espec=espec, x0=x0, seed=seed,
                         n_epi=n_epi)
        self.n_replications = n_replications
        base = self.state
        states = [dataclasses.replace(base, key=jax.random.PRNGKey(seed + r))
                  for r in range(n_replications)]
        self.state = jax.tree.map(lambda *xs: jnp.stack(xs), *states)

    def run(self, n_iters: int, log_every: int = 0,
            callback: Optional[Callable[[int, Dict], None]] = None,
            chunk: int = 64) -> Dict:
        """Run n_iters iterations on every replication; returns the last
        iteration's stats ([R]-shaped entries)."""
        from sqlp_tpu.sd.algorithm import sd_run_replicated

        schema = self._stat_schema(ndim=1)
        last: Dict = {}
        done = 0
        while done < n_iters:
            n = min(chunk, n_iters - done)
            self.state, packed = sd_run_replicated(
                self.arrays, self.scenario_model, self.espec,
                self.prep_sub, self.state, self.config, min(chunk, n_iters),
                jnp.asarray(n, jnp.int32))
            packed = np.asarray(packed)         # ONE device->host transfer
            acc = self._unscale(
                {k: packed[:n, j].astype(dt)
                 for j, (k, dt) in enumerate(schema)})
            done += n
            if not np.all(np.isfinite(acc["cand_est"])):
                from sqlp_tpu.utils.checkpoint import save_state
                dump = os.path.abspath("error_state.npz")
                save_state(dump, self.state, instance=self.inst.name)
                raise FloatingPointError(
                    f"non-finite candidate estimate in a replication; "
                    f"batched state dumped to {dump}")
            if log_every:
                for j in range(n):
                    it = int(acc["it"][j, 0])
                    if it % log_every == 0:
                        self.history.append(
                            {k: acc[k][j] for k in acc})
            last = {k: acc[k][-1] for k in acc}
            if callback:
                callback(done, last)
        return last

    def step(self) -> Dict:
        """One SD iteration on every replication ([R]-shaped stats)."""
        from sqlp_tpu.sd.algorithm import sd_run_replicated
        schema = self._stat_schema(ndim=1)
        self.state, packed = sd_run_replicated(
            self.arrays, self.scenario_model, self.espec,
            self.prep_sub, self.state, self.config, 1)
        packed = np.asarray(packed)
        return self._unscale({k: packed[0, j].astype(dt)
                              for j, (k, dt) in enumerate(schema)})

    def _warmstart_pool(self) -> Optional[np.ndarray]:
        """Union of every replication's live dual vertices: the MC retry
        evaluates arbitrary x (e.g. the compromise decision), so any
        replication's vertex is an equally valid warm-start candidate."""
        n_duals = np.asarray(self.state.n_duals)           # [R]
        if not n_duals.max(initial=0) > 0:
            return None
        duals = np.asarray(self.state.duals, np.float64)   # [R, D, m2]
        return np.concatenate(
            [duals[r, :int(n_duals[r])] for r in range(len(n_duals))])

    @property
    def states(self) -> List[SDState]:
        """Per-replication SDState views (for compromise_decision)."""
        return [jax.tree.map(lambda a: a[r], self.state)
                for r in range(self.n_replications)]

    def certified_lower_bound(self, confidence: float = 0.95,
                              method: str = "ef",
                              polish_rounds: int = 24,
                              gap_tol: float = 1e-4,
                              extra_scenarios: int = 0,
                              antithetic_reps: bool = False,
                              seed: int = 9000, **kw) -> Dict:
        """Replication-based Student-t confidence lower bound on the TRUE
        optimum: each replication yields a deterministic bound on its own
        SAA optimum, and i.i.d. sampling gives E[SAA optimum] <= v*
        (sd/lower_bound.py). ``method`` selects the per-replication
        bound:

          "ef"     (default) one structured-PDHG extensive-form solve per
                   replication (all R vmapped on device) + the aggregate
                   dual cut's exact HiGHS minimum — tight to the EF
                   duality gap (sd/lower_bound.py:saa_ef_bound);
          "polish" level-bundle Benders rounds on the stored stream
                   (saa_polish) — cheaper per round, slower to tighten;
          "model"  the SD run's final cut model minimum alone — free but
                   loose (the model is only tight near the iterates).

        ``extra_scenarios`` extends each replication's certification
        stream with fresh i.i.d. draws (smaller SAA bias and spread; the
        SD cuts are then excluded from the bound model). Returns lb_cert
        / lb_mean / lb_half_width / lb_per_rep (+ method diagnostics)."""
        from sqlp_tpu.sd.lower_bound import (certified_lower_bound,
                                             saa_ef_bound, saa_polish,
                                             t_lower_bound)
        if antithetic_reps:
            # pairing is a property of FRESH certification streams
            # (replication 2k+1 certifies on the complement of 2k's);
            # the SD runs themselves stay independent
            assert kw.get("fresh_scenarios", 0) > 0, \
                "antithetic_reps requires fresh_scenarios > 0"
            assert method != "model", \
                "the model route certifies the SD streams themselves"
            kw["fresh_pairing"] = "antithetic"
        if method == "model" or (method == "polish" and polish_rounds <= 0):
            return certified_lower_bound(
                self.arrays, self.espec, self.states,
                obj_scale=self.obj_scale, confidence=confidence)
        if method in ("ef", "ef_polish"):
            if method == "ef_polish":
                # bundle cuts over the SAME certification streams (same
                # seed => _certification_streams regenerates identical
                # panels) patch the single aggregate EF cut's slope dip:
                # the EF cut anchors the bound near v_N at its argmin,
                # the bundle cuts hold the model up elsewhere
                pol = saa_polish(
                    self.arrays, self.scenario_model, self.espec,
                    self.prep_sub, self.states, self.config,
                    obj_scale=self.obj_scale, max_rounds=polish_rounds,
                    gap_tol=gap_tol, extra_scenarios=extra_scenarios,
                    seed=seed,
                    **{k: v for k, v in kw.items()
                       if k in ("fresh_scenarios", "fresh_sampling",
                                "fresh_pairing", "level_lambda",
                                "qp_rows_cap")})
                kw = {k: v for k, v in kw.items()
                      if k not in ("level_lambda", "qp_rows_cap")}
                kw["extra_cuts"] = pol["cuts_per_rep"]
            ef = saa_ef_bound(self.arrays, self.scenario_model,
                              self.espec, self.states, self.config,
                              obj_scale=self.obj_scale,
                              extra_scenarios=extra_scenarios, seed=seed,
                              **kw)
            out = t_lower_bound(ef["lb_per_rep"], confidence,
                                pair_means=antithetic_reps)
            if method == "ef_polish":
                out["polish_lb_per_rep"] = pol["lb_per_rep"]
                out["polish_rounds"] = pol["rounds"]
            for k in ("ef_obj_per_rep", "ef_err_per_rep",
                      "dual_infeas_per_rep", "cut_correction_per_rep",
                      "host_exact_count", "n_unrefined", "n_scenarios",
                      "x_ef_per_rep"):
                out[k] = ef[k]
            return out
        assert method == "polish", method
        pol = saa_polish(self.arrays, self.scenario_model, self.espec,
                         self.prep_sub, self.states, self.config,
                         obj_scale=self.obj_scale,
                         max_rounds=polish_rounds, gap_tol=gap_tol,
                         extra_scenarios=extra_scenarios, seed=seed,
                         **kw)
        out = t_lower_bound(pol["lb_per_rep"], confidence,
                            pair_means=antithetic_reps)
        out["saa_ub_per_rep"] = pol["saa_ub_per_rep"]
        out["polish_rounds"] = pol["rounds"]
        out["polish_gap_per_rep"] = pol["gap_per_rep"]
        out["n_scenarios"] = pol["n_scenarios"]
        return out

    def solve_to_certified_gap(
            self, target_gap: float, max_iters: int,
            certify_every: int = 0, method: str = "auto",
            confidence: float = 0.95, compromise_rho: float = 1.0,
            min_ub_samples: int = 8192, max_ub_samples: int = 262_144,
            ub_batch: int = 8192, seed: int = 7000,
            verbose: bool = False, **cert_kw) -> Dict:
        """Run SD until the CERTIFIED optimality gap crosses ``target_gap``
        (certified-gap-aware stopping — the reference lists stopping
        criteria as an open TODO, readme.md:18; this goes beyond it by
        stopping on a valid statistical bound rather than a proxy).

        Every ``certify_every`` iterations (default: four rounds across
        ``max_iters``) the loop:

          1. solves the compromise decision over the replications' cut
             models and estimates its cost by stratified Monte Carlo,
             adaptively sampled until the CI half-width is small against
             the target gap;
          2. certifies a statistical lower bound, CHEAP ROUTE FIRST: the
             exact cut-model minima (``method="model"``, a few host LPs)
             — and only if that certificate misses the target escalates
             to the configured route ("polish" for low-dimensional first
             stages, "ef" dual certificates otherwise; ``method="auto"``
             picks by first-stage dimension, RESULTS.md's route guide);
          3. stops when ((ub + ub_hw) - (lb_mean - lb_hw)) / |ub + ub_hw|
             <= target_gap.

        Each round certifies on FRESH streams (seed offset per round), so
        every reported certificate is a valid ~``confidence`` bound on
        its own. The adaptive stopping time means the SEQUENCE of looks
        is not jointly corrected (standard sequential-testing caveat);
        the final certificate is what a one-shot run at the stopping
        iteration would have produced.

        Extra ``cert_kw`` (e.g. ``fresh_scenarios=3000``,
        ``polish_rounds=24``) pass through to the escalated route.

        Returns a dict: ``stopped`` (bool), ``iters``,
        ``time_to_certified_gap_s`` (wall from entry to the crossing
        certificate; None when the target was not reached), ``cert_gap``,
        ``route``, ``lb_cert``/``lb_mean``/``lb_half_width``,
        ``compromise_mc_ub``(+half_width), ``x_compromise``, and
        ``rounds`` — the per-round certification trail.
        """
        from sqlp_tpu.sd.compromise import compromise_decision
        from sqlp_tpu.sd.lower_bound import certified_lower_bound

        assert target_gap > 0.0
        if not certify_every:
            certify_every = max(1, max_iters // 4)
        if method == "auto":
            # route guide (RESULTS.md suite table): the level bundle
            # closes exactly on low-dimensional first stages; EF dual
            # certificates win in high dimension where it stalls
            method = "polish" if self.inst.n1 <= 32 else "ef"
        t_start = time.time()
        rounds: List[Dict] = []
        done = 0
        out: Dict = {}
        while True:
            n = min(certify_every, max_iters - done)
            if n > 0:
                self.run(n)
                done += n
            # -- upper bound: compromise decision, CI sized to the target
            x_comp, info = compromise_decision(
                self.inst, self.states, self.especs, rho=compromise_rho,
                qp_config=self.config.qp, obj_scale=self.obj_scale)
            rseed = seed + 1000 * len(rounds)
            ub, hw, n_ub = self.evaluate_ci(
                x=x_comp, min_samples=min_ub_samples,
                max_samples=min_ub_samples, seed=rseed, batch=ub_batch,
                sampling="stratified", confidence=confidence)
            # a quarter of the target gap keeps the sampling error a
            # minor term in the bracket; resample adaptively only when
            # the first panel's CI is wider than that
            tgt_hw = 0.25 * target_gap * max(abs(ub), 1e-9)
            if hw > tgt_hw and max_ub_samples > min_ub_samples:
                ub, hw, n_ub = self.evaluate_ci(
                    x=x_comp, target_half_width=tgt_hw,
                    min_samples=min_ub_samples,
                    max_samples=max_ub_samples, seed=rseed + 1,
                    batch=ub_batch, sampling="stratified",
                    confidence=confidence)
            # -- lower bound: free model route first
            gap_of = lambda cert: \
                ((ub + hw) - (cert["lb_mean"] - cert["lb_half_width"])) \
                / max(abs(ub + hw), 1e-9)
            cert = certified_lower_bound(
                self.arrays, self.espec, self.states,
                obj_scale=self.obj_scale, confidence=confidence)
            route = "model"
            gap = gap_of(cert)
            if gap > target_gap and method != "model":
                cert_esc = self.certified_lower_bound(
                    confidence=confidence, method=method,
                    seed=rseed + 2, **cert_kw)
                gap_esc = gap_of(cert_esc)
                if gap_esc < gap:
                    cert, gap, route = cert_esc, gap_esc, method
            rec = {"it": done, "route": route,
                   "wall_s": round(time.time() - t_start, 2),
                   "lb_cert": float(cert["lb_cert"]),
                   "lb_mean": float(cert["lb_mean"]),
                   "lb_half_width": float(cert["lb_half_width"]),
                   "compromise_mc_ub": float(ub),
                   "compromise_mc_ub_half_width": float(hw),
                   "mc_ub_samples": int(n_ub),
                   "cert_gap": float(gap)}
            rounds.append(rec)
            if verbose:
                print(f"[certify] iter {done}: gap={gap:.5f} "
                      f"({route}; lb_cert={cert['lb_cert']:.6g} "
                      f"ub={ub:.6g}+-{hw:.3g}) target={target_gap:g}",
                      file=sys.stderr, flush=True)
            stopped = gap <= target_gap
            if stopped or done >= max_iters:
                out = dict(rec)
                out.update({
                    "stopped": stopped,
                    "iters": done,
                    "target_gap": target_gap,
                    "confidence": confidence,
                    "time_to_certified_gap_s":
                        rec["wall_s"] if stopped else None,
                    "x_compromise": np.asarray(x_comp),
                    "rounds": rounds,
                })
                return out

    @property
    def especs(self) -> List[EpigraphSpec]:
        return [self.espec] * self.n_replications

    @property
    def x_incumbents(self) -> np.ndarray:
        return np.asarray(self.state.x_incumbent)     # [R, n1]

    @property
    def lower_estimates(self) -> np.ndarray:
        return np.asarray(self.state.cand_est) * self.obj_scale

    # singular accessors are ambiguous on a batch — point at the plurals
    @property
    def x_incumbent(self) -> np.ndarray:
        raise AttributeError("SDReplications has R incumbents — use "
                             ".x_incumbents [R, n1]")

    @property
    def lower_estimate(self) -> float:
        raise AttributeError("SDReplications has R estimates — use "
                             ".lower_estimates [R]")
