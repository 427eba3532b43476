"""Command-line entry point.

The reference has no CLI — its drivers are copy-paste Julia scripts
(test/instance_test/*.jl, SURVEY.md L5). Here:

    python -m sqlp_tpu solve ssn --iters 3000 --schedule adaptive --rho 1e-3
    python -m sqlp_tpu ef lands --scenarios 100
    python -m sqlp_tpu evaluate transship --samples 20000
    python -m sqlp_tpu bench
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _build_config(args):
    from sqlp_tpu.config import PDHGConfig, QPConfig, SDConfig
    return SDConfig(
        dtype=args.dtype,
        quad_schedule=args.schedule,
        quad_scalar_init=args.rho,
        max_scenarios=args.max_scenarios,
        max_dual_vertices=args.max_duals,
        max_cuts=args.max_cuts,
        dual_sig_bits=args.dual_sig_bits,
        scenarios_per_iter=args.batch,
        sampling=args.sampling,
        cut_refresh_every=getattr(args, "cut_refresh", 0),
        pdhg=PDHGConfig(tol=args.sub_tol, max_iters=args.sub_iters),
        qp=QPConfig(tol=args.master_tol, max_iters=args.master_iters),
    )


def cmd_solve(args) -> int:
    import jax
    from sqlp_tpu.models.crash import crash_x0
    from sqlp_tpu.models.instance import load_instance
    from sqlp_tpu.sd.driver import SDSolver
    from sqlp_tpu.utils.checkpoint import load_state, save_state
    from sqlp_tpu.utils.metrics import MetricsLogger
    from sqlp_tpu.utils.profiling import trace

    config = _build_config(args)
    if not args.no_auto_capacity:
        from sqlp_tpu.config import autoscale_capacities
        config = autoscale_capacities(config, args.iters,
                                      n_epi=args.epigraphs,
                                      mesh_devices=args.mesh)
    inst = load_instance(args.instance, dtype=config.jdtype)
    print(f"{inst.name}: n1={inst.n1} m1={inst.m1} n2={inst.n2} "
          f"m2={inst.m2} R={inst.n_rv} S={config.max_scenarios} "
          f"D={config.max_dual_vertices}", file=sys.stderr)

    if args.x0 == "crash":
        x0, ef_obj, ef_stats = crash_x0(inst, n_scenarios=args.crash_scenarios,
                                        seed=args.seed)
        print(f"crash x0 from {args.crash_scenarios}-scenario EF "
              f"(obj {float(ef_obj):.4f})", file=sys.stderr)
    else:
        x0 = np.zeros(inst.n1)

    from sqlp_tpu.sd.state import default_epigraph_spec
    espec = None
    E = args.epigraphs
    if args.epi_lb is not None:
        espec = default_epigraph_spec(E, 1.0 / E, args.epi_lb,
                                      dtype=config.jdtype)

    if args.replications > 1:
        if args.mesh or args.shard_duals or args.proposal_sto:
            # SDReplications batches replications on one device program;
            # silently dropping the requested sharding misleads (ADVICE r1)
            print("error: --mesh/--shard-duals/--proposal-sto are not "
                  "supported with --replications > 1 (replications batch "
                  "on a single device program); drop one of the flags",
                  file=sys.stderr)
            return 2
        return _solve_replicated(args, config, inst, espec, x0)

    proposal = None
    if args.proposal_sto:
        from sqlp_tpu.models.instance import load_proposal
        proposal = load_proposal(inst, args.proposal_sto,
                                 dtype=config.jdtype)
        print(f"importance sampling from proposal {args.proposal_sto}",
              file=sys.stderr)

    mesh_shape = (args.mesh_duals, args.mesh) \
        if args.mesh_duals and args.mesh else None
    solver = SDSolver(inst, config, espec=espec, x0=x0, seed=args.seed,
                      n_epi=E, mesh_devices=args.mesh,
                      shard_duals=args.shard_duals, mesh_shape=mesh_shape,
                      proposal=proposal)
    print(f"recourse lower bound: {solver.recourse_lb:.6g}"
          + (" (auto)" if args.epi_lb is None
             else f" (user: {args.epi_lb:g})"), flush=True)
    if args.resume:
        solver.state = load_state(args.resume, template=solver.state)
        print(f"resumed from {args.resume} at iter {int(solver.state.it)}",
              file=sys.stderr)

    from sqlp_tpu.sd.stopping import GapRule, LowerBoundStabilization
    stab = LowerBoundStabilization(window=args.stop_stall_window,
                                   rel_tol=args.stop_stall_tol) \
        if args.stop_stall_window else None
    gap_rule = GapRule(rel_gap=args.stop_gap) if args.stop_gap else None
    if gap_rule and not args.eval_every:
        print("--stop-gap needs --eval-every to estimate the upper bound; "
              "ignoring", file=sys.stderr)
        gap_rule = None

    logger = MetricsLogger(args.log)
    t0 = time.time()
    # iterations run in on-device chunks; host work (logging, MC eval,
    # checkpointing, stopping rules) happens at the coarsest compatible
    # boundary
    periods = [p for p in (args.log_every, args.eval_every,
                           args.checkpoint_every, args.sharpen_every) if p]
    period = min(periods) if periods else args.iters
    done = 0
    stopped = None
    with trace(args.profile):
        while done < args.iters:
            n = min(period, args.iters - done)
            last = solver.run(n, log_every=args.log_every or 0)
            done += n
            it = int(last["it"])
            if args.log_every and done % args.log_every == 0:
                rec = logger.log(last)
                lb = rec.get("cand_est", float("nan"))
                print(f"iter {it}: lb_est={lb:.4f} "
                      f"rho={rec.get('rho', 0):.4g} "
                      f"duals={rec.get('n_duals')} "
                      f"cuts={rec.get('n_cuts_live')}", file=sys.stderr)
            if args.eval_every and done % args.eval_every == 0:
                # CI-aware bound: the stop-gap test inflates ub by its
                # sampling half-width, so a lucky draw cannot stop SD early
                ub, ub_hw, _ = solver.evaluate_ci(
                    min_samples=args.eval_samples,
                    max_samples=args.eval_samples, seed=args.seed + it,
                    sampling=args.sampling)
                logger.log({"it": it, "mc_upper_bound": ub,
                            "mc_half_width": ub_hw})
                print(f"iter {it}: mc_ub={ub:.4f} (+-{ub_hw:.4f})",
                      file=sys.stderr)
                if gap_rule and gap_rule.check(solver.lower_estimate, ub,
                                               ub_half_width=ub_hw):
                    stopped = f"gap <= {args.stop_gap:g} at iter {it}"
            if args.sharpen_every and done % args.sharpen_every == 0 \
                    and done < args.iters:
                sh = solver.sharpen_duals_host(k=args.sharpen_k)
                logger.log({"it": it, "sharpen": sh})
                print(f"iter {it}: sharpened {sh['n_solved']} scenarios "
                      f"(+{sh['n_new']} exact duals, max argmax slack "
                      f"{sh['max_slack']:.3g})", file=sys.stderr)
            if stab and stab.update(float(last["inc_est"])):
                stopped = stopped or \
                    f"incumbent estimate stabilized at iter {it}"
            if args.checkpoint and args.checkpoint_every and \
                    done % args.checkpoint_every == 0:
                save_state(args.checkpoint, solver.state, instance=inst.name)
            if stopped:
                print(f"stopping rule: {stopped}", file=sys.stderr)
                break
    elapsed = time.time() - t0

    if args.checkpoint:
        save_state(args.checkpoint, solver.state, instance=inst.name)
    # final upper bound with its CI half-width: the recourse distribution
    # can be heavy-tailed (ssn: std ~19 on a mean of ~9), so a point MC
    # estimate without its sampling error invites false gap readings
    ub, ub_hw, ub_n = solver.evaluate_ci(min_samples=args.eval_samples,
                                         max_samples=args.eval_samples,
                                         seed=args.seed + 1,
                                         sampling=args.sampling)
    logger.log({"it": int(solver.state.it), "mc_upper_bound": ub,
                "mc_half_width": ub_hw, "mc_samples": ub_n, "final": True})
    logger.close()
    print(f"done: {done} iters in {elapsed:.1f}s "
          f"({done / max(elapsed, 1e-9):.1f} it/s)", file=sys.stderr)
    print(f"lb_est={solver.lower_estimate:.6f} mc_ub={ub:.6f} "
          f"(95% +- {ub_hw:.4f}, N={ub_n})")
    print(f"x_incumbent={np.round(solver.x_incumbent, 6).tolist()}")
    return 0


def _solve_replicated(args, config, inst, espec, x0) -> int:
    """R independent SD replications + the compromise decision (Sen & Liu;
    the reference planned this as a plugin and left it empty,
    src/sd_algorithm/plugin/compromise.jl)."""
    from sqlp_tpu.sd.compromise import compromise_decision
    from sqlp_tpu.sd.driver import SDReplications

    R = args.replications
    t0 = time.time()
    # all R replications advance together in one batched device program
    s = SDReplications(inst, config, n_replications=R, espec=espec, x0=x0,
                       seed=args.seed, n_epi=args.epigraphs)
    if args.target_gap:
        # certified-gap-aware stopping: SD runs in rounds, certifies
        # periodically (free model route first, escalating to the
        # configured route), stops at the target certified gap
        # (sd/driver.py:solve_to_certified_gap; beyond the reference's
        # open stopping-criteria TODO, readme.md:18)
        import json
        method = args.certify_method if args.certify else \
            ("polish" if inst.n1 <= 32 else "ef")
        # fresh stratified certification streams tighten BOTH escalated
        # routes (smaller SAA bias + cross-replication spread)
        kw = ({"fresh_scenarios": args.certify_scenarios}
              if method in ("ef", "polish") else {})
        res = s.solve_to_certified_gap(
            args.target_gap, args.iters,
            certify_every=args.certify_every, method=method,
            compromise_rho=args.compromise_rho,
            max_ub_samples=max(args.eval_samples, 65536),
            seed=args.seed + 7000, verbose=True, **kw)
        x_comp = res.pop("x_compromise")
        print(f"{'stopped at' if res['stopped'] else 'exhausted'} "
              f"{res['iters']} iters in {time.time() - t0:.1f}s "
              f"(certified gap {res['cert_gap']:.5f}, "
              f"target {args.target_gap:g})", file=sys.stderr)
        print(f"x_compromise={np.round(x_comp, 6).tolist()}")
        print(json.dumps(res))
        return 0
    s.run(args.iters)
    for r in range(R):
        ub = s.evaluate(x=s.x_incumbents[r], n_samples=args.eval_samples,
                        seed=args.seed + 10_000)
        print(f"replication {r}: lb_est={s.lower_estimates[r]:.6f} "
              f"mc_ub={ub:.6f}", file=sys.stderr)
    x_comp, info = compromise_decision(
        inst, s.states, s.especs,
        rho=args.compromise_rho, qp_config=config.qp,
        obj_scale=s.obj_scale)
    ub_comp, ub_hw, _ = s.evaluate_ci(
        x=x_comp, min_samples=args.eval_samples,
        max_samples=args.eval_samples, seed=args.seed + 20_000,
        sampling="stratified")
    ub_bar = s.evaluate(x=info["x_bar"],
                        n_samples=args.eval_samples,
                        seed=args.seed + 20_000)
    print(f"done: {R} x {args.iters} iters in {time.time() - t0:.1f}s",
          file=sys.stderr)
    print(f"mc_ub_compromise={ub_comp:.6f} mc_ub_average={ub_bar:.6f}")
    print(f"x_compromise={np.round(x_comp, 6).tolist()}")
    if args.certify:
        # certified optimality gap: EF dual certificates over fresh
        # Latin-hypercube streams + Student-t aggregation
        # (sd/lower_bound.py; a VALID bound, unlike the lb_est proxy)
        t0 = time.time()
        kw = ({"fresh_scenarios": args.certify_scenarios}
              if args.certify_method in ("ef", "polish") else {})
        cert = s.certified_lower_bound(method=args.certify_method, **kw)
        ub_best, ub_best_hw, which = ub_comp, ub_hw, "compromise"
        if "x_ef_per_rep" in cert:
            # the EF certification argmins are free decision candidates
            # (each minimizes a large fresh-stream SAA exactly); pick the
            # best against the compromise on a shared CRN panel, then
            # re-evaluate the winner on an independent panel so the
            # reported ub stays unbiased
            x_ef = np.asarray(cert["x_ef_per_rep"])
            cand = {"compromise": x_comp, "ef_avg": x_ef.mean(axis=0)}
            for r in range(min(2, x_ef.shape[0])):
                cand[f"ef_{r}"] = x_ef[r]
            sel = s.select_decision(
                cand, n_samples=min(16384, args.eval_samples),
                seed=args.seed + 30_000)
            which = sel["name"]
            if which != "compromise":
                ub_best, ub_best_hw, _ = s.evaluate_ci(
                    x=sel["x"], min_samples=args.eval_samples,
                    max_samples=args.eval_samples,
                    seed=args.seed + 40_000, sampling="stratified")
                print(f"decision={which} mc_ub={ub_best:.6f} "
                      f"(selection: "
                      f"{ {k: round(v[0], 4) for k, v in sel['table'].items()} })")
        lo = cert["lb_mean"] - cert["lb_half_width"]
        hi = ub_best + ub_best_hw
        print(f"certified in {time.time() - t0:.1f}s over "
              f"{cert.get('n_scenarios', 0)}-scenario streams",
              file=sys.stderr)
        print(f"lb_cert={cert['lb_cert']:.6f} "
              f"(mean={cert['lb_mean']:.6f} "
              f"hw={cert['lb_half_width']:.6f}, 95% t, R={R})")
        print(f"cert_gap={(hi - lo) / max(abs(hi), 1e-9):.5f} "
              f"(ub {ub_best:.6f}+-{ub_best_hw:.6f}, decision={which})")
    return 0


def cmd_ef(args) -> int:
    import jax
    import jax.numpy as jnp
    from sqlp_tpu.config import PDHGConfig
    from sqlp_tpu.models.crash import solve_extensive_form
    from sqlp_tpu.models.instance import load_instance
    from sqlp_tpu.models.scenario import sample_deltas

    config = _build_config(args)
    inst = load_instance(args.instance, dtype=config.jdtype)
    key = jax.random.PRNGKey(args.seed)
    deltas = sample_deltas(key, inst.scenario_model, args.scenarios)
    probs = jnp.full((args.scenarios,), 1.0 / args.scenarios, config.jdtype)
    t0 = time.time()
    x, obj, stats = solve_extensive_form(
        inst.arrays, inst.scenario_model, deltas, probs,
        PDHGConfig(tol=args.sub_tol, max_iters=args.sub_iters))
    print(f"EF over {args.scenarios} scenarios in {time.time() - t0:.1f}s "
          f"(err {float(stats['ef_err']):.2e}, "
          f"converged={bool(stats['ef_converged'])})", file=sys.stderr)
    print(f"objective={float(obj):.6f}")
    print(f"x={np.round(np.asarray(x), 6).tolist()}")
    return 0


def cmd_evaluate(args) -> int:
    from sqlp_tpu.models.instance import load_instance
    from sqlp_tpu.sd.driver import SDSolver

    config = _build_config(args)
    inst = load_instance(args.instance, dtype=config.jdtype)
    solver = SDSolver(inst, config, seed=args.seed)
    x = np.asarray([float(v) for v in args.x.split(",")]) \
        if args.x else np.zeros(inst.n1)
    ub = solver.evaluate(x=x, n_samples=args.samples, seed=args.seed,
                         sampling=args.sampling)
    print(f"E[cost at x] ~= {ub:.6f} ({args.samples} samples)")
    return 0


def cmd_bench(args) -> int:
    import bench
    return bench.main([])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sqlp_tpu",
                                description="two-stage regularized SD solver")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--mesh", type=int, default=0,
                        help="shard scenario stores over this many devices "
                             "(1-D jax.sharding.Mesh; 0 = single device). "
                             "With --coordinator the mesh spans all "
                             "processes' devices")
        sp.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="multi-process mode: process 0's coordinator "
                             "address (jax.distributed.initialize). Launch "
                             "one identical command per host with matching "
                             "--num-processes and distinct --process-id")
        sp.add_argument("--num-processes", type=int, default=1)
        sp.add_argument("--process-id", type=int, default=0)
        sp.add_argument("--cpu-devices-per-process", type=int, default=None,
                        help="testing: force N virtual CPU devices per "
                             "process and Gloo cross-process collectives")
        sp.add_argument("--shard-duals", action="store_true",
                        help="with --mesh, also shard the dual-vertex pool")
        sp.add_argument("--mesh-duals", type=int, default=0,
                        help="with --mesh N, build a 2-D (duals x "
                             "scenarios) mesh of shape (this, N): the "
                             "dual pool and scenario stores each shard "
                             "over their own mesh axis (needs this*N "
                             "devices)")
        sp.add_argument("--dtype", default="float32",
                        choices=["float32", "float64"])
        sp.add_argument("--schedule", default="constant",
                        choices=["constant", "adaptive"])
        sp.add_argument("--rho", type=float, default=0.1,
                        help="prox weight (initial, for adaptive)")
        sp.add_argument("--max-scenarios", type=int, default=4096)
        sp.add_argument("--max-duals", type=int, default=2048)
        sp.add_argument("--max-cuts", type=int, default=96)
        sp.add_argument("--batch", type=int, default=1,
                        help="scenarios per iteration per epigraph")
        sp.add_argument("--cut-refresh", type=int, default=0,
                        metavar="N",
                        help="every N iterations rebuild all live cuts "
                             "at their generating points at full weight "
                             "(undoes the 1/N cut decay; measured +0.3 "
                             "on the ssn lb estimate, RESULTS.md r4). "
                             "0: reference semantics")
        sp.add_argument("--sampling", default="iid",
                        choices=["iid", "antithetic", "stratified"],
                        help="scenario sampling scheme for the SD stream "
                             "and MC evaluation (antithetic/stratified "
                             "need --batch > 1 for the SD stream; the "
                             "reference lists these as TODO 7)")
        sp.add_argument("--epi-lb", type=float, default=None,
                        help="per-epigraph lower bound on the recourse "
                             "(objective units). Default: computed as a "
                             "provably valid bound by one exact host LP "
                             "over the scenario support box. The reference "
                             "trusts the user constant (its baa99-20 "
                             "driver passes -500000 while the recourse "
                             "dips below -860000 — invalid, and SD then "
                             "converges to the wrong point); a user value "
                             "above the valid bound triggers a warning.")
        sp.add_argument("--dual-sig-bits", type=int, default=16,
                        help="significant binary digits for dual-vertex "
                             "dedup (reference uses 16; lower merges "
                             "epsilon-noise duplicates from the "
                             "first-order subproblem solver)")
        sp.add_argument("--sub-tol", type=float, default=1e-4)
        sp.add_argument("--sub-iters", type=int, default=60_000)
        sp.add_argument("--master-tol", type=float, default=1e-7)
        sp.add_argument("--master-iters", type=int, default=4_000)

    ps = sub.add_parser("solve", help="run SD iterations on an instance")
    ps.add_argument("instance")
    ps.add_argument("--iters", type=int, default=1000)
    ps.add_argument("--x0", default="zeros", choices=["zeros", "crash"])
    ps.add_argument("--crash-scenarios", type=int, default=10)
    ps.add_argument("--log", default=None, help="JSONL metrics path")
    ps.add_argument("--log-every", type=int, default=100)
    ps.add_argument("--eval-every", type=int, default=0)
    ps.add_argument("--eval-samples", type=int, default=1000)
    ps.add_argument("--checkpoint", default=None)
    ps.add_argument("--checkpoint-every", type=int, default=0)
    ps.add_argument("--resume", default=None)
    ps.add_argument("--profile", default=None,
                    help="jax.profiler trace directory")
    ps.add_argument("--epigraphs", type=int, default=1,
                    help="number of weighted epigraph variables (each fed "
                         "an independent scenario stream at weight 1/E)")
    ps.add_argument("--certify", action="store_true",
                    help="with --replications > 1: print a certified "
                         "statistical lower bound and optimality gap "
                         "(EF dual certificates + Student-t)")
    ps.add_argument("--certify-method", default="ef",
                    choices=["ef", "polish", "model"],
                    help="per-replication bound: 'ef' (extensive-form "
                         "dual certificates — high-dimensional first "
                         "stages, e.g. ssn), 'polish' (level-bundle — "
                         "exact on low-dimensional instances), 'model' "
                         "(free; where the SD cut model is already "
                         "tight, e.g. storm). See RESULTS.md's suite "
                         "table")
    ps.add_argument("--certify-scenarios", type=int, default=3000,
                    help="fresh Latin-hypercube certification scenarios "
                         "per replication (0: certify the SD stream)")
    ps.add_argument("--replications", type=int, default=1,
                    help="run R independent SD replications and solve the "
                         "compromise decision over their cut models")
    ps.add_argument("--compromise-rho", type=float, default=1.0,
                    help="prox weight toward the incumbent average in the "
                         "compromise problem")
    ps.add_argument("--target-gap", type=float, default=0.0,
                    help="with --replications > 1: run SD in rounds, "
                         "certify a statistical lower bound periodically "
                         "(free cut-model route first, escalating to "
                         "--certify-method when it misses) and STOP once "
                         "the certified optimality gap crosses this "
                         "target; prints time-to-certified-gap. Unlike "
                         "--stop-gap this stops on a VALID bound, not "
                         "the lb_est proxy")
    ps.add_argument("--certify-every", type=int, default=0,
                    help="certification cadence (iterations) for "
                         "--target-gap; 0 = four rounds across --iters")
    ps.add_argument("--stop-gap", type=float, default=0.0,
                    help="stop when (mc_ub - lb_est) relative gap falls "
                         "below this (needs --eval-every)")
    ps.add_argument("--stop-stall-window", type=int, default=0,
                    help="stop when the incumbent estimate moved less than "
                         "--stop-stall-tol over this many log checks")
    ps.add_argument("--stop-stall-tol", type=float, default=1e-4)
    ps.add_argument("--sharpen-every", type=int, default=0,
                    help="every N iterations re-solve the home scenarios "
                         "of the pool's top-K argmax winners EXACTLY on "
                         "the host and inject the exact basic duals "
                         "(simplex-vertex sharpening for degenerate "
                         "instances where the batched crossover accepts "
                         "nothing, e.g. storm); 0 = off")
    ps.add_argument("--sharpen-k", type=int, default=32,
                    help="top-K winners per --sharpen-every round")
    ps.add_argument("--proposal-sto", default=None, metavar="PATH",
                    help="importance sampling: draw the SD scenario "
                         "stream from this alternate .sto file (same "
                         "random positions) and weight each scenario by "
                         "the exact density ratio, fully on device "
                         "(reference readme TODO items 5/8)")
    ps.add_argument("--no-auto-capacity", action="store_true",
                    help="keep --max-scenarios/--max-duals exactly as "
                         "given instead of shrinking them to what --iters "
                         "iterations can fill (autoscaling never changes "
                         "the trajectory, only removes padding work)")
    common(ps)
    ps.set_defaults(fn=cmd_solve)

    pe = sub.add_parser("ef", help="solve the sampled extensive form")
    pe.add_argument("instance")
    pe.add_argument("--scenarios", type=int, default=100)
    common(pe)
    pe.set_defaults(fn=cmd_ef)

    pv = sub.add_parser("evaluate", help="Monte-Carlo cost estimate at x")
    pv.add_argument("instance")
    pv.add_argument("--x", default=None, help="comma-separated first-stage x")
    pv.add_argument("--samples", type=int, default=10_000)
    common(pv)
    pv.set_defaults(fn=cmd_evaluate)

    pb = sub.add_parser("bench", help="run the benchmark harness")
    pb.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "coordinator", None):
        from sqlp_tpu.parallel.distributed import init_distributed
        init_distributed(
            args.coordinator, args.num_processes, args.process_id,
            cpu_devices_per_process=args.cpu_devices_per_process)
    from sqlp_tpu.utils.jaxsetup import configure_jax
    configure_jax()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
