"""Dispatch-free stage attribution for the sweep-neighbourhood step.

Scan-amortized harness: every stage runs K iterations inside one jitted
`lax.scan` whose RNG key is folded with the previous iteration's output, so
nothing hoists and the per-iteration time is the real device cost.

Stages:
  nil      — empty body (scan-harness floor; subtract from everything)
  tables   — build_tables (per-step cumulant tables from ctx)
  score    — score_candidates (tables + all three families)
  propose  — full proposal (score + combine + winner + exact re-score)
  step     — full TabuSearch sweep step, vmapped over islands

Run: python scripts/profile_sweep_stages.py [n_customers] [targets] [islands]
Writes the record to the path in GJ_PROF_OUT when it is set. Prints the
device and card lines first; roofline shares only for a device listed in
`greyjack_tpu.utils.device_info.PEAKS`.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K_ITERS = int(os.environ.get("GJ_PROF_ITERS", "20"))


def scan_time(body_fn, init_carry, n=K_ITERS, reps=3):
    import jax

    def loop(c0):
        def body(carry, _):
            return body_fn(carry), None
        return jax.lax.scan(body, c0, None, length=n)[0]

    f = jax.jit(loop)
    out = jax.block_until_ready(f(init_carry))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f(init_carry)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best / n


def main():
    import jax
    import jax.numpy as jnp

    from greyjack_tpu.compile_cache import enable_compile_cache
    from greyjack_tpu.utils.device_info import card_line, jax_device, peaks

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    device = jax_device()
    print(f"device: {device}", flush=True)
    card = card_line() if device["platform"] == "gpu" else None
    print(f"card: {card}", flush=True)
    enable_compile_cache()

    from greyjack_tpu.models.vrp import CotwinBuilder, generate_instance
    from greyjack_tpu.models.vrp import sweep
    from greyjack_tpu.score_calculation.score_requesters import ScoreRequester
    from greyjack_tpu.agents import TabuSearch
    from greyjack_tpu.agents.termination_strategies import StepsLimit
    from greyjack_tpu.ops import moves

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    t = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    islands = int(sys.argv[3]) if len(sys.argv) > 3 else 8

    domain = generate_instance(n, 8, 40, seed=37, time_windowed=True)
    cotwin = CotwinBuilder(True, True).build_cotwin(domain, False)
    req = ScoreRequester(cotwin)
    utils = req._delta_utils()
    cfg = sweep.SweepConfig(req, targets=t, window=None)
    mcfg = moves.MoverConfig(req.variables_manager, 0.2, None,
                             [0.5, 0.5, 0, 0, 0, 0])
    agent = TabuSearch(2048, 0.2, True, None, [0.5, 0.5, 0, 0, 0, 0], 10,
                       StepsLimit(10**9), sweep=True, sweep_targets=t)
    kernel = agent.build_kernel(req, None)

    base = req.variables_manager.sample_variables(jax.random.key(0), 1)[0]
    ctx = req.build_base_ctx(base)
    tabu = mcfg.init_tabu_state()
    free = mcfg.tabu_free(tabu)
    masks = mcfg.tabu_masks(tabu)
    n_rows = cfg.n_rows

    results = {}
    moves_per_step = islands * t * (utils["n_stops"] + n_rows
                                    + utils["k_vehicles"])

    def report(name, per_iter):
        results[name] = {"ms": round(per_iter * 1e3, 3)}
        print(f"{name:9s} {per_iter*1e3:8.3f} ms", flush=True)

    # nil: floor
    report("nil", scan_time(lambda c: (c[0] + 1, c[1]),
                            (jnp.int32(0), ctx)))

    # tables
    def b_tables(c):
        acc, cx = c
        stbl, route = sweep.build_tables(cx, cfg, utils)
        return acc + stbl[acc % n_rows, 1], cx
    report("tables", scan_time(b_tables, (jnp.int32(0), ctx)))

    # score_candidates
    t_rows = jnp.arange(t, dtype=jnp.int32) * (n_rows // t)

    def b_score(c):
        acc, cx = c
        sc = sweep.score_candidates(cx, (t_rows + acc % 3) % n_rows,
                                    jnp.ones((t,), bool),
                                    jnp.zeros((n_rows,), bool), cfg, utils)
        return acc + sc["a_dist"][0, 0] + sc["c_late"][0, 0], cx
    report("score", scan_time(b_score, (jnp.int32(0), ctx)))

    # full propose
    def b_prop(c):
        acc, cx = c
        delta, exact, info, stats = sweep.propose(
            jax.random.fold_in(jax.random.key(7), acc), cx, free, masks,
            cfg, utils)
        return acc + exact[2] % 7 + delta["positions"][0], cx
    report("propose", scan_time(b_prop, (jnp.int32(0), ctx)))

    # full vmapped island step
    keys = jax.random.split(jax.random.key(3), islands)
    st0 = jax.jit(jax.vmap(kernel.init_state))(keys)

    def b_step(st):
        ex = {}
        if kernel.prestep is not None:
            ex = dict(kernel.prestep(st))
        k2 = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(11),
                                                   s))(st["step_id"])
        return jax.vmap(kernel.step)(k2, st, ex)
    report("step", scan_time(b_step, st0))
    results["moves_per_step"] = moves_per_step
    results["step_moves_per_s"] = round(
        moves_per_step / (results["step"]["ms"] / 1e3))

    # --- roofline attribution ---------------------------------------------
    # XLA's own cost model per compiled stage (flops + HBM bytes estimate),
    # divided by the measured scan-amortized time, against the device's
    # published peaks (`device_info.PEAKS`; f32 outside the tensor cores,
    # where the HIGHEST-precision one-hot matmuls run). The binding
    # resource per stage says how far from speed-of-light it sits
    # (op-overhead-bound stages are neither — their ceiling is dispatch,
    # fixed by fusion not FLOPs).
    def cost_of(fn, *args):
        c = jax.jit(fn).lower(*args).compile().cost_analysis()
        if isinstance(c, (list, tuple)):
            c = c[0] if c else {}
        c = c or {}
        return {"flops": float(c.get("flops", 0.0)),
                "bytes": float(c.get("bytes accessed", 0.0))}

    pk = peaks()
    stage_fns = {
        "tables": (lambda cx: sweep.build_tables(cx, cfg, utils), (ctx,)),
        "score": (lambda cx: sweep.score_candidates(
            cx, t_rows, jnp.ones((t,), bool), jnp.zeros((n_rows,), bool),
            cfg, utils), (ctx,)),
        "propose": (lambda cx: sweep.propose(
            jax.random.key(7), cx, free, masks, cfg, utils), (ctx,)),
        "step": (b_step, (st0,)),
    }
    nil_s = results["nil"]["ms"] / 1e3
    roofline = {}
    for name, (fn, fargs) in stage_fns.items():
        cost = cost_of(fn, *fargs)
        secs = max(results[name]["ms"] / 1e3 - nil_s, 1e-9)
        gflops = cost["flops"] / secs / 1e9
        gbs = cost["bytes"] / secs / 1e9
        row = {
            "flops": cost["flops"],
            "hbm_bytes_est": cost["bytes"],
            "achieved_gflop_s": round(gflops, 1),
            "achieved_gb_s": round(gbs, 1),
        }
        if pk is not None:
            f_frac = gflops * 1e9 / pk["f32_flop_per_s"]
            b_frac = gbs * 1e9 / pk["hbm_bytes_per_s"]
            row["pct_flops_roofline_f32"] = round(100 * f_frac, 2)
            row["pct_hbm_roofline"] = round(100 * b_frac, 2)
            row["binding"] = ("compute" if f_frac > b_frac else "memory") \
                if max(f_frac, b_frac) > 0.2 else "op-overhead/latency"
        roofline[name] = row
        print(f"roofline {name:9s} {json.dumps(row)}", flush=True)

    out = os.environ.get("GJ_PROF_OUT")
    rec = {"note": ("scan-amortized per-step stage costs for the sweep "
                    "step; 'nil' is the harness floor per iteration. "
                    "Roofline: XLA cost-analysis flops/bytes over measured "
                    "time vs the device's published peaks."),
           "device": device, "card": card, "peaks": pk,
           "geometry": {"n_customers": n, "targets": t, "islands": islands,
                        "window": cfg.window},
           "stages_ms": results,
           "roofline": roofline}
    print(json.dumps(rec))
    if out:
        with open(os.path.join(root, out), "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
