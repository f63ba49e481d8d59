"""Per-chunk times of the three VRP local-search paths at the bench
geometry, and where the random-move step spends its time.

    python scripts/time_chunk_paths.py [--chunks 20] [--out FILE]

Paths, each timed as one jitted island chunk (`IslandRunner.run_chunk`,
8 islands x 10 steps, VRP tw n=1000 d=8 k=40, seed 37):
  sweep      sweep TabuSearch, 256 targets per island-step
  int-delta  random-move TabuSearch, 4096 neighbours, i32 delta rows
  f64-delta  the same with the integer rows switched off (f64 delta rows)

Stage attribution of the random-move step, each stage scan-amortized inside
one jitted `lax.scan` (the key is folded with the previous output, so
nothing hoists): `sample` (move proposal for 8 x 4096 neighbours), `ints`
and `f64` (proposal + delta scoring), `step` (the full vmapped TabuSearch
step). Delta scoring's share of the step is (ints - sample) / step. Its
bytes come from XLA's cost analysis of the scoring alone; against the
device's published HBM bandwidth (`device_info.PEAKS`) that gives a
roofline share, printed only for a listed device.

Prints the device and card lines first and one JSON object last.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ISLANDS, NEIGHBOURS, TARGETS, CHUNK = 8, 4096, 256, 10
CHANGE_SWAP = [0.5, 0.5, 0.0, 0.0, 0.0, 0.0]


def scan_time(body_fn, init_carry, n=20, reps=3):
    import jax

    def loop(c0):
        return jax.lax.scan(lambda c, _: (body_fn(c), None), c0, None,
                            length=n)[0]

    f = jax.jit(loop)
    jax.block_until_ready(f(init_carry))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(init_carry))
        best = min(best, time.perf_counter() - t0)
    return best / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from greyjack_tpu.compile_cache import enable_compile_cache
    from greyjack_tpu.utils.device_info import card_line, jax_device, peaks
    from greyjack_tpu.models.vrp import CotwinBuilder, generate_instance
    from greyjack_tpu.score_calculation.score_requesters import ScoreRequester
    from greyjack_tpu.agents import TabuSearch
    from greyjack_tpu.agents.termination_strategies import StepsLimit
    from greyjack_tpu.parallel import IslandRunner
    from greyjack_tpu.ops import moves

    device = jax_device()
    print(f"device: {device}", flush=True)
    if device["platform"] != "gpu":
        raise SystemExit("time_chunk_paths: needs a GPU")
    card = card_line()
    print(f"card: {card}", flush=True)
    enable_compile_cache()

    domain = generate_instance(1000, 8, 40, seed=37, time_windowed=True)
    cotwin = CotwinBuilder(True, True).build_cotwin(domain, False)
    req = ScoreRequester(cotwin)

    class F64Requester(ScoreRequester):
        def supports_delta_ints(self, delta_width):
            return False

    req_f64 = F64Requester(cotwin)
    result = {"device": device, "card": card, "geometry": {
        "n": 1000, "islands": ISLANDS, "neighbours": NEIGHBOURS,
        "targets": TARGETS, "chunk_steps": CHUNK}, "chunks": {}}

    for name, r, sweep in [("sweep", req, True), ("int-delta", req, False),
                           ("f64-delta", req_f64, False)]:
        agent = TabuSearch(NEIGHBOURS, 0.2, True, None, CHANGE_SWAP, CHUNK,
                           StepsLimit(10**9), sweep=sweep,
                           sweep_targets=TARGETS)
        kernel = agent.build_kernel(r, None)
        runner = IslandRunner(kernel, n_islands=ISLANDS,
                              migration_frequency=CHUNK)
        state = runner.init(jax.random.key(0))
        alive = jnp.ones((ISLANDS,), bool)
        t0 = time.perf_counter()
        state = runner.run_chunk(state, jax.random.key(1), alive, {}, CHUNK)
        jax.block_until_ready(state)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(args.chunks):
            state = runner.run_chunk(state, jax.random.key(2 + i), alive, {},
                                     CHUNK)
        jax.block_until_ready(state)
        per_chunk = (time.perf_counter() - t0) / args.chunks
        moves_per_chunk = ISLANDS * CHUNK * kernel.moves_per_step
        rec = {"path": kernel.path, "first_chunk_s": first,
               "s_per_chunk": per_chunk,
               "moves_per_s": moves_per_chunk / per_chunk}
        result["chunks"][name] = rec
        print(f"chunk {name}: {json.dumps(rec)}", flush=True)

    # --- stage attribution of the random-move step -------------------------
    vm = req.variables_manager
    cfg = moves.MoverConfig(vm, 0.2, None, CHANGE_SWAP)
    tabu = cfg.init_tabu_state()
    base = vm.sample_variables(jax.random.key(0), 1)[0]
    ctx = jax.jit(req.build_base_ctx)(base)

    def sample(key):
        keys = jax.random.split(key, ISLANDS)
        return jax.vmap(lambda k: moves.move_population_delta(
            k, base, NEIGHBOURS, vm, cfg, tabu)[0])(keys)

    def score_ints(deltas):
        return jax.vmap(lambda d: req.request_score_delta_ints(ctx, d))(deltas)

    def score_f64(deltas):
        return jax.vmap(lambda d: req.request_score_delta(ctx, d))(deltas)

    def fold(c, x):
        acc, key = c
        return acc + (x.reshape(-1)[0] % 7).astype(jnp.int32), \
            jax.random.fold_in(key, acc)

    c0 = (jnp.int32(0), jax.random.key(5))
    stages = {
        "sample": scan_time(lambda c: fold(c, sample(c[1])["positions"]), c0),
        "ints": scan_time(lambda c: fold(c, score_ints(sample(c[1]))), c0),
        "f64": scan_time(lambda c: fold(c, score_f64(sample(c[1])).astype(
            jnp.int32)), c0),
    }
    agent = TabuSearch(NEIGHBOURS, 0.2, True, None, CHANGE_SWAP, CHUNK,
                       StepsLimit(10**9))
    kernel = agent.build_kernel(req, None)
    st0 = jax.jit(jax.vmap(kernel.init_state))(
        jax.random.split(jax.random.key(3), ISLANDS))

    def b_step(st):
        ex = dict(kernel.prestep(st)) if kernel.prestep is not None else {}
        keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(11), s))(
            st["step_id"])
        return jax.vmap(kernel.step)(keys, st, ex)

    stages["step"] = scan_time(b_step, st0)
    result["stages_s"] = stages
    score_s = max(stages["ints"] - stages["sample"], 1e-12)
    result["delta_scoring_share_of_step"] = score_s / stages["step"]

    deltas0 = jax.jit(sample)(jax.random.key(9))
    cost = jax.jit(score_ints).lower(deltas0).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    nbytes = float((cost or {}).get("bytes accessed", 0.0))
    roof = {"xla_bytes_accessed": nbytes,
            "achieved_bytes_per_s": nbytes / score_s}
    pk = peaks()
    if pk is not None:
        roof["hbm_roofline_share"] = nbytes / score_s / pk["hbm_bytes_per_s"]
    result["int_scoring_roofline"] = roof
    print(f"stages: {json.dumps(stages)}", flush=True)
    print(f"roofline: {json.dumps(roof)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
