"""Largest-anchor capability smoke (round 5): the reference's example lists
go up to belgium-tw-d10-n2750-k55 (`examples/vrp/src/main.rs:39`) and
fnl4461 (`examples/tsp/src/main.rs:32`). This script runs the sweep solver
at those sizes on one chip for a fixed budget and records throughput +
trajectory feasibility — evidence the kernels' static bounds (route_cap,
i32 accumulators, f32-exact one-hot matmuls) hold at production scale.

Usage: python scripts/big_instance_smoke.py --seconds 60 --out chiprun_out/big_instance.json
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def run_vrp(seconds, islands=8, targets=64):
    import jax
    import jax.numpy as jnp

    from greyjack_tpu.models.vrp import CotwinBuilder, generate_instance
    from greyjack_tpu.score_calculation.score_requesters import ScoreRequester
    from greyjack_tpu.agents import TabuSearch
    from greyjack_tpu.agents.termination_strategies import StepsLimit
    from greyjack_tpu.parallel import IslandRunner

    domain = generate_instance(2750, 10, 55, seed=37, time_windowed=True)
    req = ScoreRequester(CotwinBuilder(True, True).build_cotwin(domain, False))
    agent = TabuSearch(2048, 0.2, True, None, [0.5, 0.5, 0, 0, 0, 0], 10,
                       StepsLimit(10**9), sweep=True, sweep_targets=targets)
    kernel = agent.build_kernel(req, None)
    assert kernel.path == "sweep", kernel.path
    runner = IslandRunner(kernel, n_islands=islands, migration_frequency=10)
    state = runner.init(jax.random.key(37))
    alive = jnp.ones((islands,), bool)
    t0 = time.time()
    state = runner.run_chunk(state, jax.random.key(1), alive, {}, 10)
    jax.block_until_ready(state)
    compile_s = time.time() - t0
    init_row = np.asarray(state["global_score"])
    chunks = 0
    t0 = time.time()
    while time.time() - t0 < seconds:
        state = runner.run_chunk(state, jax.random.key(100 + chunks), alive,
                                 {}, 10)
        chunks += 1
        if chunks % 4 == 0:
            jax.block_until_ready(state)
    jax.block_until_ready(state)
    elapsed = time.time() - t0
    row = np.asarray(state["global_score"])
    scored = int(np.asarray(state["islands"]["sweep_scored"]).sum())
    return {
        "instance": "synthetic-tw-d10-n2750-k55 (belgium-tw-d10-n2750-k55 "
                    "analog, main.rs:39)",
        "kernel_path": kernel.path, "islands": islands, "targets": targets,
        "compile_s": round(compile_s, 1), "seconds": round(elapsed, 2),
        "scored_moves_per_s": round(scored / elapsed, 1),
        "greedy_init_score": init_row.tolist(),
        "final_score": row.tolist(),
        "feasible": bool(row[0] == 0.0),
    }


def run_tsp(seconds, islands=8, targets=64):
    import jax
    import jax.numpy as jnp

    from greyjack_tpu.models.tsp import (CotwinBuilder,
                                         generate_uniform_instance)
    from greyjack_tpu.score_calculation.score_requesters import ScoreRequester
    from greyjack_tpu.agents import TabuSearch
    from greyjack_tpu.agents.termination_strategies import StepsLimit
    from greyjack_tpu.parallel import IslandRunner

    domain = generate_uniform_instance(4461, seed=37)
    req = ScoreRequester(CotwinBuilder(True, True).build_cotwin(domain, False))
    agent = TabuSearch(1024, 0.5, True, None, [0, .2, .2, .2, .2, .2], 10,
                       StepsLimit(10**9), sweep=True, sweep_targets=targets)
    kernel = agent.build_kernel(req, None)
    assert kernel.path == "sweep", kernel.path
    runner = IslandRunner(kernel, n_islands=islands, migration_frequency=10)
    state = runner.init(jax.random.key(37))
    alive = jnp.ones((islands,), bool)
    t0 = time.time()
    state = runner.run_chunk(state, jax.random.key(1), alive, {}, 10)
    jax.block_until_ready(state)
    compile_s = time.time() - t0
    init_row = np.asarray(state["global_score"])
    chunks = 0
    t0 = time.time()
    while time.time() - t0 < seconds:
        state = runner.run_chunk(state, jax.random.key(100 + chunks), alive,
                                 {}, 10)
        chunks += 1
        if chunks % 4 == 0:
            jax.block_until_ready(state)
    jax.block_until_ready(state)
    elapsed = time.time() - t0
    row = np.asarray(state["global_score"])
    scored = int(np.asarray(state["islands"]["sweep_scored"]).sum())
    return {
        "instance": "synthetic-tsp-n4461 (fnl4461-size analog, main.rs:32)",
        "kernel_path": kernel.path, "islands": islands, "targets": targets,
        "compile_s": round(compile_s, 1), "seconds": round(elapsed, 2),
        "scored_moves_per_s": round(scored / elapsed, 1),
        "greedy_init_score": init_row.tolist(),
        "final_score": row.tolist(),
        "feasible": bool(row[0] == 0.0),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--out", default="chiprun_out/big_instance.json")
    args = ap.parse_args()

    import jax

    from greyjack_tpu.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_secs=1.0)

    out = {"platform": jax.devices()[0].platform}
    out["vrp_n2750"] = run_vrp(args.seconds)
    print(json.dumps(out["vrp_n2750"]), flush=True)
    out["tsp_n4461"] = run_tsp(args.seconds)
    print(json.dumps(out["tsp_n4461"]), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
