"""Per-metaheuristic throughput + quality table (VERDICT r4 item 2).

One chip, fixed wall budget per configuration. Two workloads:

  * flagship VRP  — synthetic-tw-d8-n1000-k40 (the BASELINE north-star
    geometry): all five metaheuristics, random-move and (where available)
    sweep paths;
  * mixedint      — rastrigin over 50 floats + 50 ints (the reference's
    LSHADE home turf, `lshade_base.rs` header).

moves/s accounting uses the kernel's own `moves_per_step` (a static LOWER
bound for sweep kernels — no device reads), matching BENCH_r04's
conservative convention. Quality is the final global-best score row.

Usage:
  python scripts/bench_mh.py --seconds 60 --out chiprun_out/bench_mh.json
  GJ_SMALL=1 python scripts/bench_mh.py   (CI smoke: tiny shapes, 3 s)
"""

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def bench_one(kernel, islands, chunk_steps, seconds, score_size):
    import jax
    import jax.numpy as jnp

    from greyjack_tpu.parallel import IslandRunner

    runner = IslandRunner(kernel, n_islands=islands,
                          migration_frequency=chunk_steps)
    state = runner.init(jax.random.key(7))
    alive = jnp.ones((islands,), bool)
    extras = {}
    if kernel.builder.metaheuristic_name == "SimulatedAnnealing" \
            and kernel.builder.cooling_rate is None:
        extras = {
            "inverted_accomplish_rate": jnp.full((islands,), 0.5,
                                                 jnp.float64),
            "inverted_accomplish_rate_end": jnp.full((islands,), 0.5,
                                                     jnp.float64),
        }

    # compile + warm outside the clock
    state = runner.run_chunk(state, jax.random.key(1), alive, extras,
                             chunk_steps)
    jax.block_until_ready(state)
    _ = np.asarray(state["global_score"])  # first device read off the clock

    chunks = 0
    t0 = time.time()
    while time.time() - t0 < seconds:
        state = runner.run_chunk(state, jax.random.key(100 + chunks), alive,
                                 extras, chunk_steps)
        chunks += 1
        if chunks % 8 == 0:
            jax.block_until_ready(state)
    jax.block_until_ready(state)
    elapsed = time.time() - t0
    moves = chunks * chunk_steps * islands * (kernel.moves_per_step or 1)
    row = np.asarray(state["global_score"])
    return {
        "kernel_path": kernel.path,
        "islands": islands,
        "moves_per_step_per_island": int(kernel.moves_per_step or 1),
        "chunks": chunks,
        "seconds": round(elapsed, 2),
        "moves_per_s": round(moves / elapsed, 1),
        "final_score": [round(float(x), 6) for x in row[:score_size]],
    }


def vrp_configs(small):
    from greyjack_tpu.agents import (TabuSearch, LateAcceptance,
                                     SimulatedAnnealing, GeneticAlgorithm,
                                     LSHADE)
    from greyjack_tpu.agents.termination_strategies import StepsLimit

    lim = StepsLimit(10**9)
    probas = [0.5, 0.5, 0.0, 0.0, 0.0, 0.0]
    nb = 256 if small else 2048
    tg = 8 if small else 64
    pop = 32 if small else 128
    # (name, builder, islands, chunk_steps)
    isl = 2 if small else 8
    isl_hi = 4 if small else 512
    isl_mid = 4 if small else 64
    return [
        ("TS-sweep", TabuSearch(nb, 0.2, True, None, probas, 10, lim,
                                sweep=True, sweep_targets=tg), isl, 10),
        ("TS-random", TabuSearch(nb, 0.2, True, None, probas, 10, lim),
         isl, 10),
        ("LA-sweep", LateAcceptance(200, 0.2, None, probas, 10, lim,
                                    sweep=True, sweep_targets=tg), isl, 10),
        ("LA-random", LateAcceptance(200, 0.2, None, probas, 10, lim),
         isl_hi, 10),
        ("SA-sweep", SimulatedAnnealing([1000.0, 1000.0, 1.0], 0.9999, 0.2,
                                        None, probas, 10, lim, sweep=True,
                                        sweep_targets=tg), isl, 10),
        ("SA-random", SimulatedAnnealing([1000.0, 1000.0, 1.0], 0.9999, 0.2,
                                         None, probas, 10, lim), isl_hi, 10),
        ("GA", GeneticAlgorithm(pop, 0.5, 0.05, 0.2, None, probas, 0.1, 10,
                                lim), isl, 10),
        ("LSHADE", LSHADE(pop, pop, 0.2, 0.1, 1, 0.5, 0.9, 0.5, 0.2, None,
                          probas, 0.1, 10, lim), isl, 10),
        # population MHs scale on the island axis (every candidate is a
        # fresh full rescore — reference GA panics on incremental mode,
        # `genetic_algorithm_base.rs:189-196`); the wide geometry shows
        # the throughput headroom of a wide island axis
        ("GA-wide", GeneticAlgorithm(pop, 0.5, 0.05, 0.2, None, probas, 0.1,
                                     10, lim), isl_mid, 10),
        ("LSHADE-wide", LSHADE(pop, pop, 0.2, 0.1, 1, 0.5, 0.9, 0.5, 0.2,
                               None, probas, 0.1, 10, lim), isl_mid, 10),
    ]


def mixedint_configs(small):
    from greyjack_tpu.agents import GeneticAlgorithm, LSHADE, TabuSearch
    from greyjack_tpu.agents.termination_strategies import StepsLimit

    lim = StepsLimit(10**9)
    probas = [1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    pop = 32 if small else 128
    isl = 2 if small else 8
    return [
        ("GA", GeneticAlgorithm(pop, 0.5, 0.05, 0.0, None, probas, 0.1, 10,
                                lim), isl, 10),
        ("LSHADE", LSHADE(pop, pop, 0.2, 0.1, 1, 0.5, 0.9, 0.5, 0.0, None,
                          probas, 0.1, 10, lim), isl, 10),
        ("TS-random", TabuSearch(pop, 0.0, True, None, probas, 10, lim),
         isl, 10),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--out", default="chiprun_out/bench_mh.json")
    ap.add_argument("--small", action="store_true",
                    default=bool(os.environ.get("GJ_SMALL")))
    ap.add_argument("--only", default=None,
                    help="comma-separated config names to run")
    args = ap.parse_args()

    import jax

    from greyjack_tpu.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_secs=1.0)

    from greyjack_tpu.models.vrp import (CotwinBuilder as VrpCotwin,
                                         generate_instance)
    from greyjack_tpu.models.mixedint import (CotwinBuilder as MixCotwin,
                                              DomainBuilder as MixDomain)
    from greyjack_tpu.score_calculation.score_requesters import ScoreRequester

    seconds = 3.0 if args.small else args.seconds
    only = set(args.only.split(",")) if args.only else None

    if args.small:
        vrp_domain = generate_instance(60, 2, 8, seed=37, time_windowed=True)
    else:
        vrp_domain = generate_instance(1000, 8, 40, seed=37,
                                       time_windowed=True)
    vrp_req = ScoreRequester(VrpCotwin(True, True).build_cotwin(vrp_domain,
                                                                False))
    nf, ni = (8, 8) if args.small else (50, 50)
    mix_domain = MixDomain(nf, ni, objective="rastrigin") \
        .build_domain_from_scratch()
    mix_req = ScoreRequester(MixCotwin().build_cotwin(mix_domain, False))

    results = {"vrp": {}, "mixedint": {},
               "workloads": {
                   "vrp": ("synthetic-tw-d2-n60-k8" if args.small
                           else "synthetic-tw-d8-n1000-k40"),
                   "mixedint": f"rastrigin {nf}f+{ni}i"},
               "seconds_per_config": seconds,
               "platform": jax.devices()[0].platform}
    for name, agent, islands, chunk in vrp_configs(args.small):
        if only and name not in only:
            continue
        kernel = agent.build_kernel(vrp_req, None)
        rec = bench_one(kernel, islands, chunk, seconds, vrp_req.score_size)
        results["vrp"][name] = rec
        print("vrp", name, json.dumps(rec), flush=True)
    for name, agent, islands, chunk in mixedint_configs(args.small):
        if only and name not in only:
            continue
        kernel = agent.build_kernel(mix_req, None)
        rec = bench_one(kernel, islands, chunk, seconds, mix_req.score_size)
        results["mixedint"][name] = rec
        print("mixedint", name, json.dumps(rec), flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
