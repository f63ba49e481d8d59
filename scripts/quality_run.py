"""Time-boxed solution-quality run against the reference's anchor ratios.

The reference encodes known optima / greedy first-fit values for its belgium
VRP instances in example comments (`examples/vrp/src/main.rs:23-39`, e.g.
belgium-tw-d8-n1000-k40: optimum ~58.1 vs first-fit ~154.565 -> ratio 0.376).
The repo ships no data files, so quality is measured on synthetic analogs of
the same geometry: the anchor is the instance's OWN greedy first-fit score
(the identical greedy the reference uses, `cotwin_builder.rs:153-255`), and
the figure of merit is achieved/first_fit after a fixed wall-time budget —
directly comparable to the reference's published optimum/first_fit ratios.

Writes one JSON record per instance to --out.

Usage:
  python scripts/quality_run.py --seconds 120 --out chiprun_out/quality_run.json
  GJ_SMALL=1 ... (CI smoke: n=60, CPU-friendly)
"""

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def run_instance(n_customers, n_depots, k_vehicles, seconds, islands,
                 neighbours, chunk_steps, seed, anchor_ratio=None,
                 time_windowed=True):
    import jax
    import jax.numpy as jnp
    from greyjack_tpu.models.vrp import CotwinBuilder, generate_instance
    from greyjack_tpu.score_calculation.score_requesters import ScoreRequester
    from greyjack_tpu.agents import TabuSearch
    from greyjack_tpu.agents.termination_strategies import StepsLimit
    from greyjack_tpu.parallel import IslandRunner

    t_setup = time.time()
    domain = generate_instance(n_customers, n_depots, k_vehicles, seed=seed,
                               time_windowed=time_windowed)
    cotwin = CotwinBuilder(True, True).build_cotwin(domain, False)
    req = ScoreRequester(cotwin)

    # greedy first-fit anchor: score the initial (greedy) chromosome itself.
    # The np.asarray read is the process's FIRST device->host transfer, so
    # it is timed separately from framework setup.
    init_row = req.variables_manager.initial_values[None, :]
    first_fit_dev = req.request_score_plain(init_row)
    import jax as _jax
    _jax.block_until_ready(first_fit_dev)
    t_read = time.time()
    first_fit_row = np.asarray(first_fit_dev)[0]
    first_read_s = time.time() - t_read

    agent = TabuSearch(neighbours, 0.2, True, None,
                       [0.5, 0.5, 0.0, 0.0, 0.0, 0.0], chunk_steps,
                       StepsLimit(10**9))
    kernel = agent.build_kernel(req, None)
    runner = IslandRunner(kernel, n_islands=islands,
                          migration_frequency=chunk_steps)
    state = runner.init(jax.random.key(seed))
    alive = jnp.ones((islands,), bool)
    setup_s = time.time() - t_setup

    # compile outside the time box
    t0 = time.time()
    state = runner.run_chunk(state, jax.random.key(1), alive, {}, chunk_steps)
    jax.block_until_ready(state)
    compile_s = time.time() - t0

    chunks = 0
    t0 = time.time()
    while time.time() - t0 < seconds:
        state = runner.run_chunk(state, jax.random.key(100 + chunks), alive,
                                 {}, chunk_steps)
        chunks += 1
        if chunks % 8 == 0:
            jax.block_until_ready(state)
    jax.block_until_ready(state)
    solve_s = time.time() - t0

    best_row = np.asarray(state["global_score"])
    moves = (chunks + 1) * islands * neighbours * chunk_steps
    tag = "tw-" if time_windowed else ""
    rec = {
        "instance": f"synthetic-{tag}d{n_depots}-n{n_customers}-k{k_vehicles}",
        "seed": seed,
        "config": {"islands": islands, "neighbours": neighbours,
                   "chunk_steps": chunk_steps},
        "first_fit_score": first_fit_row.tolist(),
        "achieved_score": best_row.tolist(),
        "achieved_over_first_fit_soft": (
            float(best_row[-1]) / float(first_fit_row[-1])
            if first_fit_row[-1] else None),
        "hard_feasible": bool(best_row[0] == 0.0),
        "medium_late": float(best_row[1]) if best_row.shape[0] > 2 else None,
        # NOTE: on tight-time-window instances the greedy first fit is
        # hard-feasible but massively LATE (medium >> 0); the solver drives
        # medium to 0 first (lexicographic order, `hard_medium_soft_score.
        # rs:96-117`), trading soft distance up — so the soft ratio is only
        # a like-for-like quality anchor when first-fit medium ~ 0 (the
        # non-tw instances below). The medium elimination itself is the
        # quality evidence on tw instances.
        "first_fit_medium_late": (float(first_fit_row[1])
                                  if first_fit_row.shape[0] > 2 else None),
        # (the belgium optimum/first-fit anchor field was dropped in r4:
        # a real-instance anchor against a synthetic instance is apples to
        # oranges — head-to-head evidence comes from scripts/quality_race.py, which
        # races the actual reference algorithm on the SAME instance)
        "wall_seconds": {"setup": round(setup_s - first_read_s, 1),
                         "first_device_read": round(first_read_s, 1),
                         "compile": round(compile_s, 1),
                         "solve": round(solve_s, 1)},
        "scored_moves": moves,
        "platform": jax.devices()[0].platform,
    }
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--out", default="chiprun_out/quality_run.json")
    ap.add_argument("--small", action="store_true",
                    default=bool(os.environ.get("GJ_SMALL")))
    args = ap.parse_args()

    from greyjack_tpu.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_secs=1.0)

    if args.small:
        # CI smoke: tiny instance, short box
        plans = [(60, 2, 8, min(args.seconds, 30.0), 2, 256, 10, 37, None,
                  True)]
    else:
        plans = [
            # analog of belgium-tw-d8-n1000-k40 (optimum/first-fit ~0.376,
            # `examples/vrp/src/main.rs:37`)
            (1000, 8, 40, args.seconds, 8, 2048, 10, 37, 58.1 / 154.565,
             True),
            # analog of belgium-tw-d5-n500-k20 (~0.347, `main.rs:36`)
            (500, 5, 20, args.seconds, 8, 2048, 10, 37, 43.3 / 124.884,
             True),
            # analog of plain belgium-n1000-k40 (optimum/first-fit
            # ~57.7/195.3 = 0.295, `main.rs:27`): no time windows, so the
            # greedy first fit is the like-for-like soft anchor
            (1000, 8, 40, args.seconds, 8, 2048, 10, 37, 57.7 / 195.3,
             False),
        ]

    records = []
    for plan in plans:
        rec = run_instance(*plan)
        print(json.dumps(rec), flush=True)
        records.append(rec)

    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
