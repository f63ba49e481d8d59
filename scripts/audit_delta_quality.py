"""A/B quality audit of the delta path's behavioural divergences.

VERDICT r1 weak-item 6: the delta (incremental) path caps insertion/inverse
windows at DELTA_MOVE_SIZE-1 slots (`ops/moves.py`) and rejects over-cap
route rebuilds with a stub score (`models/vrp/cotwin_builder.py`), changing
the neighbourhood distribution vs plain mode. Score parity is proven
elsewhere (tests/test_delta_scoring.py); this audit measures whether SEARCH
QUALITY regresses: same seeds, same step budget, TabuSearch with
insertion+inverse-heavy move probabilities, delta mode vs plain mode.

Writes chiprun_out/audit_delta_quality.json: per seed, the achieved score rows of both
modes and the soft-score ratio delta/plain (<= 1.0 means the delta path is
no worse).

Run (CPU is fine — quality is hardware-independent):
  JAX_PLATFORMS=cpu python scripts/audit_delta_quality.py
"""

import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

N = int(os.environ.get("GJ_AUDIT_N", "200"))
D = int(os.environ.get("GJ_AUDIT_D", "3"))
K = int(os.environ.get("GJ_AUDIT_K", "10"))
STEPS = int(os.environ.get("GJ_AUDIT_STEPS", "300"))
NEIGHBOURS = int(os.environ.get("GJ_AUDIT_NEIGHBOURS", "256"))
SEEDS = [int(s) for s in os.environ.get("GJ_AUDIT_SEEDS",
                                        "11,23,42").split(",")]
# default: insertion/inverse-heavy (the moves whose windows the delta path
# caps); GJ_AUDIT_PROBAS overrides, e.g. all six for the flagship audit
PROBAS = [float(x) for x in os.environ.get(
    "GJ_AUDIT_PROBAS", "0.2,0.2,0,0,0.3,0.3").split(",")]


def run(mode_incremental, seed):
    import jax
    import jax.numpy as jnp
    from greyjack_tpu.models.vrp import CotwinBuilder, generate_instance
    from greyjack_tpu.score_calculation.score_requesters import ScoreRequester
    from greyjack_tpu.agents import TabuSearch
    from greyjack_tpu.agents.termination_strategies import StepsLimit
    from greyjack_tpu.parallel import IslandRunner

    domain = generate_instance(N, D, K, seed=37, time_windowed=True)
    cotwin = CotwinBuilder(mode_incremental, True).build_cotwin(domain, False)
    req = ScoreRequester(cotwin)
    agent = TabuSearch(NEIGHBOURS, 0.2, True, None, PROBAS, 10,
                       StepsLimit(10**9))
    kernel = agent.build_kernel(req, None)
    runner = IslandRunner(kernel, n_islands=2, migration_frequency=10)
    state = runner.init(jax.random.key(seed))
    alive = jnp.ones((2,), bool)
    t0 = time.time()
    for c in range(STEPS // 10):
        state = runner.run_chunk(state, jax.random.key(1000 * seed + c),
                                 alive, {}, 10)
    jax.block_until_ready(state)
    return (np.asarray(state["global_score"]).tolist(),
            round(time.time() - t0, 1))


def main():
    from greyjack_tpu.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_secs=0.5)

    records = []
    for seed in SEEDS:
        delta_score, delta_s = run(True, seed)
        plain_score, plain_s = run(False, seed)
        ratio = (delta_score[-1] / plain_score[-1]
                 if plain_score[-1] else None)
        rec = {"seed": seed, "steps": STEPS, "neighbours": NEIGHBOURS,
               "instance": f"synthetic-tw-d{D}-n{N}-k{K}",
               "move_probas": PROBAS,
               "delta_mode_score": delta_score,
               "plain_mode_score": plain_score,
               "delta_over_plain_soft": ratio,
               "wall_s": {"delta": delta_s, "plain": plain_s}}
        print(json.dumps(rec), flush=True)
        records.append(rec)

    ratios = [r["delta_over_plain_soft"] for r in records
              if r["delta_over_plain_soft"]]
    summary = {"mean_delta_over_plain_soft": round(float(np.mean(ratios)), 4),
               "records": records}
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out",
        "audit_delta_quality.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {out}: mean ratio "
          f"{summary['mean_delta_over_plain_soft']}", flush=True)


if __name__ == "__main__":
    main()
