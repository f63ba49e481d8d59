"""Benchmark: scored moves/s on the flagship VRP workload, on one GPU.

Workload: synthetic multi-depot time-windowed CVRP with 1000 customers, 8
depots, 40 vehicles (the belgium-tw-d8-n1000-k40 analog from the reference's
example list — the repo ships no data files, so the instance is generated,
`examples/vrp/src/main.rs:37`). Solver config: TabuSearch islands, each
scoring a full neighborhood batch per step — the BASELINE "scored moves per
second" metric counts every candidate whose full score row is computed.

vs_baseline divides by a 64-thread CPU run of the reference's fused
incremental VRP rescore, measured by `scripts/measure_cpu_baseline.py` (a
C++ port driven TabuSearch-style, `incremental_score_calculator.rs:55-139`,
per-thread throughput x 64) and kept in BASELINE_CPU.json.

The run fails unless JAX's first device is a GPU. `JAX_PLATFORMS=cpu`
rehearses it on the CPU (with `GJ_BENCH_CUSTOMERS=60 GJ_BENCH_SECONDS=5` to
shrink it); the output then names the CPU.

Output: device lines, then one JSON line
{"metric", "value", "unit", "vs_baseline", "device"}.
"""

import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_ROOT, "BASELINE_CPU.json")) as _f:
    REFERENCE_CPU_BASELINE = json.load(_f)["moves_per_s_64t"]

N_CUSTOMERS = int(os.environ.get("GJ_BENCH_CUSTOMERS", "1000"))
N_DEPOTS = 8
K_VEHICLES = 40
N_ISLANDS = int(os.environ.get("GJ_BENCH_ISLANDS", "8"))
NEIGHBOURS = int(os.environ.get("GJ_BENCH_NEIGHBOURS", "4096"))
CHUNK_STEPS = int(os.environ.get("GJ_BENCH_CHUNK_STEPS", "10"))
TARGET_SECONDS = float(os.environ.get("GJ_BENCH_SECONDS", "20"))
# sweep-neighbourhood mode (models/vrp/sweep.py): per island-step, score
# every candidate value for SWEEP_TARGETS sampled stops (change + vehicle +
# swap families) from route cumulants instead of NEIGHBOURS random moves.
# The rate uses the CONSERVATIVE static lower bound
# (`SweepConfig.conservative_moves_per_step`); the exact device counter
# (incl. the vehicle family) is printed after the timed window.
SWEEP = os.environ.get("GJ_BENCH_SWEEP", "1") != "0"
SWEEP_TARGETS = int(os.environ.get("GJ_SWEEP_TARGETS", "256"))
TABU_RATE = 0.2


def main():
    sys.path.insert(0, _ROOT)
    import jax
    import jax.numpy as jnp

    from greyjack_tpu.compile_cache import enable_compile_cache
    from greyjack_tpu.utils.device_info import card_line, jax_device

    device = jax_device()
    print(f"# device: platform={device['platform']} kind={device['kind']} "
          f"count={device['count']}", flush=True)
    rehearsal = os.environ.get("JAX_PLATFORMS") == "cpu"
    if device["platform"] != "gpu" and not rehearsal:
        raise SystemExit(f"bench: needs a GPU, JAX found "
                         f"{device['platform']} (set JAX_PLATFORMS=cpu to "
                         f"rehearse on the CPU)")
    print(f"# card: {card_line() if not rehearsal else 'none (cpu rehearsal)'}",
          flush=True)
    enable_compile_cache(min_compile_secs=1.0)

    from greyjack_tpu.models.vrp import CotwinBuilder, generate_instance
    from greyjack_tpu.score_calculation.score_requesters import ScoreRequester
    from greyjack_tpu.agents import TabuSearch
    from greyjack_tpu.agents.termination_strategies import StepsLimit
    from greyjack_tpu.parallel import IslandRunner

    t0 = time.time()
    domain = generate_instance(N_CUSTOMERS, N_DEPOTS, K_VEHICLES, seed=37,
                               time_windowed=True)
    # greedy init runs host-side in numpy, so the bench starts from the
    # reference's own greedy solution (`cotwin_builder.rs:153-255`)
    cotwin = CotwinBuilder(True, True).build_cotwin(domain, False)
    req = ScoreRequester(cotwin)
    agent = TabuSearch(NEIGHBOURS, TABU_RATE, True, None,
                       [0.5, 0.5, 0.0, 0.0, 0.0, 0.0], CHUNK_STEPS,
                       StepsLimit(10**9), sweep=SWEEP,
                       sweep_targets=SWEEP_TARGETS)
    kernel = agent.build_kernel(req, None)
    print(f"# kernel path: {kernel.path}", flush=True)
    moves_per_step = kernel.moves_per_step
    runner = IslandRunner(kernel, n_islands=N_ISLANDS,
                          migration_frequency=CHUNK_STEPS)
    print(f"# setup {time.time()-t0:.1f}s", flush=True)

    key = jax.random.key(0)
    state = runner.init(key)
    alive = jnp.ones((N_ISLANDS,), bool)

    # warmup/compile
    t0 = time.time()
    state = runner.run_chunk(state, jax.random.key(1), alive, {}, CHUNK_STEPS)
    jax.block_until_ready(state)
    print(f"# compile+first chunk {time.time()-t0:.1f}s", flush=True)

    moves_per_chunk = N_ISLANDS * moves_per_step * CHUNK_STEPS
    chunks = 0
    t0 = time.time()
    while True:
        state = runner.run_chunk(state, jax.random.key(100 + chunks), alive,
                                 {}, CHUNK_STEPS)
        chunks += 1
        if chunks % 4 == 0:
            jax.block_until_ready(state)
            if time.time() - t0 > TARGET_SECONDS:
                break
    jax.block_until_ready(state)
    elapsed = time.time() - t0
    throughput = chunks * moves_per_chunk / elapsed
    print(f"# {chunks} chunks in {elapsed:.2f}s", flush=True)
    # read back after the timed window
    best = np.asarray(state["global_score"])
    print(f"# best score {best.tolist()}", flush=True)
    if "sweep_scored" in state["islands"]:
        exact_moves = int(np.asarray(state["islands"]["sweep_scored"]).sum())
        print(f"# exact scored-move counter {exact_moves} "
              f"(counted {(chunks + 1) * moves_per_chunk})", flush=True)
    print(json.dumps({
        "metric": "vrp_scored_moves_per_s",
        "value": round(throughput, 1),
        "unit": "moves/s",
        "vs_baseline": round(throughput / REFERENCE_CPU_BASELINE, 3),
        "device": device,
    }), flush=True)


if __name__ == "__main__":
    main()
