"""Smoke run of the solver's main path on one NVIDIA GPU.

    python chip_smoke.py               # one card, every phase
    python chip_smoke.py --four-cards  # the island mesh over four cards

Each phase goes through `Solver.solve`, the entry point a user calls, at the
flagship size (VRP with time windows, n=1000 customers, 8 depots, 40
vehicles; TSP n=1000; mixedint rastrigin 50 floats + 50 ints) for a few
chunks, and re-scores the returned solution with the plain scorer: the
reported score row must come back exactly. Instances are generated from
fixed seeds. The script stops at the first failure with a non-zero exit;
the last line of a passing run is one JSON object naming the device.

There is no CPU fallback: the run fails unless JAX's first device is a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from greyjack_tpu.compile_cache import enable_compile_cache  # noqa: E402
from greyjack_tpu.agents import GeneticAlgorithm, LSHADE, TabuSearch  # noqa: E402
from greyjack_tpu.agents.termination_strategies import StepsLimit  # noqa: E402
from greyjack_tpu.models import mixedint, tsp, vrp  # noqa: E402
from greyjack_tpu.ops import lexico, moves  # noqa: E402
from greyjack_tpu.parallel import IslandRunner, make_island_mesh  # noqa: E402
from greyjack_tpu.score_calculation.score_requesters import ScoreRequester  # noqa: E402
from greyjack_tpu.solver import Solver, SolverLoggingLevels  # noqa: E402
from greyjack_tpu.solver.metrics import SolverMetrics  # noqa: E402
from greyjack_tpu.utils.device_info import card_line, jax_device  # noqa: E402

CHANGE_SWAP = [0.5, 0.5, 0.0, 0.0, 0.0, 0.0]

# the flagship geometry (bench.py): sweep TabuSearch over 8 islands x 256
# targets, random-move TabuSearch over 8 islands x 4096 neighbours
FULL = SimpleNamespace(n=1000, depots=8, vehicles=40, islands=8, targets=256,
                       neighbours=4096, chunk=10, chunks=3, tsp_n=1000,
                       tsp_targets=64, pop=128, n_floats=50, n_ints=50)


def log(msg):
    print(msg, flush=True)


def phase_device():
    dev = jax_device()
    log(f"device: platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}")
    if dev["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{dev['platform']}")
    log(f"card: {card_line()}")
    return dev


def vrp_builder(sz):
    return vrp.DomainBuilder.from_generator(
        lambda: vrp.generate_instance(sz.n, sz.depots, sz.vehicles, seed=37,
                                      time_windowed=True))


def rescore_exact(name, domain_builder, cotwin_builder, solution, rtol=0.0):
    """Re-score the returned solution with the plain scorer; its row must
    equal the reported row exactly (`rtol` > 0 only for float objectives,
    see `phase_population`)."""
    domain = domain_builder.build_domain_from_scratch()
    req = ScoreRequester(cotwin_builder.build_cotwin(domain, False))
    vm = req.variables_manager
    row = np.asarray([v for _, v in solution[0]], dtype=vm.float_dtype)
    got = np.asarray(jax.jit(req.request_score_plain)(row[None]))[0].tolist()
    want = [float(v) for v in solution[1].values()]
    if got != want and not np.allclose(got, want, rtol=rtol, atol=0.0):
        raise AssertionError(f"{name}: plain re-score {got} != reported "
                             f"{want}")
    return want


def solve(name, domain_builder, cotwin_builder, agent, n_jobs, mesh=None,
          rtol=0.0):
    """One `Solver.solve` for a few chunks; prints compile and per-chunk
    seconds and the kernel path, then checks the re-score."""
    metrics = SolverMetrics()
    t0 = time.perf_counter()
    solution = Solver.solve(domain_builder, cotwin_builder, agent, n_jobs,
                            logging_level=SolverLoggingLevels.Silent,
                            seed=0, metrics=metrics, mesh=mesh)
    wall = time.perf_counter() - t0
    recs = metrics.records
    first = recs[0]["wall_ms"] / 1e3
    steady = [r["wall_ms"] / 1e3 for r in recs[1:]]
    per_chunk = sum(steady) / len(steady) if steady else float("nan")
    score = rescore_exact(name, domain_builder, cotwin_builder, solution,
                          rtol)
    log(f"phase {name}: ok path={recs[0]['kernel_path']} "
        f"chunks={len(recs)} first_chunk_s={first} "
        f"compile_s~={first - per_chunk} s_per_chunk={per_chunk} "
        f"solve_wall_s={wall} best={score} "
        f"rescore={'exact' if rtol == 0 else f'rtol={rtol}'}")
    return recs[0]["kernel_path"], score


def phase_vrp_sweep(sz, mesh=None, name="vrp-sweep"):
    agent = TabuSearch(sz.neighbours, 0.2, True, None, CHANGE_SWAP, sz.chunk,
                       StepsLimit(sz.chunk * sz.chunks - 1), sweep=True,
                       sweep_targets=sz.targets)
    path, _ = solve(name, vrp_builder(sz), vrp.CotwinBuilder(True, True),
                    agent, sz.islands, mesh=mesh)
    assert path == "sweep", path


def neighbourhood_parity(req, base, key, n_islands, p, probas=CHANGE_SWAP):
    """Score `n_islands` neighbourhoods of `p` random moves around `base`
    three ways: integer delta rows, f64 delta rows, and full plain
    re-scores of the moved candidates. Both delta paths must agree with
    the plain scores exactly (integer sums carried in f64). Neighbours the
    delta path scores as the stub (a route over its static cap) are left
    out of the comparison; returns how many there were."""
    vm = req.variables_manager
    cfg = moves.MoverConfig(vm, 0.2, None, probas)
    assert req.supports_delta_ints(cfg.delta_width)
    tabu = cfg.init_tabu_state()

    @jax.jit
    def score(base, keys):
        ctx = req.build_base_ctx(base)
        deltas = jax.vmap(lambda k: moves.move_population_delta(
            k, base, p, vm, cfg, tabu)[0])(keys)
        ints = jax.vmap(lambda d: req.request_score_delta_ints(ctx, d))(
            deltas)
        f64 = jax.vmap(lambda d: req.request_score_delta(ctx, d))(deltas)
        cands = jax.vmap(jax.vmap(lambda d: moves.apply_delta(base, d)))(
            deltas)
        plain = req.request_score_plain(cands.reshape(-1, base.shape[0]))
        return ints, f64, plain.reshape(f64.shape), req.ctx_int_totals(ctx)

    keys = jax.random.split(key, n_islands)
    ints, f64, plain, totals = (np.asarray(x) for x in score(base, keys))
    assert ints.dtype == np.int32, ints.dtype
    ints, f64, plain = (x.reshape(-1, 3) for x in (ints, f64, plain))
    stub_i = np.all(ints == np.iinfo(np.int32).max, axis=1)
    stub_f = np.all(f64 == np.asarray(lexico.stub_score_row(3)), axis=1)
    np.testing.assert_array_equal(stub_i, stub_f)
    live = ~stub_i
    np.testing.assert_array_equal(f64[live], plain[live])
    scales = np.asarray(req.score_int_scales)
    np.testing.assert_array_equal(
        totals[None, :] + ints[live].astype(np.int64),
        np.rint(plain[live] * scales).astype(np.int64))
    return int(stub_i.sum())


def phase_vrp_int_delta(sz):
    agent = TabuSearch(sz.neighbours, 0.2, True, None, CHANGE_SWAP, sz.chunk,
                       StepsLimit(sz.chunk * sz.chunks - 1))
    path, _ = solve("vrp-int-delta", vrp_builder(sz),
                    vrp.CotwinBuilder(True, True), agent, sz.islands)
    assert path == "int-delta", path
    domain = vrp_builder(sz).build_domain_from_scratch()
    req = ScoreRequester(vrp.CotwinBuilder(True, True).build_cotwin(domain,
                                                                    False))
    base = req.variables_manager.sample_variables(jax.random.key(1), 1)[0]
    stubs = neighbourhood_parity(req, base, jax.random.key(2), 1,
                                 sz.neighbours)
    log(f"phase vrp-int-delta-parity: ok neighbours={sz.neighbours} "
        f"int32 rows and f64 delta rows == plain re-score, "
        f"over-cap stubs={stubs}")


def phase_tsp_sweep(sz):
    builder = tsp.DomainBuilder.from_generator(
        lambda: tsp.generate_uniform_instance(sz.tsp_n, seed=37))
    agent = TabuSearch(sz.neighbours, 0.2, True, None,
                       [0.0, 0.2, 0.2, 0.2, 0.2, 0.2], sz.chunk,
                       StepsLimit(sz.chunk * sz.chunks - 1), sweep=True,
                       sweep_targets=sz.tsp_targets)
    path, _ = solve("tsp-sweep", builder, tsp.CotwinBuilder(True, True),
                    agent, sz.islands)
    assert path == "sweep", path


def phase_population(sz):
    steps = StepsLimit(sz.chunk * sz.chunks - 1)

    def ga(rate, probas):
        return GeneticAlgorithm(sz.pop, 0.5, 0.05, rate, None, probas, 0.1,
                                sz.chunk, steps)

    def lshade(rate, probas):
        return LSHADE(sz.pop, sz.pop, 0.2, 0.1, 1, 0.5, 0.9, 0.5, rate, None,
                      probas, 0.1, sz.chunk, steps)

    mix = mixedint.DomainBuilder(sz.n_floats, sz.n_ints,
                                 objective="rastrigin")
    mix_probas = [1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    # VRP scores are integer sums carried in f64 and re-score exactly. The
    # rastrigin objective is a float sum over 100 terms, which XLA:GPU adds
    # in a different order in the batched solver program than in a batch-1
    # re-score: the two agree to within a few ulp, not bit for bit
    for name, builder, cotwin_builder, agent, rtol in [
            ("ga-vrp", vrp_builder(sz), vrp.CotwinBuilder(True, True),
             ga(0.2, CHANGE_SWAP), 0.0),
            ("lshade-vrp", vrp_builder(sz), vrp.CotwinBuilder(True, True),
             lshade(0.2, CHANGE_SWAP), 0.0),
            ("ga-mixedint", mix, mixedint.CotwinBuilder(),
             ga(0.0, mix_probas), 1e-13),
            ("lshade-mixedint", mix, mixedint.CotwinBuilder(),
             lshade(0.0, mix_probas), 1e-13)]:
        path, _ = solve(name, builder, cotwin_builder, agent, sz.islands,
                        rtol=rtol)
        assert path == "plain", (name, path)


def phase_gpu_tests():
    import pytest

    # the backend is already up on the card; tell the test harness so
    os.environ["JAX_PLATFORMS"] = "cuda"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(REPO / "tests")])
    if rc != 0:
        raise SystemExit(f"chip_smoke: gpu-marked tests failed (rc={rc})")
    log("phase gpu-tests: ok")


def phase_four_cards(sz):
    """The island mesh over four cards against the same islands on one:
    island state sharded over 4 distinct GPUs, and a global best equal to
    the lexicographic minimum of the island tops that re-scores exactly."""
    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"chip_smoke: --four-cards needs 4 devices, "
                         f"found {len(devs)}")
    mesh = make_island_mesh(devs[:4])
    t0 = time.perf_counter()
    phase_vrp_sweep(sz, mesh=mesh, name="vrp-sweep-4cards")
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_vrp_sweep(sz, name="vrp-sweep-1card")
    t_one = time.perf_counter() - t0

    domain = vrp_builder(sz).build_domain_from_scratch()
    req = ScoreRequester(vrp.CotwinBuilder(True, True).build_cotwin(domain,
                                                                    False))
    agent = TabuSearch(sz.neighbours, 0.2, True, None, CHANGE_SWAP, sz.chunk,
                       StepsLimit(10**9), sweep=True,
                       sweep_targets=sz.targets)
    runner = IslandRunner(agent.build_kernel(req, None), n_islands=sz.islands,
                          migration_frequency=sz.chunk, mesh=mesh)
    state = runner.init(jax.random.key(0))
    alive = jnp.ones((sz.islands,), bool)
    for i in range(2):
        state = runner.run_chunk(state, jax.random.key(1 + i), alive, {},
                                 sz.chunk)
    jax.block_until_ready(state)
    pop = state["islands"]["population"]
    held = {s.device for s in pop.addressable_shards}
    assert len(held) == 4 and held == set(devs[:4]), held
    shard_rows = sorted(s.data.shape[0] for s in pop.addressable_shards)
    assert shard_rows == [sz.islands // 4] * 4, shard_rows
    tops = np.asarray(state["islands"]["top_score"])
    g_score = np.asarray(state["global_score"])
    best = int(lexico.lex_argmin(jnp.asarray(tops)))
    np.testing.assert_array_equal(g_score, tops[best])
    plain = np.asarray(jax.jit(req.request_score_plain)(
        state["global_values"][None]))[0]
    np.testing.assert_array_equal(plain, g_score)
    log(f"phase four-cards: ok islands on {sorted(d.id for d in held)} "
        f"({shard_rows} islands each), global best {g_score.tolist()} == "
        f"min of island tops, plain re-score exact; solve wall s: "
        f"4 cards {t_mesh}, 1 card {t_one}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the island mesh over four cards and the "
                         "same islands on one card")
    args = ap.parse_args(argv)
    try:
        device = phase_device()
    except RuntimeError as e:  # JAX found no usable backend
        raise SystemExit(f"chip_smoke: no accelerator: {e}")
    enable_compile_cache()
    if args.four_cards:
        phase_four_cards(FULL)
    else:
        phase_vrp_sweep(FULL)
        phase_vrp_int_delta(FULL)
        phase_tsp_sweep(FULL)
        phase_population(FULL)
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
