"""Sweep-neighbourhood scorer parity vs the plain (golden-tested) scorer.

Contract under test (`models/vrp/sweep.py` docstring): hard and distance
deltas are EXACT for every valid candidate; lateness deltas are exact where
`conv` and a valid optimistic lower bound otherwise; the proposed winner's
`exact` row always matches a full recompute.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from greyjack_tpu.models.vrp import CotwinBuilder, generate_instance, sweep
from greyjack_tpu.score_calculation.score_requesters import ScoreRequester
from greyjack_tpu.ops import moves


def _build(n=30, d=2, k=5, tw=True, seed=3):
    domain = generate_instance(n, d, k, seed=seed, time_windowed=tw)
    cotwin = CotwinBuilder(True, True).build_cotwin(domain, False)
    return ScoreRequester(cotwin)


def _ints(scores, base):
    """f64 score rows -> integer delta rows (hard, late, dist_milli)."""
    d = np.asarray(scores, np.float64) - np.asarray(base, np.float64)
    out = np.stack([d[..., 0], d[..., 1], np.rint(d[..., 2] * 1000.0)],
                   axis=-1)
    return out.astype(np.int64)


def _perturbed_base(req, key, n_moves=12):
    """Greedy-init base with a few random narrow moves applied (covers
    non-greedy structures: waiting routes, violated windows)."""
    vm = req.variables_manager
    base = vm.sample_variables(key, 1)[0]
    kr = np.random.RandomState(7)
    arr = np.asarray(base).copy()
    n_rows = len(req.planning_schema["planning_stops"]["var_ids_np"]
                 ["customer_id"])
    cust_vars = req.planning_schema["planning_stops"]["var_ids_np"]
    for _ in range(n_moves):
        i = kr.randint(n_rows)
        j = kr.randint(n_rows)
        arr[cust_vars["vehicle_id"][i]] = kr.randint(
            int(np.asarray(vm.upper_bounds)[cust_vars["vehicle_id"][i]]) + 1)
        a, b = cust_vars["customer_id"][i], cust_vars["customer_id"][j]
        arr[a], arr[b] = arr[b], arr[a]
    return jnp.asarray(arr, base.dtype)


@pytest.mark.parametrize("tw,window,seed", [
    (True, 4, 3),    # tiny window: forces non-converged candidates
    (True, 16, 5),   # wide window: nearly all exact
    (False, 8, 3),   # no time windows: lateness path off
])
def test_sweep_family_parity(tw, window, seed):
    req = _build(tw=tw, seed=seed)
    utils = req._delta_utils()
    assert sweep.eligible(utils)
    n = utils["n_stops"]
    nd = utils["n_locations"] - n
    kk = utils["k_vehicles"]
    cfg = sweep.SweepConfig(req, targets=n, window=window)

    base = _perturbed_base(req, jax.random.key(seed))
    ctx = req.build_base_ctx(base)
    base_score = np.asarray(req.request_score_plain(base[None, :])[0])

    t_rows = jnp.arange(n, dtype=jnp.int32)
    sc = jax.jit(lambda c: sweep.score_candidates(
        c, t_rows, jnp.ones((n,), bool), jnp.zeros((n,), bool), cfg, utils)
    )(ctx)
    sc = jax.tree.map(np.asarray, sc)

    cust_var = np.asarray(cfg.cust_var)
    veh_var = np.asarray(cfg.veh_var)
    base_np = np.asarray(base)

    def batch_scores(rows):
        pops = jnp.asarray(np.stack(rows), base.dtype)
        return _ints(np.asarray(req.request_score_plain(pops)), base_score)

    # --- family A: change-sweep --------------------------------------------
    rng = np.random.RandomState(seed)
    pairs = [(t, c) for t in rng.choice(n, 8, replace=False)
             for c in range(n)]
    rows = []
    for t, c in pairs:
        m = base_np.copy()
        m[cust_var[t]] = nd + c
        rows.append(m)
    oracle = batch_scores(rows)
    for (t, c), orc in zip(pairs, oracle):
        got = (sc["a_hard"][t, c], sc["a_late"][t, c], sc["a_dist"][t, c])
        if not sc["a_valid"][t, c]:
            continue  # the no-op candidate (c == current) is excluded
        assert got[0] == orc[0], (t, c, got, orc)
        assert got[2] == orc[2], (t, c, got, orc)
        if sc["a_conv"][t, c]:
            assert got[1] == orc[1], (t, c, got, orc)
        else:
            assert got[1] <= orc[1], (t, c, got, orc)

    # --- family B: vehicle-sweep (always exact) ----------------------------
    pairs = [(t, v) for t in rng.choice(n, 8, replace=False)
             for v in range(kk)]
    rows = []
    for t, v in pairs:
        m = base_np.copy()
        m[veh_var[t]] = v
        rows.append(m)
    oracle = batch_scores(rows)
    for (t, v), orc in zip(pairs, oracle):
        if not sc["b_valid"][t, v]:
            continue
        got = (sc["b_hard"][t, v], sc["b_late"][t, v], sc["b_dist"][t, v])
        assert sc["b_conv"][t, v]
        assert tuple(got) == tuple(orc), (t, v, got, orc)

    # --- family C: swap-sweep ----------------------------------------------
    pairs = [(t, j) for t in rng.choice(n, 6, replace=False)
             for j in range(n)]
    rows = []
    for t, j in pairs:
        m = base_np.copy()
        a, b = cust_var[t], cust_var[j]
        m[a], m[b] = m[b], m[a]
        rows.append(m)
    oracle = batch_scores(rows)
    n_conv = n_nonconv = 0
    for (t, j), orc in zip(pairs, oracle):
        if not sc["c_valid"][t, j]:
            continue
        got = (sc["c_hard"][t, j], sc["c_late"][t, j], sc["c_dist"][t, j])
        assert got[0] == orc[0], (t, j, got, orc)
        assert got[2] == orc[2], (t, j, got, orc)
        if sc["c_conv"][t, j]:
            n_conv += 1
            assert got[1] == orc[1], (t, j, got, orc)
        else:
            n_nonconv += 1
            assert got[1] <= orc[1], (t, j, got, orc)
    assert n_conv > 0
    if tw and window <= 4:
        # the tiny window must actually exercise the bound path
        assert n_nonconv > 0


def test_sweep_propose_winner_exact():
    req = _build(tw=True, seed=11)
    utils = req._delta_utils()
    cfg = sweep.SweepConfig(req, targets=12, window=8)
    mcfg = moves.MoverConfig(req.variables_manager, tabu_entity_rate=0.2,
                             move_probas=[0.5, 0.5, 0, 0, 0, 0])
    tabu = mcfg.init_tabu_state()

    base = _perturbed_base(req, jax.random.key(0))
    ctx = req.build_base_ctx(base)
    base_score = np.asarray(req.request_score_plain(base[None, :])[0])

    free = mcfg.tabu_free(tabu)
    masks = mcfg.tabu_masks(tabu)
    delta, exact, info, stats = jax.jit(
        lambda c, f: sweep.propose(jax.random.key(5), c, f, masks, cfg,
                                   utils))(ctx, free)

    assert int(stats["n_scored"]) > 0
    # the exact row must equal a full plain recompute of the winner move
    mut = moves.apply_delta(base, jax.tree.map(lambda x: x, delta))
    orc = _ints(np.asarray(req.request_score_plain(mut[None, :])[0]),
                base_score)
    assert tuple(np.asarray(exact)) == tuple(orc), (delta, exact, orc)
    # tabu info is in range
    g = int(info["group"])
    assert g in (cfg.g_cust, cfg.g_veh)
    assert (np.asarray(info["positions"]) >= 0).all()


def test_sweep_island_run_improves():
    """End-to-end: sweep TabuSearch over islands improves the score and the
    global best stays consistent with a plain recompute."""
    from greyjack_tpu.agents import TabuSearch
    from greyjack_tpu.agents.termination_strategies import StepsLimit
    from greyjack_tpu.parallel import IslandRunner

    req = _build(n=40, d=2, k=6, tw=True, seed=21)
    agent = TabuSearch(64, 0.2, True, None, [0.5, 0.5, 0, 0, 0, 0], 5,
                       StepsLimit(100), sweep=True, sweep_targets=8,
                       sweep_window=8)
    kernel = agent.build_kernel(req, None)
    runner = IslandRunner(kernel, n_islands=2, migration_frequency=5)
    state = runner.init(jax.random.key(1))
    s0 = np.asarray(state["islands"]["scores"])[:, 0]
    alive = jnp.ones((2,), bool)
    for i in range(6):
        state = runner.run_chunk(state, jax.random.key(100 + i), alive, {}, 5)
    g_score = np.asarray(state["global_score"])
    g_vals = state["global_values"]
    recomputed = np.asarray(req.request_score_plain(g_vals[None, :])[0])
    np.testing.assert_allclose(g_score, recomputed, rtol=0, atol=1e-9)
    # lexicographically at least as good as the (identical) island inits,
    # and strictly better on some component
    init = s0[0]
    assert tuple(g_score) <= tuple(init)
    assert tuple(g_score) != tuple(init)
    assert int(np.asarray(state["islands"]["sweep_scored"]).sum()) > 0


def test_sweep_late_acceptance_improves():
    from greyjack_tpu.agents import LateAcceptance
    from greyjack_tpu.agents.termination_strategies import StepsLimit
    from greyjack_tpu.parallel import IslandRunner

    req = _build(n=40, d=2, k=6, tw=True, seed=33)
    agent = LateAcceptance(20, 0.2, None, [0.5, 0.5, 0, 0, 0, 0], 5,
                           StepsLimit(100), sweep=True, sweep_targets=8,
                           sweep_window=8)
    kernel = agent.build_kernel(req, None)
    runner = IslandRunner(kernel, n_islands=2, migration_frequency=5)
    state = runner.init(jax.random.key(2))
    init = np.asarray(state["islands"]["scores"])[0, 0]
    alive = jnp.ones((2,), bool)
    for i in range(6):
        state = runner.run_chunk(state, jax.random.key(200 + i), alive, {}, 5)
    g_score = np.asarray(state["global_score"])
    recomputed = np.asarray(req.request_score_plain(
        state["global_values"][None, :])[0])
    np.testing.assert_allclose(g_score, recomputed, rtol=0, atol=1e-9)
    assert tuple(g_score) < tuple(init)


def test_patch_tables_invariant():
    """`patch_tables` after an accepted move must be bit-identical to a
    fresh `build_tables` of the updated ctx. (Agents rebuild the tables
    per step; the state-carried patch is kept as tested machinery until
    ROADMAP Speed item 4 compares the two on the card.)"""
    req = _build(n=40, d=2, k=6, tw=True, seed=9)
    utils = req._delta_utils()
    cfg = sweep.SweepConfig(req, 8, 8)
    mcfg = moves.MoverConfig(req.variables_manager, tabu_entity_rate=0.2,
                             move_probas=[0.5, 0.5, 0, 0, 0, 0])
    tabu = mcfg.init_tabu_state()
    base = _perturbed_base(req, jax.random.key(3))
    ctx = req.build_base_ctx(base)
    tables = jax.jit(lambda c: sweep.build_tables(c, cfg, utils))(ctx)
    for i in range(5):
        free = mcfg.tabu_free(tabu)
        masks = mcfg.tabu_masks(tabu)
        delta, exact, info, _ = sweep.propose(
            jax.random.key(40 + i), ctx, free, masks, cfg, utils,
            tables=tables)
        from greyjack_tpu.ops import lexico
        accept = bool(lexico.lex_leq(exact, jnp.zeros((3,), exact.dtype)))
        winner = {**delta, "valid": delta["valid"] & accept}
        ctx = req.update_ctx(ctx, winner)
        tables = jax.jit(lambda t, c, av: sweep.patch_tables(
            t, c, av, cfg, utils))(tables, ctx, info["av"])
        fresh = jax.jit(lambda c: sweep.build_tables(c, cfg, utils))(ctx)
        np.testing.assert_array_equal(np.asarray(tables[0]),
                                      np.asarray(fresh[0]))
        for k2 in fresh[1]:
            np.testing.assert_array_equal(np.asarray(tables[1][k2]),
                                          np.asarray(fresh[1][k2]),
                                          err_msg=k2)
        tabu = moves.update_tabu_from_info(
            tabu, jax.tree.map(lambda x: x[None], info), 0)


def test_sweep_simulated_annealing_improves():
    from greyjack_tpu.agents import SimulatedAnnealing
    from greyjack_tpu.agents.termination_strategies import StepsLimit
    from greyjack_tpu.parallel import IslandRunner

    req = _build(n=40, d=2, k=6, tw=True, seed=13)
    agent = SimulatedAnnealing([10.0, 10.0, 10.0], 0.95, 0.2, None,
                               [0.5, 0.5, 0, 0, 0, 0], 5, StepsLimit(100),
                               sweep=True, sweep_targets=8, sweep_window=8)
    kernel = agent.build_kernel(req, None)
    runner = IslandRunner(kernel, n_islands=2, migration_frequency=5)
    state = runner.init(jax.random.key(6))
    init = np.asarray(state["islands"]["scores"])[0, 0]
    alive = jnp.ones((2,), bool)
    for i in range(6):
        state = runner.run_chunk(state, jax.random.key(400 + i), alive, {}, 5)
    g = np.asarray(state["global_score"])
    recomputed = np.asarray(req.request_score_plain(
        state["global_values"][None, :])[0])
    np.testing.assert_allclose(g, recomputed, rtol=0, atol=1e-9)
    assert tuple(g) < tuple(init)
