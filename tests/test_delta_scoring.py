"""Delta (incremental) scoring parity.

The contract under test: for ANY delta emitted by the delta move sampler,
    score_delta(ctx, delta) == full rescore of apply_delta(base, delta)
and applying an accepted delta to the ctx reproduces build_base_ctx of the
patched candidate exactly. Both sides use exact integer arithmetic, so the
comparison is bitwise — this is the array analog of the reference's
plain-vs-incremental equivalence (`incremental_score_calculator.rs`).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from greyjack_tpu.ops import moves
from greyjack_tpu.score_calculation.score_requesters import ScoreRequester

ALL_MOVES = [
    [1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    [0.0, 1.0, 0.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 1.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
    None,  # mixed (reference defaults)
]


def _tsp_requester(n=24, seed=3):
    from greyjack_tpu.models.tsp import CotwinBuilder, DomainBuilder
    from greyjack_tpu.models.tsp.domain import generate_uniform_instance

    domain = generate_uniform_instance(n, seed=seed)
    cotwin = CotwinBuilder(use_incremental_score_calculation=True,
                           use_greed_init=False).build_cotwin(domain, False)
    return ScoreRequester(cotwin)


def _vrp_requester(n=30, k=4, seed=2, time_windowed=True):
    from greyjack_tpu.models.vrp import CotwinBuilder
    from greyjack_tpu.models.vrp.domain import generate_instance

    domain = generate_instance(n_customers=n, n_depots=2, k_vehicles=k,
                               seed=seed, time_windowed=time_windowed)
    cotwin = CotwinBuilder(use_incremental_score_calculation=True,
                           use_greed_init=False).build_cotwin(domain, False)
    return ScoreRequester(cotwin)


def _nqueens_requester(n=16, seed=5):
    from greyjack_tpu.models.nqueens import CotwinBuilder, DomainBuilder

    domain = DomainBuilder(n, seed).build_domain_from_scratch()
    cotwin = CotwinBuilder(use_incremental_score_calculation=True
                           ).build_cotwin(domain, False)
    return ScoreRequester(cotwin)


def _check_parity(req, key, move_probas, n_neighbours=48,
                  mutation_rate_multiplier=1.0):
    vm = req.variables_manager
    cfg = moves.MoverConfig(vm, tabu_entity_rate=0.0,
                            mutation_rate_multiplier=mutation_rate_multiplier,
                            move_probas=move_probas)
    tabu = cfg.init_tabu_state()

    k_init, k_moves = jax.random.split(jax.random.key(key))
    base = vm.sample_variables(k_init, 1)[0]

    ctx = jax.jit(req.build_base_ctx)(base)
    deltas, _ = jax.jit(
        lambda k, b: moves.move_population_delta(k, b, n_neighbours, vm, cfg,
                                                 tabu)
    )(k_moves, base)
    delta_scores = np.asarray(
        jax.jit(req.request_score_delta)(ctx, deltas))

    # full rescore of the materialized neighbours
    materialized = jax.jit(jax.vmap(lambda d: moves.apply_delta(base, d))
                           )(deltas)
    full_scores = np.asarray(jax.jit(req.request_score_plain)(materialized))

    np.testing.assert_array_equal(
        delta_scores, full_scores,
        err_msg=f"delta != full rescore for move_probas={move_probas}")

    # ctx update parity on a few neighbours
    for i in (0, n_neighbours // 2, n_neighbours - 1):
        one = jax.tree.map(lambda x: x[i], deltas)
        ctx2 = jax.jit(req.update_ctx)(ctx, one)
        ctx_ref = jax.jit(req.build_base_ctx)(materialized[i])
        for (p1, l1), (p2, l2) in zip(
            jax.tree_util.tree_leaves_with_path(ctx2),
            jax.tree_util.tree_leaves_with_path(ctx_ref),
        ):
            np.testing.assert_array_equal(
                np.asarray(l1), np.asarray(l2),
                err_msg=f"ctx leaf {p1} diverged (neighbour {i}, "
                        f"move_probas={move_probas})")


@pytest.mark.parametrize("move_probas", ALL_MOVES)
def test_tsp_delta_parity(move_probas):
    req = _tsp_requester()
    assert req.supports_delta
    _check_parity(req, key=11, move_probas=move_probas)


@pytest.mark.parametrize("move_probas", ALL_MOVES)
def test_vrp_delta_parity(move_probas):
    # n=30, k=4 -> route_cap == n_stops, so the delta path is exact for
    # every reachable assignment (no over-cap guard divergence)
    req = _vrp_requester()
    assert req.supports_delta
    _check_parity(req, key=17, move_probas=move_probas)


def test_vrp_delta_parity_no_time_windows():
    req = _vrp_requester(time_windowed=False)
    _check_parity(req, key=23, move_probas=None)


# narrow move sets with zero mutation rates produce KD <= 4 deltas, which
# take the shift-merge/carried-leg path (`_delta_parts_small`) instead of
# the variadic-sort path — cover both the TS flagship config and each
# narrow move alone, time-windowed and not
NARROW_MOVES = [
    [1.0, 0.0, 0.0, 0.0, 0.0, 0.0],   # change (KD=1)
    [0.0, 1.0, 0.0, 0.0, 0.0, 0.0],   # swap (KD=2)
    [0.0, 0.0, 1.0, 0.0, 0.0, 0.0],   # swap_edges (KD=4)
    [0.5, 0.5, 0.0, 0.0, 0.0, 0.0],   # the reference's fastest VRP config
    [0.3, 0.3, 0.4, 0.0, 0.0, 0.0],
]


@pytest.mark.parametrize("move_probas", NARROW_MOVES)
def test_vrp_delta_parity_small_path(move_probas):
    from greyjack_tpu.ops import moves as moves_mod
    req = _vrp_requester()
    cfg = moves_mod.MoverConfig(req.variables_manager, 0.0, None, move_probas)
    assert cfg.delta_width <= 4, "expected the shift-merge path"
    _check_parity(req, key=31, move_probas=move_probas,
                  mutation_rate_multiplier=None, n_neighbours=96)


@pytest.mark.parametrize("move_probas", NARROW_MOVES)
def test_vrp_delta_parity_small_path_no_tw(move_probas):
    req = _vrp_requester(time_windowed=False, seed=8)
    _check_parity(req, key=37, move_probas=move_probas,
                  mutation_rate_multiplier=None, n_neighbours=96)


@pytest.mark.parametrize("move_probas", NARROW_MOVES[1:4])
def test_tsp_delta_parity_small_path(move_probas):
    req = _tsp_requester(seed=12)
    _check_parity(req, key=41, move_probas=move_probas,
                  mutation_rate_multiplier=None, n_neighbours=96)


def test_vrp_delta_parity_small_path_many_vehicles():
    req = _vrp_requester(n=60, k=20, seed=6)
    _check_parity(req, key=43, move_probas=[0.4, 0.3, 0.3, 0.0, 0.0, 0.0],
                  mutation_rate_multiplier=None, n_neighbours=128)


def test_vrp_delta_parity_many_vehicles():
    # k > DELTA_MOVE_SIZE and multi-depot: affected-vehicle dedupe + depot
    # legs under heavy vehicle churn
    req = _vrp_requester(n=60, k=20, seed=6)
    _check_parity(req, key=29, move_probas=None,
                  mutation_rate_multiplier=4.0)


@pytest.mark.parametrize("move_probas", ALL_MOVES)
def test_nqueens_delta_parity(move_probas):
    req = _nqueens_requester()
    assert req.supports_delta
    _check_parity(req, key=7, move_probas=move_probas)


def test_noop_delta_is_identity():
    req = _tsp_requester()
    vm = req.variables_manager
    base = vm.sample_variables(jax.random.key(0), 1)[0]
    ctx = jax.jit(req.build_base_ctx)(base)
    kd = 16
    noop = {
        "positions": jnp.zeros((kd,), jnp.int32),
        "values": jnp.zeros((kd,), base.dtype),
        "valid": jnp.zeros((kd,), bool),
    }
    ctx2 = jax.jit(req.update_ctx)(ctx, noop)
    for l1, l2 in zip(jax.tree.leaves(ctx), jax.tree.leaves(ctx2)):
        np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
    # and the scored "neighbour" equals the base score
    batched = jax.tree.map(lambda x: x[None], noop)
    s = np.asarray(jax.jit(req.request_score_delta)(ctx, batched))[0]
    full = np.asarray(jax.jit(req.request_score_plain)(base[None]))[0]
    np.testing.assert_array_equal(s, full)


def test_delta_solver_end_to_end_tsp():
    """TabuSearch in delta mode drives a small TSP below its random start."""
    from greyjack_tpu.agents import TabuSearch
    from greyjack_tpu.agents.termination_strategies import StepsLimit
    from greyjack_tpu.solver import Solver, SolverLoggingLevels
    from greyjack_tpu.models.tsp import CotwinBuilder, DomainBuilder
    from greyjack_tpu.models.tsp.domain import generate_uniform_instance

    gen = lambda: generate_uniform_instance(20, seed=9)
    domain_builder = DomainBuilder.from_generator(gen)
    cotwin_builder = CotwinBuilder(use_incremental_score_calculation=True,
                                   use_greed_init=True)
    agent = TabuSearch(32, 0.2, True, None, None, 5, StepsLimit(60))
    solution = Solver.solve(domain_builder, cotwin_builder, agent, n_jobs=2,
                            logging_level=SolverLoggingLevels.Silent, seed=4)
    (pairs, score) = solution
    assert score["hard_score"] == 0.0  # no duplicate stops at the end
    trip = domain_builder.build_from_solution(solution)
    assert trip.get_unique_stops_count() == 19
