"""The VRP integer delta rows (`score_delta_ints`) against the f64 delta
scorer (`vmap(score_delta)`) on sampler-generated neighbourhoods.

TabuSearch ranks and accepts on these i32 rows, so they must induce exactly
the f64 rows' lexicographic order and accept decision, carry the exact
integer deltas, and mark every neighbour the f64 path scores as the stub
with INT32_MAX.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from greyjack_tpu.agents import TabuSearch
from greyjack_tpu.agents.termination_strategies import StepsLimit
from greyjack_tpu.models.vrp import CotwinBuilder, generate_instance
from greyjack_tpu.models.vrp import cotwin_builder as vrp_cb
from greyjack_tpu.ops import lexico, moves
from greyjack_tpu.score_calculation.score_requesters import ScoreRequester

CHANGE_SWAP = [0.5, 0.5, 0.0, 0.0, 0.0, 0.0]
INT32_MAX = np.iinfo(np.int32).max


def _requester(tw, n=40, d=2, kveh=6, seed=3):
    domain = generate_instance(n, d, kveh, seed=seed, time_windowed=tw)
    return ScoreRequester(CotwinBuilder(True, False).build_cotwin(domain, False))


def _neighbourhood(req, probas, seed, p=128, n_updates=0):
    """A base ctx (advanced by `n_updates` accepted deltas) and `p`
    sampled neighbour deltas."""
    vm = req.variables_manager
    cfg = moves.MoverConfig(vm, 0.2, None, probas)
    assert req.supports_delta_ints(cfg.delta_width)
    tabu = cfg.init_tabu_state()
    key = jax.random.key(seed)
    base = vm.sample_variables(key, 1)[0]
    ctx = jax.jit(req.build_base_ctx)(base)

    @jax.jit
    def advance(k, base, ctx):
        d, _ = moves.move_population_delta(k, base, 1, vm, cfg, tabu)
        w = jax.tree.map(lambda x: x[0], d)
        return moves.apply_delta(base, w), req.update_ctx(ctx, w)

    for i in range(n_updates):
        base, ctx = advance(jax.random.fold_in(key, 100 + i), base, ctx)
    return ctx, _sample(req, cfg, base, jax.random.fold_in(key, 1), p)


def _sample(req, cfg, base, key, p):
    vm = req.variables_manager
    return jax.jit(lambda k, b: moves.move_population_delta(
        k, b, p, vm, cfg, cfg.init_tabu_state())[0])(key, base)


def _check_rows(req, ctx, deltas):
    utils = req._delta_utils()
    calc = req.cotwin.score_calculator
    f64 = jax.jit(jax.vmap(lambda c, d: calc.delta_score_fn(c, d, utils),
                           in_axes=(None, 0)))(ctx, deltas)
    ints = jax.jit(req.request_score_delta_ints)(ctx, deltas)
    assert ints.dtype == jnp.int32 and ints.shape == f64.shape

    # stub rows coincide
    stub_f = np.all(np.asarray(f64) == np.asarray(lexico.stub_score_row(3)),
                    axis=1)
    stub_i = np.all(np.asarray(ints) == INT32_MAX, axis=1)
    np.testing.assert_array_equal(stub_f, stub_i)

    # exact deltas: base integer totals + delta row == f64 row * scales
    live = ~stub_i
    totals = np.asarray(req.ctx_int_totals(ctx))
    scales = np.asarray(req.score_int_scales)
    want = np.rint(np.asarray(f64)[live] * scales).astype(np.int64)
    np.testing.assert_array_equal(
        totals[None, :] + np.asarray(ints)[live].astype(np.int64), want)

    # order, argmin and the accept decision
    lt_f = np.asarray(lexico.lex_less(f64[:, None, :], f64[None, :, :]))
    lt_i = np.asarray(lexico.lex_less(ints[:, None, :], ints[None, :, :]))
    np.testing.assert_array_equal(lt_f, lt_i)
    assert int(lexico.lex_argmin(f64)) == int(lexico.lex_argmin(ints))
    base_score = jax.jit(req.ctx_score_row)(ctx)
    acc_f = np.asarray(lexico.lex_leq(f64, base_score[None, :]))
    acc_i = np.asarray(lexico.lex_leq(ints, jnp.zeros((1, 3), ints.dtype)))
    np.testing.assert_array_equal(acc_f, acc_i)
    return stub_i


@pytest.mark.parametrize("tw,probas,seed,n_updates", [
    pytest.param(True, CHANGE_SWAP, 11, 0, id="tw-change-swap"),
    pytest.param(False, CHANGE_SWAP, 11, 0, id="plain-change-swap"),
    pytest.param(True, [1.0, 0.0, 0.0, 0.0, 0.0, 0.0], 23, 0,
                 id="tw-change-only"),
    # swaps on the common group mix vehicle and customer vars: same-route
    # adjacent customer swaps and two-row vehicle moves
    pytest.param(True, [0.0, 1.0, 0.0, 0.0, 0.0, 0.0], 37, 0,
                 id="tw-swap-only"),
    pytest.param(True, CHANGE_SWAP, 5, 3, id="tw-after-updates"),
])
def test_int_rows_match_f64_rows(tw, probas, seed, n_updates):
    req = _requester(tw)
    ctx, deltas = _neighbourhood(req, probas, seed, n_updates=n_updates)
    _check_rows(req, ctx, deltas)


def _capped(req, route_cap):
    """The same instance with a smaller static route cap."""
    calc = req.cotwin.score_calculator
    calc.utility_objects = {**calc.utility_objects, "route_cap": route_cap}
    return req


def test_over_cap_neighbours_are_int32_max():
    req = _requester(True)
    vm = req.variables_manager
    base = vm.sample_variables(jax.random.key(41), 1)[0]
    v = np.asarray(req.build_frames(base)["planning_stops"]["vehicle_id"])
    longest = int(np.bincount(v).max())
    # the longest route sits exactly at the cap: growing it is over-cap
    _capped(req, longest)
    ctx = jax.jit(req.build_base_ctx)(base)
    cfg = moves.MoverConfig(vm, 0.2, None, CHANGE_SWAP)
    deltas = _sample(req, cfg, base, jax.random.key(42), 256)
    stub = _check_rows(req, ctx, deltas)
    assert 0 < stub.sum() < stub.size


def test_over_cap_base_poisons_every_row():
    req = _requester(False)
    vm = req.variables_manager
    base = vm.sample_variables(jax.random.key(7), 1)[0]
    v = np.asarray(req.build_frames(base)["planning_stops"]["vehicle_id"])
    _capped(req, int(np.bincount(v).max()) - 1)
    ctx = jax.jit(req.build_base_ctx)(base)
    cfg = moves.MoverConfig(vm, 0.2, None, CHANGE_SWAP)
    deltas = _sample(req, cfg, base, jax.random.key(8), 64)
    ints = np.asarray(jax.jit(req.request_score_delta_ints)(ctx, deltas))
    assert (ints == INT32_MAX).all()


def _tabu(probas):
    return TabuSearch(64, 0.2, True, None, probas, 2, StepsLimit(2))


def test_eligibility_follows_delta_width_and_accumulator():
    req = _requester(True)
    utils = req._delta_utils()
    assert vrp_cb.delta_ints_eligible(utils, 2)
    assert not vrp_cb.delta_ints_eligible(utils, 3)
    assert not vrp_cb.delta_ints_eligible(
        {**utils, "acc_dtype": jnp.int64}, 2)
    wide = moves.MoverConfig(req.variables_manager, 0.2, None,
                             [0.2, 0.2, 0.2, 0.2, 0.1, 0.1])
    assert wide.delta_width > 2
    assert not req.supports_delta_ints(wide.delta_width)


@pytest.mark.parametrize("probas,path", [
    pytest.param(CHANGE_SWAP, "int-delta", id="narrow"),
    pytest.param([0.2, 0.2, 0.2, 0.2, 0.1, 0.1], "delta", id="wide"),
])
def test_vrp_kernel_path_reports_what_ranks(probas, path):
    req = _requester(True)
    assert _tabu(probas).build_kernel(req, None).path == path


def test_model_without_int_rows_reports_delta():
    from greyjack_tpu.models.tsp import (
        CotwinBuilder as TspCotwinBuilder, generate_uniform_instance)

    domain = generate_uniform_instance(30, seed=1)
    req = ScoreRequester(TspCotwinBuilder(True).build_cotwin(domain, False))
    assert req.supports_delta and not req.supports_delta_ints(2)
    kernel = _tabu([0.5, 0.5, 0.0, 0.0, 0.0, 0.0]).build_kernel(req, None)
    assert kernel.path == "delta"
