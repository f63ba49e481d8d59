"""score_precision composed with the fast paths (VERDICT r4 item 3).

The reference's shipped TSP config uses `score_precision Some([3,3])`
(`examples/tsp/src/main.rs:56`) and still gets the
incremental path. Here the sweep / int-delta fast paths stay live under
rounded scores by rounding at the accept boundary: candidate f64 rows are
derived from exact integer totals (`set_delta_kernels(ctx_ints=...)`),
truncating-decimal-rounded (`math_utils.rs:9-12` semantics) and compared
against the rounded incumbent. These tests pin:

  * the TSP sweep kernel ENGAGES under [3,3] and its stored scores equal
    a rounded plain rescore of the same population, bit for bit;
  * the VRP int-delta kernel engages under a coarser precision and keeps
    the same bitwise parity;
  * a model without registered integer totals falls back LOUDLY.
"""

import warnings

import numpy as np
import jax

from greyjack_tpu.agents import TabuSearch, LateAcceptance
from greyjack_tpu.agents import base
from greyjack_tpu.agents.termination_strategies import StepsLimit
from greyjack_tpu.score_calculation.score_requesters import ScoreRequester


def _tsp_requester(n=36, seed=5):
    from greyjack_tpu.models.tsp import CotwinBuilder, generate_uniform_instance

    domain = generate_uniform_instance(n, seed=seed)
    return ScoreRequester(CotwinBuilder(True, True).build_cotwin(domain, False))


def _vrp_requester(n=24, seed=11):
    from greyjack_tpu.models.vrp import CotwinBuilder, generate_instance

    domain = generate_instance(n, 2, 6, seed=seed, time_windowed=True)
    return ScoreRequester(CotwinBuilder(True, True).build_cotwin(domain, False))


def _run_steps(kernel, n_steps, seed=0):
    state = kernel.init_state(jax.random.key(seed))
    step = jax.jit(lambda k, s: kernel.step(k, s, {}))
    for i in range(n_steps):
        state = step(jax.random.key(100 + i), state)
    return state


def test_tsp_sweep_engages_under_reference_precision():
    req = _tsp_requester()
    agent = TabuSearch(16, 0.2, True, None, [0, .2, .2, .2, .2, .2], 5,
                       StepsLimit(50), sweep=True, sweep_targets=6)
    kernel = agent.build_kernel(req, [3, 3])
    assert kernel.path == "sweep"

    state = _run_steps(kernel, 25)
    # stored score rows must equal a ROUNDED plain rescore bit-for-bit —
    # the accept-boundary rounding reproduces agent_base.rs:284-287
    plain_rounded = base.make_score_fn(req, [3, 3])(state["population"])
    np.testing.assert_array_equal(np.asarray(state["scores"]),
                                  np.asarray(plain_rounded))
    top_rounded = base.make_score_fn(req, [3, 3])(state["top_values"][None])
    np.testing.assert_array_equal(np.asarray(state["top_score"]),
                                  np.asarray(top_rounded[0]))
    assert int(np.asarray(state["sweep_scored"])) > 0


def test_tsp_sweep_precision_trajectory_improves():
    req = _tsp_requester(n=30, seed=9)
    agent = TabuSearch(16, 0.2, True, None, [0, .2, .2, .2, .2, .2], 5,
                       StepsLimit(50), sweep=True, sweep_targets=6)
    kernel = agent.build_kernel(req, [3, 3])
    s0 = kernel.init_state(jax.random.key(1))
    s1 = _run_steps(kernel, 20, seed=1)
    from greyjack_tpu.ops import lexico

    assert bool(lexico.lex_leq(s1["top_score"], s0["top_score"]))


def test_vrp_int_delta_engages_under_coarse_precision():
    req = _vrp_requester()
    agent = TabuSearch(32, 0.2, True, None, [0.5, 0.5, 0, 0, 0, 0], 5,
                       StepsLimit(50))
    # coarse soft precision [3,3,1] genuinely merges distinct milli values
    kernel = agent.build_kernel(req, [3, 3, 1])
    assert kernel.path == "int-delta"

    state = _run_steps(kernel, 20, seed=3)
    plain_rounded = base.make_score_fn(req, [3, 3, 1])(state["population"])
    np.testing.assert_array_equal(np.asarray(state["scores"]),
                                  np.asarray(plain_rounded))


def test_la_sweep_engages_under_precision():
    req = _tsp_requester(n=30, seed=2)
    agent = LateAcceptance(20, 0.2, None, [0, .2, .2, .2, .2, .2], 5,
                           StepsLimit(50), sweep=True, sweep_targets=6)
    kernel = agent.build_kernel(req, [3, 3])
    assert kernel.path == "sweep"
    state = _run_steps(kernel, 15, seed=4)
    plain_rounded = base.make_score_fn(req, [3, 3])(state["population"])
    np.testing.assert_array_equal(np.asarray(state["scores"]),
                                  np.asarray(plain_rounded))


def test_sweep_fallback_warns_without_int_totals():
    req = _tsp_requester(n=20, seed=1)
    calc = req.cotwin.score_calculator
    calc.delta_ctx_ints_fn = None  # simulate a model without the hook
    agent = TabuSearch(8, 0.2, True, None, [0, .5, .5, 0, 0, 0], 5,
                       StepsLimit(10), sweep=True, sweep_targets=4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        kernel = agent.build_kernel(req, [3, 3])
    assert kernel.path != "sweep"
    assert any("sweep" in str(w.message)
               and "cannot engage" in str(w.message) for w in caught)


def test_rounded_ints_to_row_matches_host_round():
    from greyjack_tpu.utils.math_utils import round_decimal

    req = _tsp_requester(n=20, seed=7)
    fn = base.make_rounded_ints_to_row_fn(req, [3, 3])
    import jax.numpy as jnp

    ints = jnp.asarray([[3, 123457], [0, 7], [1, 999999]], jnp.int64)
    out = np.asarray(jax.vmap(fn)(ints))
    for row, (h, m) in zip(out, [(3, 123457), (0, 7), (1, 999999)]):
        assert row[0] == float(h)
        assert row[1] == round_decimal(m / 1000.0, 3)
