"""TabuSearch — local search over batched neighborhoods.

Reference: `greyjack/src/agents/tabu_search.rs:16-77` (builder) and
`greyjack/src/agents/metaheuristic_bases/tabu_search_base.rs:25-199`
(semantics): sample `neighbours_count` independent moves off the current
best, accept the best neighbour iff <= current. The "tabu" aspect lives in
the shared Mover's entity tabu. Here the whole neighborhood is one
move+score batch on the device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from greyjack_tpu.agents import base
from greyjack_tpu.ops import lexico, moves, selection


class TabuSearch:
    metaheuristic_kind = "LocalSearch"
    metaheuristic_name = "TabuSearch"

    def __init__(self, neighbours_count, tabu_entity_rate, compare_to_global,
                 mutation_rate_multiplier, move_probas, migration_frequency,
                 termination_strategy, sweep=False, sweep_targets=None,
                 sweep_window=None, sweep_stall_limit=32):
        self.neighbours_count = int(neighbours_count)
        self.tabu_entity_rate = float(tabu_entity_rate)
        self.compare_to_global = bool(compare_to_global)
        self.mutation_rate_multiplier = mutation_rate_multiplier
        self.move_probas = move_probas
        self.migration_frequency = int(migration_frequency)
        self.termination_strategy = termination_strategy
        # sweep-neighbourhood mode (model-provided dense value sweeps —
        # `models/vrp/sweep.py`): per step, every candidate value for
        # `sweep_targets` sampled stops is scored instead of
        # `neighbours_count` random moves. Requires a model sweep module;
        # with `score_precision` the model must also register exact integer
        # totals (accept-boundary rounding) — a RuntimeWarning is emitted
        # when the sweep cannot engage and the kernel records `path`.
        self.sweep = bool(sweep)
        self.sweep_targets = sweep_targets
        self.sweep_window = sweep_window
        # classic-TS escape hatch for the sweep mode: after `sweep_stall_limit`
        # steps without a NEW BEST, the best candidate is accepted even when
        # worse (move-to-best-non-tabu-neighbour, the textbook tabu-search
        # rule); hill-climb acceptance resumes on a new best. Best-improve
        # sweeps otherwise freeze at their first deep local optimum
        # (measured: the non-tw n=1000 race leg plateaued within 0.5s)
        self.sweep_stall_limit = int(sweep_stall_limit)
        # local-search agents force population 1 / migration_rate 1.0
        # (`tabu_search.rs:68-71`)
        self.population_size = 1
        self.migration_rate = 1.0

    def build_kernel(self, requester, score_precision=None):
        vm = requester.variables_manager
        cfg = moves.MoverConfig(vm, self.tabu_entity_rate,
                                self.mutation_rate_multiplier, self.move_probas)
        score_fn = base.make_score_fn(requester, score_precision)
        n = self.neighbours_count

        precision_ok = base.fast_paths_ok(requester, score_precision)
        if self.sweep and requester.supports_sweep and precision_ok:
            return self._build_sweep_kernel(requester, cfg, score_fn,
                                            score_precision)
        if self.sweep:
            base.announce_fallback(self, requester, score_precision)

        if requester.supports_delta:
            # incremental mode (`tabu_search_base.rs:107-188` semantics): the
            # whole neighbourhood is scored as O(K) deltas against a ctx
            # carried in state; the winning delta is applied to both the
            # chromosome and the ctx — no O(N) work per step at all
            delta_score_fn = base.make_delta_score_fn(requester,
                                                      score_precision)
            # accept-boundary rounding keeps the int path live under
            # score_precision (None when unrounded — exact delta<=0 compare)
            ints_to_row = (base.make_rounded_ints_to_row_fn(
                requester, score_precision)
                if score_precision is not None and precision_ok else None)
            # int-delta path (trace-time static): taken exactly where the
            # model's integer rows are exact for this move set's width
            has_ints = precision_ok and requester.supports_delta_ints(
                cfg.delta_width)

            def init_state(key):
                population = vm.sample_variables(key, 1)
                scores = score_fn(population)
                state = base.base_state(population, scores)
                state["tabu"] = cfg.init_tabu_state()
                state["ctx"] = requester.build_base_ctx(population[0])
                return state

            def step(key, state, extras):
                # self-gating (`MetaheuristicKernel.self_gating`): when
                # `_active` is False every state write below is an exact
                # identity — the winner is invalidated (apply/update_ctx
                # no-op bit-exactly), the tabu push count drops to 0 and
                # step_id freezes — so the runner never needs to mask
                active = extras.get("_active", jnp.bool_(True))
                k_move, _ = jax.random.split(key)
                base_row = state["population"][0]
                deltas, info = moves.move_population_delta(
                    k_move, base_row, n, vm, cfg, state["tabu"],
                    extras.get("_free"))
                # int-delta fast path (trace-time static): rank/accept on
                # i32 delta rows, materialize the f64 score only from the
                # ctx's exact sums. With score_precision, the accept compare
                # sees rounded f64 rows derived from ctx_ints + delta_ints
                # (bit-identical to rounding a full rescore) — argmin stays
                # on exact ints, which is valid because decimal rounding is
                # monotone.
                state = dict(state)
                if has_ints:
                    ints = requester.request_score_delta_ints(state["ctx"],
                                                              deltas)
                    best = lexico.lex_argmin(ints)
                    best_delta = moves.take_one(ints, best)
                    if ints_to_row is None:
                        accept = lexico.lex_leq(
                            best_delta,
                            jnp.zeros((ints.shape[-1],), ints.dtype)) & active
                        cand_row = None
                    else:
                        cand_row = ints_to_row(
                            requester.ctx_int_totals(state["ctx"])
                            + best_delta.astype(jnp.int64))
                        accept = lexico.lex_leq(
                            cand_row, state["scores"][0]) & active
                    winner = moves.take_one(deltas, best)
                    winner = {**winner, "valid": winner["valid"] & accept}
                    new_row = moves.apply_delta(base_row, winner)
                    state["population"] = new_row[None, :]
                    state["ctx"] = requester.update_ctx(state["ctx"], winner)
                    # guarded like the float path: on a rejected/inactive step
                    # the ctx is untouched, but the stored score may have come
                    # from score_fn at init — overwriting it with the
                    # ctx-derived row would let any bitwise divergence between
                    # the two scorers make a "frozen" island's score drift
                    # (ADVICE r3)
                    new_score = (cand_row if cand_row is not None
                                 else requester.ctx_score_row(state["ctx"]))
                    state["scores"] = jnp.where(
                        accept, new_score[None, :], state["scores"])
                else:
                    scores = delta_score_fn(state["ctx"], deltas)
                    best = lexico.lex_argmin(scores)
                    best_score = moves.take_one(scores, best)
                    accept = (lexico.lex_leq(best_score, state["scores"][0])
                              & active)
                    winner = moves.take_one(deltas, best)
                    winner = {**winner, "valid": winner["valid"] & accept}
                    new_row = moves.apply_delta(base_row, winner)
                    state["population"] = new_row[None, :]
                    state["scores"] = jnp.where(accept, best_score[None, :],
                                                state["scores"])
                    state["ctx"] = requester.update_ctx(state["ctx"], winner)
                if cfg.use_tabu:
                    state["tabu"] = moves.update_tabu_from_info(
                        state["tabu"], info, best, active)
                state = base.update_top(state)
                state["step_id"] = state["step_id"] + active.astype(
                    state["step_id"].dtype)
                return state

            def refresh(state):
                state = dict(state)
                state["ctx"] = requester.build_base_ctx(
                    state["population"][0])
                return state

            # the free-list prestep only feeds the narrow sampler path; for
            # wide configs move_population_delta ignores the extra and
            # rebuilds masks itself, so building the list per step inside the
            # scan would be pure waste (ADVICE r3)
            narrow = (cfg.rates_zero and set(cfg.enabled) <= {0, 1}
                      and cfg.delta_width == 2 and cfg.k_sel == 2)

            def prestep(batched_state):
                return {"_free": cfg.tabu_free(batched_state["tabu"])}

            return base.MetaheuristicKernel(
                self, init_state, step, refresh, self_gating=True,
                prestep=prestep if narrow else None,
                path="int-delta" if has_ints else "delta",
                moves_per_step=n)

        def init_state(key):
            population = vm.sample_variables(key, 1)
            scores = score_fn(population)
            state = base.base_state(population, scores)
            state["tabu"] = cfg.init_tabu_state()
            return state

        def step(key, state, extras):
            k_move, k_tabu = jax.random.split(key)
            current = state["population"][0]
            neighbours = jnp.broadcast_to(current, (n, current.shape[0]))
            moved, info = moves.move_population(k_move, neighbours, vm, cfg,
                                                state["tabu"])
            moved = vm.fix_all(moved)
            scores = score_fn(moved)
            best = lexico.lex_argmin(scores)
            accept = lexico.lex_leq(scores[best], state["scores"][0])
            state = dict(state)
            state["population"] = jnp.where(accept, moved[best][None, :],
                                            state["population"])
            state["scores"] = jnp.where(accept, scores[best][None, :],
                                        state["scores"])
            if cfg.use_tabu:
                state["tabu"] = moves.update_tabu_from_info(state["tabu"], info, best)
            state = base.update_top(state)
            state["step_id"] = state["step_id"] + 1
            return state

        return base.MetaheuristicKernel(self, init_state, step, path="plain",
                                        moves_per_step=n)

    def _build_sweep_kernel(self, requester, cfg, score_fn,
                            score_precision=None):
        """Sweep-neighbourhood local search: dense value sweeps scored from
        ctx cumulants (`models/vrp/sweep.py`), winner re-scored exactly and
        accepted iff <= current — the reference's accept-best-neighbour
        semantics (`tabu_search_base.rs:139-155`) over a ~30x larger,
        value-structured neighbourhood. The winner materializes as a narrow
        delta, so apply/ctx-update/tabu machinery is the int-delta path's."""
        from greyjack_tpu.ops import selection

        vm = requester.variables_manager
        mod = requester.sweep_module
        sweep_cfg = mod.SweepConfig(requester, self.sweep_targets,
                                    self.sweep_window)
        utils = requester._delta_utils()
        # accept-boundary rounding (None when unrounded): candidate row =
        # rounded((ctx_ints + exact) / scales), compared lexicographically
        # against the rounded incumbent — reference `agent_base.rs:284-287`
        # semantics without leaving the integer sweep fast path
        ints_to_row = (base.make_rounded_ints_to_row_fn(
            requester, score_precision)
            if score_precision is not None else None)

        def init_state(key):
            population = vm.sample_variables(key, 1)
            scores = score_fn(population)
            state = base.base_state(population, scores)
            state["tabu"] = cfg.init_tabu_state()
            state["ctx"] = requester.build_base_ctx(population[0])
            state["sweep_scored"] = jnp.zeros((), jnp.int64)
            # candidates whose lateness was a bound, not exact (audit
            # visibility for the sweep's exactness contract)
            state["sweep_nonconv"] = jnp.zeros((), jnp.int64)
            state["sweep_stall"] = jnp.zeros((), jnp.int32)
            return state

        def step(key, state, extras):
            active = extras.get("_active", jnp.bool_(True))
            free = extras.get("_free")
            if free is None:
                free = cfg.tabu_free(state["tabu"])
            masks = cfg.tabu_masks(state["tabu"])
            delta, exact, info, stats = mod.propose(
                key, state["ctx"], free, masks, sweep_cfg, utils)
            stub = jnp.iinfo(exact.dtype).max
            forced = state["sweep_stall"] >= self.sweep_stall_limit
            if ints_to_row is None:
                cand_row = None
                improves = lexico.lex_leq(
                    exact, jnp.zeros((exact.shape[-1],), exact.dtype))
            else:
                cand_row = ints_to_row(requester.ctx_int_totals(state["ctx"])
                                       + exact.astype(jnp.int64))
                improves = lexico.lex_leq(cand_row, state["scores"][0])
            accept = (improves | forced) & active & (exact[0] != stub)
            winner = {**delta, "valid": delta["valid"] & accept}
            base_row = state["population"][0]
            state = dict(state)
            state["population"] = moves.apply_delta(base_row, winner)[None, :]
            state["ctx"] = requester.update_ctx(state["ctx"], winner)
            new_score = (cand_row if cand_row is not None
                         else requester.ctx_score_row(state["ctx"]))
            new_best = lexico.lex_less(new_score, state["top_score"]) & accept
            state["sweep_stall"] = jnp.where(
                active, jnp.where(new_best, 0, state["sweep_stall"] + 1),
                state["sweep_stall"])
            state["scores"] = jnp.where(
                accept, new_score[None, :], state["scores"])
            if cfg.use_tabu:
                # the reference pushes touched ids during sampling
                # (`mover.rs:75-96`) — push the winner's targets whether or
                # not accepted, rotating sweep targets out of tabu
                state["tabu"] = selection.tabu_push(
                    state["tabu"], info["group"], info["positions"],
                    jnp.where(active, info["count"], 0))
            state["sweep_scored"] = state["sweep_scored"] + jnp.where(
                active, stats["n_scored"], 0)
            state["sweep_nonconv"] = state["sweep_nonconv"] + jnp.where(
                active, stats["n_nonconv"], 0)
            state = base.update_top(state)
            state["step_id"] = state["step_id"] + active.astype(
                state["step_id"].dtype)
            return state

        def refresh(state):
            state = dict(state)
            state["ctx"] = requester.build_base_ctx(state["population"][0])
            return state

        def prestep(batched_state):
            return {"_free": cfg.tabu_free(batched_state["tabu"])}

        return base.MetaheuristicKernel(
            self, init_state, step, refresh, self_gating=True,
            prestep=prestep, path="sweep",
            moves_per_step=sweep_cfg.conservative_moves_per_step(
                utils, self.tabu_entity_rate))
