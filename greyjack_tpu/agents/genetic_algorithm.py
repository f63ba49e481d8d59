"""GeneticAlgorithm — population metaheuristic with p-best parent selection.

Reference: `greyjack/src/agents/genetic_algorithm.rs:16-84` and
`genetic_algorithm_base.rs:23-235`. Sampling picks two p-best parents
uniformly from the sorted top `ceil(U(0,p_best_rate)*N)`, applies a
convex-combination crossover with a single shared weight (discrete genes get
the rint'ed weight, i.e. whole-gene inheritance — `cross`,
`genetic_algorithm_base.rs:105-134`), then one Mover move per child.
Replacement pits each candidate against a random p-worst native; better
score wins (`build_updated_population`, `:198-213`).

On the device all pairs are generated/crossed/moved/scored as one batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from greyjack_tpu.agents import base
from greyjack_tpu.ops import lexico, moves
from greyjack_tpu.utils.math_utils import rint_jnp


class GeneticAlgorithm:
    metaheuristic_kind = "Population"
    metaheuristic_name = "GeneticAlgorithm"

    def __init__(self, population_size, crossover_probability, p_best_rate,
                 tabu_entity_rate, mutation_rate_multiplier, move_probas,
                 migration_rate, migration_frequency, termination_strategy):
        self.population_size = int(population_size)
        self.crossover_probability = float(crossover_probability)
        self.p_best_rate = float(p_best_rate)
        self.tabu_entity_rate = float(tabu_entity_rate)
        self.mutation_rate_multiplier = mutation_rate_multiplier
        self.move_probas = move_probas
        self.migration_rate = float(migration_rate)
        self.migration_frequency = int(migration_frequency)
        self.termination_strategy = termination_strategy

    def build_kernel(self, requester, score_precision=None):
        vm = requester.variables_manager
        cfg = moves.MoverConfig(vm, self.tabu_entity_rate,
                                self.mutation_rate_multiplier, self.move_probas)
        score_fn = base.make_score_fn(requester, score_precision)
        p = self.population_size
        half = -(-p // 2)
        n_children = 2 * half
        p_best_rate = self.p_best_rate
        cross_proba = self.crossover_probability
        discrete = vm.discrete_mask

        def p_best_ids(key, count):
            """`select_p_best` (`genetic_algorithm_base.rs:83-92`)."""
            k1, k2 = jax.random.split(key)
            proba = jax.random.uniform(k1, (count,), jnp.float64,
                                       minval=1e-6, maxval=p_best_rate)
            last_top = jnp.ceil(proba * p).astype(jnp.int32)
            u = jax.random.uniform(k2, (count,), jnp.float64)
            return jnp.floor(u * last_top).astype(jnp.int32)

        def p_worst_ids(key, count):
            """`select_p_worst` (`:94-103`)."""
            k1, k2 = jax.random.split(key)
            proba = jax.random.uniform(k1, (count,), jnp.float64,
                                       minval=1e-6, maxval=p_best_rate)
            last_top = jnp.ceil(proba * p).astype(jnp.int32)
            u = jax.random.uniform(k2, (count,), jnp.float64)
            return (p - last_top + jnp.floor(u * last_top)).astype(jnp.int32)

        def init_state(key):
            keys = jax.random.split(key, p)
            population = jax.vmap(lambda k: vm.sample_variables(k, 1)[0])(keys)
            scores = score_fn(population)
            scores, population = lexico.lex_sort_scores_with(scores, population)
            state = base.base_state(population, scores)
            state["tabu"] = cfg.init_tabu_state()
            return state

        def step(key, state, extras):
            ks = jax.random.split(key, 6)
            population, scores = state["population"], state["scores"]

            parents_1 = population[p_best_ids(ks[0], half)]
            parents_2 = population[p_best_ids(ks[1], half)]
            # single shared crossover weight per pair; rint'ed for discrete
            # genes (`cross`, `genetic_algorithm_base.rs:105-134`)
            w = jax.random.uniform(ks[2], (half, 1), population.dtype)
            wg = jnp.where(discrete, rint_jnp(w), w)
            do_cross = (
                jax.random.uniform(ks[3], (half, 1), jnp.float64) <= cross_proba
            )
            child_1 = jnp.where(do_cross, parents_1 * wg + parents_2 * (1.0 - wg),
                                parents_1)
            child_2 = jnp.where(do_cross, parents_2 * wg + parents_1 * (1.0 - wg),
                                parents_2)
            children = jnp.concatenate([child_1, child_2], axis=0)

            moved, _info = moves.move_population(ks[4], children, vm, cfg,
                                                 state["tabu"])
            candidates = vm.fix_all(moved)[:p]
            cand_scores = score_fn(candidates)

            weak_ids = p_worst_ids(ks[5], p)
            weak = population[weak_ids]
            weak_scores = scores[weak_ids]
            cand_wins = lexico.lex_leq(cand_scores, weak_scores)
            new_pop = jnp.where(cand_wins[:, None], candidates, weak)
            new_scores = jnp.where(cand_wins[:, None], cand_scores, weak_scores)
            new_scores, new_pop = lexico.lex_sort_scores_with(new_scores, new_pop)

            state = dict(state)
            state["population"] = new_pop
            state["scores"] = new_scores
            state = base.update_top(state)
            state["step_id"] = state["step_id"] + 1
            return state

        return base.MetaheuristicKernel(self, init_state, step, path="plain",
                                        moves_per_step=self.population_size)
