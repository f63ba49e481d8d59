"""Constraint registries.

Reference: `greyjack/src/score_calculation/score_calculators/
plain_score_calculator.rs:8-99` — named constraint closures over
(planning dfs, fact dfs, utility objects) returning one score per sample,
plus prescoring functions (shared precomputation) and per-constraint
weights applied as a sequential weighted sum.

Array redesign: a constraint is a pure JAX function over ONE candidate's typed
entity arrays; the framework vmaps the composed calculator over the whole
population, so every Polars group_by/join in the reference becomes a batched
gather/segment kernel here (see `greyjack_tpu.ops`). Dataframes never exist
on the hot path.

Constraint signature:
    fn(planning: {group: {col: array[n_entities]}},
       facts:    {group: {col: array[n_rows]}},
       utils:    dict) -> score components (tuple of scalars or f64[S])

Prescoring signature: same inputs -> dict merged into `utils` for the
constraints of this calculator (reference `plain_score_calculator.rs:52-58`).
"""

from __future__ import annotations

import jax.numpy as jnp


class PlainScoreCalculator:
    is_incremental = False

    def __init__(self, score_class):
        self.score_class = score_class
        self.score_size = score_class.precision_len()
        self.constraints: dict = {}
        self.constraint_weights: dict = {}
        self.prescoring_functions: dict = {}
        self.utility_objects: dict = {}

    # --- registry (reference API surface) ---------------------------------
    def add_constraint(self, name, fn, weight: float = 1.0):
        self.constraints[name] = fn
        self.constraint_weights[name] = float(weight)

    def remove_constraint(self, name):
        self.constraints.pop(name, None)
        self.constraint_weights.pop(name, None)

    def set_constraint_weights(self, weights: dict):
        for name, w in weights.items():
            self.constraint_weights[name] = float(w)

    def add_prescoring_function(self, name, fn):
        self.prescoring_functions[name] = fn

    def add_utility_object(self, name, obj):
        self.utility_objects[name] = obj

    # --- evaluation ---------------------------------------------------------
    def score_one(self, planning, facts, util_overrides=None):
        """Score a single candidate's frames -> f64[S].

        Vmapped over the population by `ScoreRequester`; weighted constraint
        results are folded in insertion order (fp-parity with the
        reference's sequential `add_assign`, `plain_score_calculator.rs:79-90`).
        `util_overrides` (optional) is merged over the utility objects — the
        partitioned-facts mode injects its `dm_at` accessor here.
        """
        utils = dict(self.utility_objects)
        if util_overrides:
            utils.update(util_overrides)
        for fn in self.prescoring_functions.values():
            extra = fn(planning, facts, utils)
            if extra:
                utils.update(extra)

        total = jnp.zeros((self.score_size,), dtype=jnp.float64)
        for name, fn in self.constraints.items():
            row = fn(planning, facts, utils)
            if isinstance(row, (tuple, list)):
                row = jnp.stack([jnp.asarray(r, dtype=jnp.float64) for r in row])
            else:
                row = jnp.asarray(row, dtype=jnp.float64).reshape(self.score_size)
            w = self.constraint_weights[name]
            total = total + (row if w == 1.0 else w * row)
        return total


class IncrementalScoreCalculator(PlainScoreCalculator):
    """Delta (incremental) scoring — the reference's delta-df calculator
    (`incremental_score_calculator.rs:8-104`) re-mapped to device arrays.

    The reference hands each constraint `delta_dfs` (one row per changed
    variable per sample, `oop_score_requester.rs:384-441`). Here the
    formulation is a kernel pair registered by the model:

        build_ctx(planning, facts, utils) -> ctx
            full O(N) pass over ONE base candidate per step: value
            histograms, route legs, per-vehicle structures, base score
            components — everything the deltas difference against.
        score_delta(ctx, delta, utils) -> f64[S]
            O(K) per neighbour (vmapped over the whole neighbourhood):
            delta = {"positions": i32[K] flat var ids,
                     "values": float[K], "valid": bool[K]}.

    Local-search agents (TabuSearch/LateAcceptance/SimulatedAnnealing) use
    the pair when present: the per-step cost drops from
    O(neighbours * N log N) to O(N log N + neighbours * K), which is the
    reference's own incremental insight (~5x nqueens, ~20x VRP on CPU —
    `examples/vrp/src/score/incremental_score_calculator.rs:21-26`) and the
    route to the BASELINE scored-moves/s target. Population agents
    (GA/LSHADE) always full-score — every candidate is new (the reference
    GA panics on incremental mode, `genetic_algorithm_base.rs:189-196`).

    Falls back to the plain batched path when no kernels are registered.
    """

    is_incremental = True

    def __init__(self, score_class):
        super().__init__(score_class)
        self.delta_ctx_fn = None
        self.delta_score_fn = None
        self.delta_update_fn = None
        self.delta_ctx_score_fn = None
        self.delta_score_ints_fn = None
        self.delta_ints_eligible_fn = None
        self.delta_ctx_ints_fn = None
        self.score_int_scales = None
        self.sweep_module = None

    def set_delta_kernels(self, build_ctx, score_delta, update_ctx,
                          ctx_score=None, ctx_ints=None, int_scales=None):
        """Register the delta kernel triple. `update_ctx(ctx, delta, utils)`
        applies one ACCEPTED delta to the ctx in O(K) (identity when the
        delta has no valid entries) — local-search steps never re-run the
        O(N) base pass; the ctx lives in agent state and is only rebuilt
        when migration swaps the base candidate.
        `ctx_score(ctx, utils) -> f64[S]` (optional): the ctx's own base
        score from its exact integer sums — required for the int-delta
        local-search fast path (see set_delta_ints_kernel).
        `ctx_ints(ctx, utils) -> i64[S]` (optional): the ctx's exact INTEGER
        score totals, with `int_scales` (length-S divisors) mapping them to
        the f64 score space (`f64_row = ints / scales`). Registering the
        pair keeps the int-delta and sweep fast paths live under
        `score_precision`: agents derive the candidate's f64 row from
        `ctx_ints + delta_ints`, apply the reference's truncating decimal
        round (`math_utils.rs:9-12`) and compare ROUNDED rows at the accept
        boundary — bit-identical to rounding a full plain rescore, because
        the integer delta arithmetic is exact."""
        self.delta_ctx_fn = build_ctx
        self.delta_score_fn = score_delta
        self.delta_update_fn = update_ctx
        self.delta_ctx_score_fn = ctx_score
        self.delta_ctx_ints_fn = ctx_ints
        if int_scales is not None:
            self.score_int_scales = [float(s) for s in int_scales]

    def set_delta_ints_kernel(self, score_delta_ints, eligible):
        """Optionally register an integer delta scorer
        `(ctx, delta, utils) -> i32[S]` returning DELTA rows
        lexicographically order-equivalent to `score_delta`'s f64 rows
        (a candidate is accepted iff its row is <= 0), with INT32_MAX rows
        for neighbours `score_delta` scores as the stub. Local search then
        ranks and accepts on integers and materializes an f64 row only for
        the winner. `eligible(utils, delta_width) -> bool` is the static
        condition under which the rows are exact; agents take the integer
        path only where it holds."""
        self.delta_score_ints_fn = score_delta_ints
        self.delta_ints_eligible_fn = eligible

    def set_sweep_module(self, module):
        """Optionally register a sweep-neighbourhood module (dense
        value-sweep scoring; see `models/vrp/sweep.py`). The module exposes
        `eligible(utils) -> bool` (static), `SweepConfig(requester, ...)`
        and `propose(key, ctx, free, tabu_masks, cfg, utils)`; local-search
        agents use it when present and eligible."""
        self.sweep_module = module

    @property
    def has_delta_kernels(self):
        return self.delta_ctx_fn is not None
