"""Chromosome-space <-> entity-array-space bridge — the hot data path.

Reference `OOPScoreRequester` (`greyjack/src/score_calculation/
score_requesters/oop_score_requester.rs:17-470`) scatters candidate values
into replicated Polars frames per step. This redesign compiles the cotwin
once into:

  * a flat variable schema (`VariablesManager` arrays),
  * per-(group, column) gather maps `var_ids[n_entities]`,
  * dense fact arrays,

after which "building the scoring frames" for a whole population is a single
gather + fix per planning column — no concat, no rechunk, no host loop.
Variable naming keeps the reference's solution-JSON contract
`"{group}: {var_index}-->{attr}"` (`oop_score_requester.rs:104`).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from greyjack_tpu import config
from greyjack_tpu.utils.math_utils import rint_jnp
from greyjack_tpu.variables.planning_variables import _PlanningVariable
from greyjack_tpu.score_calculation.score_requesters.variables_manager import (
    VariablesManager,
)


def _fact_array(values):
    arr = np.asarray(values)
    if arr.dtype.kind in "ui":
        return jnp.asarray(arr.astype(np.int32))
    if arr.dtype.kind == "f":
        return jnp.asarray(arr.astype(np.float64))
    if arr.dtype.kind == "b":
        return jnp.asarray(arr)
    return arr  # strings etc. stay host-side


class ScoreRequester:
    def __init__(self, cotwin):
        self.cotwin = cotwin

        variables = []
        # planning groups: {group: {"n": int, "columns": [(name, kind)],
        #                           "var_ids": {col: int32[n]},
        #                           "facts": {col: array[n]}}}
        self.planning_schema = {}
        var_index = 0
        for group_name, entities in cotwin.planning_entities.items():
            schema = {"n": len(entities), "columns": [], "var_ids": {}, "facts": {}}
            col_kinds = None
            fact_cols: dict = {}
            var_id_cols: dict = {}
            for entity in entities:
                pairs = entity.to_vec()
                if col_kinds is None:
                    col_kinds = [
                        (name, "planning" if isinstance(v, _PlanningVariable) else "fact")
                        for name, v in pairs
                    ]
                for attr_name, value in pairs:
                    if isinstance(value, _PlanningVariable):
                        full_name = f"{group_name}: {var_index}-->{attr_name}"
                        value.set_name(full_name)
                        variables.append(value)
                        var_id_cols.setdefault(attr_name, []).append(var_index)
                        var_index += 1
                    else:
                        fact_cols.setdefault(attr_name, []).append(value)
            schema["columns"] = col_kinds or []
            # is_discrete resolved host-side BEFORE device arrays exist, so
            # the schema build never reads from the device
            schema["is_discrete"] = {
                c: bool(variables[ids[0]].is_discrete)
                for c, ids in var_id_cols.items()
            }
            schema["var_ids_np"] = {
                c: np.asarray(ids, dtype=np.int32)
                for c, ids in var_id_cols.items()
            }
            schema["var_ids"] = {
                c: jnp.asarray(v) for c, v in schema["var_ids_np"].items()
            }
            # affine index patterns (start + stride*i) become strided slices
            # instead of gathers (a slice is a contiguous read)
            schema["affine"] = {}
            for c, ids in var_id_cols.items():
                arr = np.asarray(ids)
                if len(arr) == 1:
                    schema["affine"][c] = (int(arr[0]), 1)
                elif len(arr) > 1:
                    stride = int(arr[1] - arr[0])
                    if stride > 0 and (np.diff(arr) == stride).all():
                        schema["affine"][c] = (int(arr[0]), stride)
            schema["facts"] = {c: _fact_array(v) for c, v in fact_cols.items()}
            self.planning_schema[group_name] = schema

        # problem-fact groups -> dense arrays
        self.fact_frames = {}
        for group_name, facts in cotwin.problem_facts.items():
            cols: dict = {}
            for fact in facts:
                for attr_name, value in fact.to_vec():
                    cols.setdefault(attr_name, []).append(value)
            self.fact_frames[group_name] = {c: _fact_array(v) for c, v in cols.items()}

        self.variables_manager = VariablesManager(variables)
        self.score_size = cotwin.score_calculator.score_size
        self.score_class = cotwin.score_calculator.score_class

        # delta schema: flat var id -> (entity row, planning-column index)
        # inside its group — the array analog of the reference's var_id ->
        # (df, column, row) map (`oop_score_requester.rs:357-382`)
        var_row = np.zeros(len(variables), dtype=np.int32)
        var_col = np.zeros(len(variables), dtype=np.int32)
        for schema in self.planning_schema.values():
            planning_cols = [c for c, kind in schema["columns"]
                             if kind == "planning"]
            for ci, col in enumerate(planning_cols):
                # host copy — no device->host read while the schema is
                # built
                ids = schema["var_ids_np"][col]
                var_row[ids] = np.arange(len(ids), dtype=np.int32)
                var_col[ids] = ci
        self.var_row = jnp.asarray(var_row)
        self.var_col = jnp.asarray(var_col)
        # packed [V, 2] (row, col): one gather instead of two on the delta
        # hot path
        self.var_rowcol = jnp.asarray(
            np.stack([var_row, var_col], axis=-1))

    # --- delta (incremental) path --------------------------------------------
    @property
    def supports_delta(self):
        calc = self.cotwin.score_calculator
        return bool(getattr(calc, "has_delta_kernels", False))

    @property
    def supports_sweep(self):
        """True when the model registered a sweep-neighbourhood module and
        this instance passes its static eligibility gate (trace-time
        static; agents branch in Python)."""
        calc = self.cotwin.score_calculator
        mod = getattr(calc, "sweep_module", None)
        if mod is None or not self.supports_delta:
            return False
        return bool(mod.eligible(self._delta_utils()))

    @property
    def sweep_module(self):
        return getattr(self.cotwin.score_calculator, "sweep_module", None)

    def _delta_utils(self):
        calc = self.cotwin.score_calculator
        utils = dict(calc.utility_objects)
        utils["delta_schema"] = {"var_row": self.var_row,
                                 "var_col": self.var_col,
                                 "var_rowcol": self.var_rowcol}
        return utils

    def build_base_ctx(self, base_row):
        """One O(N) pass over the base candidate f[V] -> model ctx pytree.
        Run once per local-search step; neighbours score against it."""
        calc = self.cotwin.score_calculator
        frames = self.build_frames(base_row)
        return calc.delta_ctx_fn(frames, self.fact_frames, self._delta_utils())

    def request_score_delta(self, ctx, deltas):
        """Score a whole neighbourhood of deltas against one base ctx.

        deltas: {"positions": i32[n, K], "values": f[n, K],
                 "valid": bool[n, K]} -> f64[n, S].
        """
        calc = self.cotwin.score_calculator
        utils = self._delta_utils()

        def one(delta):
            return calc.delta_score_fn(ctx, delta, utils)

        return jax.vmap(one)(deltas)

    def supports_delta_ints(self, delta_width):
        """True when the model registered an integer delta scorer and its
        static eligibility holds for deltas `delta_width` wide (see
        `set_delta_ints_kernel`); agents branch on it in Python."""
        calc = self.cotwin.score_calculator
        ints_fn = getattr(calc, "delta_score_ints_fn", None)
        if ints_fn is None or getattr(calc, "delta_ctx_score_fn", None) is None:
            return False
        return bool(calc.delta_ints_eligible_fn(self._delta_utils(),
                                                int(delta_width)))

    def request_score_delta_ints(self, ctx, deltas):
        """Integer delta rows i32[n, S] for the local-search accept loop.
        Only valid where `supports_delta_ints` holds for the deltas' width."""
        calc = self.cotwin.score_calculator
        utils = self._delta_utils()
        return jax.vmap(
            lambda d: calc.delta_score_ints_fn(ctx, d, utils))(deltas)

    def ctx_score_row(self, ctx):
        """f64[S] score of the ctx's base candidate from its exact sums."""
        calc = self.cotwin.score_calculator
        return calc.delta_ctx_score_fn(ctx, self._delta_utils())

    @property
    def supports_rounded_fast_paths(self):
        """True when the model registered its exact integer score totals
        (`set_delta_kernels(ctx_ints=..., int_scales=...)`) — the int-delta
        and sweep fast paths then stay live under `score_precision` by
        rounding at the accept boundary (see `score_calculator.py`)."""
        calc = self.cotwin.score_calculator
        return (getattr(calc, "delta_ctx_ints_fn", None) is not None
                and getattr(calc, "score_int_scales", None) is not None)

    def ctx_int_totals(self, ctx):
        """i64[S] exact integer score totals of the ctx's base candidate."""
        calc = self.cotwin.score_calculator
        return calc.delta_ctx_ints_fn(ctx, self._delta_utils())

    @property
    def score_int_scales(self):
        import jax.numpy as _jnp
        return _jnp.asarray(self.cotwin.score_calculator.score_int_scales,
                            _jnp.float64)

    def update_ctx(self, ctx, delta):
        """Apply one accepted delta to the ctx (O(K); identity when the
        delta has no valid entries)."""
        calc = self.cotwin.score_calculator
        return calc.delta_update_fn(ctx, delta, self._delta_utils())

    # --- frames -------------------------------------------------------------
    def build_frames(self, population):
        """population f64[..., V] -> {group: {col: typed [..., n_entities]}}.

        Planning integer columns come out as int64 (the reference's
        `AnyValue::Int64` inverse transform, `variables_manager.rs:136-152`),
        floats as clamped f64. Fact columns of planning groups are broadcast
        constants.
        """
        vm = self.variables_manager
        fixed = vm.fix_all(population)
        frames = {}
        for group_name, schema in self.planning_schema.items():
            cols = {}
            for col, var_ids in schema["var_ids"].items():
                n = var_ids.shape[0]
                if col in schema["affine"]:
                    start, stride = schema["affine"][col]
                    vals = jax.lax.slice_in_dim(
                        fixed, start, start + (n - 1) * stride + 1, stride,
                        axis=fixed.ndim - 1,
                    )
                else:
                    vals = fixed[..., var_ids]
                if schema["is_discrete"][col]:
                    cols[col] = vals.astype(config.INT_DTYPE)
                else:
                    cols[col] = vals
            for col, arr in schema["facts"].items():
                if hasattr(arr, "dtype"):
                    cols[col] = jnp.broadcast_to(arr, population.shape[:-1] + arr.shape)
                else:
                    cols[col] = arr
            frames[group_name] = cols
        return frames

    # --- scoring ------------------------------------------------------------
    def request_score_plain(self, population, util_overrides=None):
        """f64[P, V] -> f64[P, S] — jit/vmap-compatible, the per-step hot path
        (reference `request_score_plain`, `oop_score_requester.rs:336-355`)."""
        calculator = self.cotwin.score_calculator
        frames = self.build_frames(population)

        def score_sample(sample_frames):
            return calculator.score_one(sample_frames, self.fact_frames,
                                        util_overrides)

        return jax.vmap(score_sample)(frames)

    # --- partitioned facts (SURVEY.md §5 long-context analog) ---------------
    def partitioned_plain_score_fn(self, facts_axis="facts"):
        """Plain scoring with the distance matrix ROW-SHARDED over a mesh
        `facts` axis instead of replicated (the reference replicates the
        fact frame per sample AND per agent thread,
        `oop_score_requester.rs:204-211` — replication is what stops
        scaling once facts outgrow one chip's HBM; DESIGN.md §6).

        Returns `fn(dm_shard_flat, population) -> f64[P, S]` for use INSIDE
        `jax.shard_map` over a 2-D `(islands, facts)` mesh: pass the flat
        padded milli matrix (`ops/partitioned.shard_rows_flat`) with spec
        `P(facts_axis)` and the population with `P(islands, None, None)`
        (replicated along facts). Every dm lookup becomes an
        owner-computes + psum exchange; scores are BIT-IDENTICAL to
        replicated mode (integer gathers, one-hot psum contributions).

        Only the plain path is partitioned: the delta/sweep fast paths keep
        device-resident dense tables (they exist precisely because the
        instance fits) — partitioned mode targets instances that DON'T fit,
        where plain batched scoring is the only option.
        """
        from greyjack_tpu.ops import partitioned

        calc = self.cotwin.score_calculator
        if calc.utility_objects.get("exact_fp_scores"):
            raise ValueError(
                "partitioned facts require the integer-milli score path "
                "(exact_fp_scores=False)")
        l = calc.utility_objects["n_locations"]

        def fn(dm_shard_flat, population):
            def dm_at(flat_idx):
                return partitioned.sharded_dm_gather_flat(
                    dm_shard_flat, flat_idx, l, facts_axis)

            return self.request_score_plain(population, {"dm_at": dm_at})

        return fn

    def score_fn(self):
        """Return a pure `population -> scores` callable for jit/scan."""
        return self.request_score_plain
