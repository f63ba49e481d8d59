"""N-Queens cotwin + device score kernels.

Reference: `examples/nqueens/src/persistence/
cotwin_builder.rs:40-94` (one GJInteger row per queen, bounds 0..n-1) and
`score/plain_score_calculator.rs:26-67` — the fused `all_different`
constraint: per sample, (len - n_unique) over rows, descending (col+row)
and ascending (col-row) diagonals. The Polars group_by/n_unique becomes a
bincount kernel (`ops.segments.count_minus_n_unique`) vmapped over the
population.
"""

from __future__ import annotations

import jax.numpy as jnp

from greyjack_tpu.cotwin import Cotwin, CotwinBuilderBase
from greyjack_tpu.variables import GJInteger
from greyjack_tpu.score_calculation.scores import SimpleScore
from greyjack_tpu.score_calculation.score_calculators import (
    PlainScoreCalculator,
    IncrementalScoreCalculator,
)
from greyjack_tpu.ops import segments, moves


class CotQueen:
    def __init__(self, queen_id, row_id, column_id):
        self.queen_id = queen_id
        self.row_id = row_id
        self.column_id = column_id

    def to_vec(self):
        return [
            ("queen_id", self.queen_id),
            ("row_id", self.row_id),
            ("column_id", self.column_id),
        ]


def all_different(planning, facts, utils):
    queens = planning["queens"]
    rows = queens["row_id"]
    cols = queens["column_id"]
    n = rows.shape[0]
    row_conflicts = segments.count_minus_n_unique(rows, n)
    desc_conflicts = segments.count_minus_n_unique(cols + rows, 2 * n - 1)
    asc_conflicts = segments.count_minus_n_unique(cols - rows + (n - 1), 2 * n - 1)
    return (row_conflicts + desc_conflicts + asc_conflicts,)


# --- delta (incremental) kernels ---------------------------------------------
# The reference's incremental nqueens scorer patches a HashSet per delta row
# (`score/incremental_score_calculator.rs:23-57`, ~5x over plain); here the
# three conflict families (rows, desc diag, asc diag) keep base histograms in
# the ctx and each neighbour costs O(K) exact `nunique_delta`s.

def build_delta_ctx(planning, facts, utils):
    rows = planning["queens"]["row_id"]
    n = rows.shape[0]
    cols = jnp.arange(n, dtype=rows.dtype)
    counts_r = jnp.zeros((n,), jnp.int32).at[rows].add(1)
    counts_d = jnp.zeros((2 * n - 1,), jnp.int32).at[cols + rows].add(1)
    counts_a = jnp.zeros((2 * n - 1,), jnp.int32).at[cols - rows + (n - 1)
                                                     ].add(1)
    conflicts = (
        3 * n
        - jnp.sum(counts_r > 0)
        - jnp.sum(counts_d > 0)
        - jnp.sum(counts_a > 0)
    ).astype(jnp.int32)
    return {"rows": rows, "counts_r": counts_r, "counts_d": counts_d,
            "counts_a": counts_a, "conflicts": conflicts}


def score_delta(ctx, delta, utils):
    delta = moves.dedupe_delta(delta)
    rows_arr = ctx["rows"]
    n = rows_arr.shape[0]
    q = utils["delta_schema"]["var_row"][delta["positions"]]  # queen index
    valid = delta["valid"]
    nv = jnp.round(delta["values"]).astype(jnp.int32)
    old = rows_arr[q]
    z = jnp.zeros_like(nv)
    d = (
        segments.nunique_delta(ctx["counts_r"], jnp.where(valid, old, z),
                               jnp.where(valid, nv, z), valid)
        + segments.nunique_delta(ctx["counts_d"],
                                 jnp.where(valid, q + old, z),
                                 jnp.where(valid, q + nv, z), valid)
        + segments.nunique_delta(ctx["counts_a"],
                                 jnp.where(valid, q - old + (n - 1), z),
                                 jnp.where(valid, q - nv + (n - 1), z), valid)
    )
    return ((ctx["conflicts"] - d).astype(jnp.float64))[None]


def update_ctx(ctx, delta, utils):
    delta = moves.dedupe_delta(delta)
    rows_arr = ctx["rows"]
    n = rows_arr.shape[0]
    q = utils["delta_schema"]["var_row"][delta["positions"]]
    valid = delta["valid"]
    nv = jnp.round(delta["values"]).astype(jnp.int32)
    old = rows_arr[q]
    z = jnp.zeros_like(nv)

    def upd(counts, old_k, new_k, sent):
        return (
            counts
            .at[jnp.where(valid, old_k, sent)].add(-1, mode="drop")
            .at[jnp.where(valid, new_k, sent)].add(1, mode="drop")
        )

    d = (
        segments.nunique_delta(ctx["counts_r"], jnp.where(valid, old, z),
                               jnp.where(valid, nv, z), valid)
        + segments.nunique_delta(ctx["counts_d"],
                                 jnp.where(valid, q + old, z),
                                 jnp.where(valid, q + nv, z), valid)
        + segments.nunique_delta(ctx["counts_a"],
                                 jnp.where(valid, q - old + (n - 1), z),
                                 jnp.where(valid, q - nv + (n - 1), z), valid)
    )
    return {
        "rows": rows_arr.at[jnp.where(valid, q, n)].set(nv, mode="drop"),
        "counts_r": upd(ctx["counts_r"], old, nv, n),
        "counts_d": upd(ctx["counts_d"], q + old, q + nv, 2 * n - 1),
        "counts_a": upd(ctx["counts_a"], q - old + (n - 1),
                        q - nv + (n - 1), 2 * n - 1),
        "conflicts": ctx["conflicts"] - d,
    }


def ctx_int_totals(ctx, utils):
    """i64[1] exact integer score totals (SimpleScore is integral) —
    keeps the delta fast paths live under `score_precision`
    (accept-boundary rounding, `agents/base.py`)."""
    return ctx["conflicts"].astype(jnp.int64)[None]


class CotwinBuilder(CotwinBuilderBase):
    def __init__(self, use_incremental_score_calculation=True):
        self.use_incremental_score_calculation = use_incremental_score_calculation

    def build_cotwin(self, domain, is_already_initialized):
        n = domain.n
        cot_queens = []
        for i, queen in enumerate(domain.queens):
            cot_queens.append(
                CotQueen(
                    queen_id=i,
                    row_id=GJInteger(queen.row_id, 0, n - 1, False, None),
                    column_id=queen.column_id,
                )
            )

        cotwin = Cotwin()
        cotwin.add_planning_entities("queens", cot_queens)

        calc_cls = (
            IncrementalScoreCalculator
            if self.use_incremental_score_calculation
            else PlainScoreCalculator
        )
        calculator = calc_cls(SimpleScore)
        calculator.add_constraint("all_different", all_different)
        if self.use_incremental_score_calculation:
            calculator.set_delta_kernels(build_delta_ctx, score_delta,
                                         update_ctx,
                                         ctx_ints=ctx_int_totals,
                                         int_scales=[1.0])
        cotwin.add_score_calculator(calculator)
        return cotwin
