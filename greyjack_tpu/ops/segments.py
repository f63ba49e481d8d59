"""Segment/uniqueness kernels — the array replacements for the reference's
Polars group_by/agg idioms (SURVEY.md §7.1(2)).

All kernels are fixed-shape, vmap-friendly and avoid hash tables: group keys
in cotwin problems are dense small integers (queen rows, location ids,
vehicle ids), so `len - n_unique` penalties become bincount comparisons and
joins become gathers.
"""

import jax
import jax.numpy as jnp


def count_minus_n_unique(values, num_buckets):
    """`len(values) - n_unique(values)` for dense int values in [0, num_buckets).

    Replaces Polars `col.len() - col.n_unique()` (nqueens
    `plain_score_calculator.rs:44-48`, tsp `plain_score_calculator.rs:46`).
    values: int[N] -> f64 scalar.

    Sort-based distinct count, not a bincount: the bincount scatter was most
    of the VRP plain rescore under vmap, and one i32 sort + adjacent-compare
    needs no bucket bound. `num_buckets` is kept for API compatibility
    (unused).
    """
    if values.shape[0] == 0:
        return jnp.zeros((), jnp.float64)
    s = jnp.sort(values)
    n_unique = 1 + jnp.sum(s[1:] != s[:-1])
    return (values.shape[0] - n_unique).astype(jnp.float64)


def n_unique(values, num_buckets):
    counts = jnp.bincount(values, length=num_buckets)
    return jnp.sum(counts > 0)


def segment_sum(values, segment_ids, num_segments):
    """Sum `values` per segment id. Replaces `group_by(key).agg(sum)`."""
    return jax.ops.segment_sum(values, segment_ids, num_segments=num_segments)


def segment_count(segment_ids, num_segments):
    return jnp.bincount(segment_ids, length=num_segments)


def nunique_delta(counts, old_vals, new_vals, valid):
    """Exact change in n_unique when `old_vals[valid]` are replaced in-place
    by `new_vals[valid]`, given the base value histogram `counts` (i32[L]).

    The delta-scoring replacement for re-bincounting a whole column after a
    K-variable move: per distinct touched value v with base count c and net
    occupancy change d, n_unique changes by (c+d > 0) - (c > 0). K is tiny
    (DELTA_MOVE_SIZE), so the distinct-value grouping is an O(K^2) masked
    compare — cheaper and fusion-friendlier than sorting on this scale.

    Values must lie in [0, L). Returns an i32 scalar delta.
    """
    l = counts.shape[0]
    k = old_vals.shape[0]
    sent = jnp.asarray(l, jnp.int32)
    vals = jnp.concatenate([
        jnp.where(valid, old_vals.astype(jnp.int32), sent),
        jnp.where(valid, new_vals.astype(jnp.int32), sent),
    ])
    d = jnp.concatenate([
        jnp.where(valid, -1, 0), jnp.where(valid, 1, 0),
    ]).astype(jnp.int32)
    eq = vals[:, None] == vals[None, :]
    net = jnp.sum(jnp.where(eq, d[None, :], 0), axis=1)
    idx = jnp.arange(2 * k)
    earlier_dup = jnp.any(eq & (idx[None, :] < idx[:, None]), axis=1)
    cb = counts[jnp.minimum(vals, l - 1)]
    contrib = ((cb + net) > 0).astype(jnp.int32) - (cb > 0).astype(jnp.int32)
    mask = ~earlier_dup & (vals < l)
    return jnp.sum(jnp.where(mask, contrib, 0)).astype(jnp.int32)


def overflow_penalty(demands, segment_ids, capacities, num_segments):
    """Capacity-overflow penalty: sum over segments of max(0, load - cap).

    Replaces the VRP capacity constraint join+filter+agg
    (`examples/vrp/src/score/plain_score_calculator.rs:95-107`).
    """
    loads = segment_sum(demands, segment_ids, num_segments)
    over = jnp.maximum(loads - capacities, 0)
    return jnp.sum(over).astype(jnp.float64)
