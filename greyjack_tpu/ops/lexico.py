"""Device-side lexicographic ops over score rows `f64[..., S]`.

The reference compares scores with a component-by-component `total_cmp`
(`hard_medium_soft_score.rs:96-117`). On device a score is a trailing-axis
row; these helpers provide compare / argmin / sort without packing floats
into a single key (hard scores can exceed f32/f64-mantissa packing tricks,
SURVEY.md §7.3).
"""

import jax
import jax.numpy as jnp


def lex_less(a, b):
    """Elementwise lexicographic a < b over trailing score axis.

    a, b: f64[..., S] -> bool[...]
    """
    s = a.shape[-1]
    lt = a < b
    gt = a > b
    result = jnp.zeros(a.shape[:-1], dtype=bool)
    decided = jnp.zeros(a.shape[:-1], dtype=bool)
    for i in range(s):
        result = jnp.where(~decided & lt[..., i], True, result)
        decided = decided | lt[..., i] | gt[..., i]
    return result

def lex_leq(a, b):
    return ~lex_less(b, a)


def lex_min2(a, b):
    """Rowwise lexicographic min of two score rows (same shape)."""
    take_a = lex_leq(a, b)
    return jnp.where(take_a[..., None], a, b)


def lex_argmin(scores):
    """Index of the lexicographically smallest row. scores: [N, S] -> i32
    (float or integer score rows — integer rows are the TS int-delta
    path).

    Ties resolve to the lowest index (matches `Iterator::min_by` in the
    reference, `tabu_search_base.rs:166-171`). S masked min-reductions plus
    one argmax — this runs on the hot path every step, where a full stable
    sort (the previous formulation) is ~10x the work for one index.
    """
    n, s = scores.shape
    big = (jnp.iinfo(scores.dtype).max
           if jnp.issubdtype(scores.dtype, jnp.integer) else jnp.inf)
    eligible = jnp.ones((n,), bool)
    for i in range(s):
        col = scores[:, i]
        m = jnp.min(jnp.where(eligible, col, big))
        eligible = eligible & (col == m)
    return jnp.argmax(eligible).astype(jnp.int32)


def lex_sort_order(scores):
    """Stable ascending lexicographic argsort of score rows f64[N, S]."""
    n, s = scores.shape
    keys = [scores[:, i] for i in range(s)]
    payload = jnp.arange(n, dtype=jnp.int32)
    # jax.lax.sort sorts by (k1, k2, ..., payload) with num_keys leading keys;
    # it is stable for equal keys.
    out = jax.lax.sort(tuple(keys) + (payload,), num_keys=s, is_stable=True)
    return out[-1]


def lex_sort_scores_with(scores, *payloads):
    """Sort rows of `scores` lexicographically ascending, carrying payloads.

    scores: f64[N, S]; payloads: arrays with leading dim N.
    Returns (sorted_scores, *gathered_payloads).
    """
    order = lex_sort_order(scores)
    return (scores[order],) + tuple(p[order] for p in payloads)


def stub_score_row(s, dtype=jnp.float64):
    """The reference's f64::MAX-1 sentinel (`simple_score.rs:60-64`)."""
    import sys

    return jnp.full((s,), sys.float_info.max - 1.0, dtype=dtype)
