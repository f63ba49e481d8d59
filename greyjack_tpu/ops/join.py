"""Gather-free lookup/permutation kernels — the sort-merge join layer.

These kernels replace gathers with sorts + scatters + log-depth scans, all
full-width vector work. They were written for a device whose gathers were
serial loads; on a GPU a gather is a plain memory read, and ROADMAP Design
item 2 tests each against its gather form:

  * `sort_merge_lookup` — the BASELINE north star's "hash join" as a
    sort-merge join: concat(table keys, query keys) -> stable sort ->
    log-depth forward-fill of table payloads -> scatter back to query
    positions. Replaces F separate fact-column gathers with one sort.
  * `apply_permutation` — y[i] = x[p[i]] for a permutation p via the
    double-sort identity (sort (p, iota) yields the inverse permutation as
    payload, then one scatter places x). Replaces per-element gathers in
    the move kernels.

All kernels are per-candidate ([N]-shaped) and vmap-friendly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _ffill_log(values, valid, sentinel):
    """Forward-fill `values` where `valid` is False, log-depth doubling.
    Positions before the first valid entry keep `sentinel`."""
    n = values.shape[-1]
    vals = jnp.where(valid, values, sentinel)
    have = valid
    d = 1
    while d < n:
        shifted_vals = jnp.concatenate(
            [jnp.full_like(vals[..., :d], sentinel), vals[..., :-d]], axis=-1
        )
        shifted_have = jnp.concatenate(
            [jnp.zeros_like(have[..., :d]), have[..., :-d]], axis=-1
        )
        take = ~have & shifted_have
        vals = jnp.where(take, shifted_vals, vals)
        have = have | shifted_have
        d *= 2
    return vals


def sort_merge_lookup(table, keys, key_domain=None):
    """rows[i] = table[keys[i]] without gathers.

    table: i32[L, F] (or [L] for a single column); keys: i32[N] in [0, L).
    Returns [N, F] (or [N]). One stable sort of L+N keys with F+2 carried
    payloads, F log-depth forward-fills, one scatter.
    """
    single = table.ndim == 1
    if single:
        table = table[:, None]
    l, f = table.shape
    n = keys.shape[0]

    all_keys = jnp.concatenate([jnp.arange(l, dtype=keys.dtype), keys])
    is_query = jnp.concatenate(
        [jnp.zeros((l,), jnp.int32), jnp.ones((n,), jnp.int32)]
    )
    # query position (for the scatter back); table rows carry -1
    pos = jnp.concatenate(
        [jnp.full((l,), -1, jnp.int32), jnp.arange(n, dtype=jnp.int32)]
    )
    payload_cols = [table[:, i] for i in range(f)]
    padded_cols = [
        jnp.concatenate([col, jnp.zeros((n,), col.dtype)]) for col in payload_cols
    ]

    sorted_ops = jax.lax.sort(
        (all_keys, is_query, pos, *padded_cols), num_keys=2, is_stable=True
    )
    s_query = sorted_ops[1] == 1
    s_pos = sorted_ops[2]
    s_cols = sorted_ops[3:]

    out_cols = []
    for col in s_cols:
        filled = _ffill_log(col, ~s_query, jnp.zeros((), col.dtype))
        out_cols.append(filled)

    out = jnp.zeros((n, f), table.dtype)
    scatter_pos = jnp.where(s_query, s_pos, n)  # table rows dropped
    stacked = jnp.stack(out_cols, axis=-1)  # [L+N, F]
    out = out.at[scatter_pos].set(stacked, mode="drop")
    return out[:, 0] if single else out


def sort_merge_lookup_with_dups(table, keys):
    """`sort_merge_lookup` that also returns the duplicate count of `keys`
    (len - n_unique, computed from the merge's internal sorted order for
    free — replaces a bincount scatter)."""
    single = table.ndim == 1
    if single:
        table = table[:, None]
    l, f = table.shape
    n = keys.shape[0]

    all_keys = jnp.concatenate([jnp.arange(l, dtype=keys.dtype), keys])
    is_query = jnp.concatenate(
        [jnp.zeros((l,), jnp.int32), jnp.ones((n,), jnp.int32)]
    )
    pos = jnp.concatenate(
        [jnp.full((l,), -1, jnp.int32), jnp.arange(n, dtype=jnp.int32)]
    )
    padded_cols = [
        jnp.concatenate([table[:, i], jnp.zeros((n,), table.dtype)])
        for i in range(f)
    ]
    sorted_ops = jax.lax.sort(
        (all_keys, is_query, pos, *padded_cols), num_keys=2, is_stable=True
    )
    s_keys = sorted_ops[0]
    s_query = sorted_ops[1] == 1
    s_pos = sorted_ops[2]
    s_cols = sorted_ops[3:]

    # duplicates among the query keys: adjacent equal pairs where both are
    # queries (each table key appears exactly once and sorts before its
    # queries, so query-query adjacency counts key multiplicity - 1)
    dup = (s_keys[1:] == s_keys[:-1]) & s_query[1:] & s_query[:-1]
    dup_count = jnp.sum(dup).astype(jnp.float64)

    out_cols = [
        _ffill_log(col, ~s_query, jnp.zeros((), col.dtype)) for col in s_cols
    ]
    out = jnp.zeros((n, f), table.dtype)
    scatter_pos = jnp.where(s_query, s_pos, n)
    out = out.at[scatter_pos].set(jnp.stack(out_cols, axis=-1), mode="drop")
    return (out[:, 0] if single else out), dup_count


def iota_table_lookup(table, keys, with_dups=False):
    """rows[i] = table[keys[i]] for an iota-keyed table (row r has key r) —
    the common case for dense-id fact tables. Cheaper than the general
    sort-merge: only the queries are sorted (2-operand sort), merged
    positions are computed arithmetically (table key r lands at
    r + #queries<r; the j-th sorted query at q_j + 1 + j), table payloads
    are scattered into the merged layout, forward-filled, and scattered
    back to query positions. No gathers anywhere.
    """
    single = table.ndim == 1
    if single:
        table = table[:, None]
    l, f = table.shape
    n = keys.shape[0]
    m = l + n

    pos = jnp.arange(n, dtype=jnp.int32)
    sorted_q, q_pos = jax.lax.sort(
        (keys.astype(jnp.int32), pos), num_keys=1, is_stable=True
    )
    dup_count = jnp.sum(sorted_q[1:] == sorted_q[:-1]).astype(jnp.float64)

    counts = jnp.zeros((l,), jnp.int32).at[sorted_q].add(1, mode="drop")
    cnt_less = jnp.cumsum(counts) - counts  # exclusive cumsum, [L] (small)
    # merged order: table key r lands after the queries smaller than r;
    # the j-th sorted query lands after the r <= q_j table keys and the j
    # earlier queries
    table_slots = jnp.arange(l, dtype=jnp.int32) + cnt_less
    query_slots = sorted_q + 1 + jnp.arange(n, dtype=jnp.int32)

    merged_vals = jnp.zeros((m, f), table.dtype).at[table_slots].set(table)
    merged_have = jnp.zeros((m,), bool).at[table_slots].set(True)
    filled = jax.vmap(
        lambda col: _ffill_log(col, merged_have, jnp.zeros((), table.dtype)),
        in_axes=1, out_axes=1,
    )(merged_vals)

    out_pos = jnp.full((m,), n, jnp.int32).at[query_slots].set(q_pos, mode="drop")
    out = jnp.zeros((n, f), table.dtype).at[out_pos].set(filled, mode="drop")
    out = out if not single else out[:, 0]
    if with_dups:
        return out, dup_count
    return out


def apply_permutation(x, p):
    """y[i] = x[p[i]] for a permutation p of [0, n), gather-free.

    sort (p, iota) gives iota as sorted keys and q = argsort(p) as payload;
    since p is a permutation, y = scatter of x into positions q:
    y[q[j]] = x[j].
    """
    n = x.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    _, q = jax.lax.sort((p.astype(jnp.int32), idx), num_keys=1, is_stable=True)
    return jnp.zeros_like(x).at[q].set(x)


def counts_from_sorted(sorted_keys):
    """(n - n_unique) from an already-sorted key vector (adjacent compare),
    replacing bincount scatters."""
    dup = sorted_keys[1:] == sorted_keys[:-1]
    return jnp.sum(dup).astype(jnp.float64)
