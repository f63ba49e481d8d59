"""Hash/row-partitioned fact tables over a `facts` mesh axis.

DESIGN.md §6: replicated fact tables stop working when the facts outgrow
one device's memory — the dominant table is the [L, L] distance matrix
(an i32 matrix for L ~ 140k customers fills an 80 GB card). The layout is
a 2-D mesh
`(islands, facts)`: populations stay data-parallel on `islands`; the
distance matrix is row-sharded over `facts`, and the per-step dm lookups
become an owner-computes exchange.

Because each island's lookup REQUESTS are small ([P] index vectors) and
live replicated along the `facts` axis, the exchange is
request-broadcast / owner-answers / `psum`-combine — no data-dependent
all_to_all buckets are needed (the DESIGN §6 bucket exchange is the
generalization for sharded requests). Skew is a non-issue in this form:
every shard scans the same [P] request vector and answers only the rows it
owns, so a hub customer concentrates no extra traffic.

Used under `jax.shard_map` with the dm placed `P('facts', None)`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def shard_rows(dm, n_shards):
    """Host helper: pad the row axis to a multiple of n_shards and return
    (padded_dm, rows_per_shard). Shard i owns rows [i*r, (i+1)*r)."""
    l = dm.shape[0]
    r = -(-l // n_shards)
    pad = n_shards * r - l
    if pad:
        dm = jnp.pad(dm, ((0, pad), (0, 0)))
    return dm, r


def shard_rows_flat(dm, n_shards):
    """Host helper: row-pad the matrix and return (flat_padded i32[S*r*L],
    rows_per_shard). The flat layout keeps shard i's rows at flat indices
    [i*r*L, (i+1)*r*L) so `sharded_dm_gather_flat` can own-compute on the
    flat index directly — the score kernels' native dm access pattern
    (`ops/routes.vrp_routes_packed`)."""
    padded, r = shard_rows(dm, n_shards)
    return padded.reshape(-1), r


def sharded_dm_gather_flat(dm_shard_flat, flat_idx, n_locations, axis_name):
    """dm.reshape(-1)[flat_idx] with the dm ROW-sharded over `axis_name`.

    dm_shard_flat: i32[rows_per_shard * L] — this device's row block,
    flattened; flat_idx: i32[...] flat (u*L + v) request indices REPLICATED
    along `axis_name`. Owner-computes + psum, same exchange as
    `sharded_dm_gather` but on the flat index space the route kernels use.
    """
    block = dm_shard_flat.shape[0]
    me = jax.lax.axis_index(axis_name)
    lo = me.astype(flat_idx.dtype) * block
    local = jnp.clip(flat_idx - lo, 0, block - 1)
    mine = (flat_idx >= lo) & (flat_idx < lo + block)
    vals = jnp.where(mine, dm_shard_flat[local], 0)
    return jax.lax.psum(vals, axis_name)


def sharded_dm_gather(dm_shard, u, v, axis_name):
    """dm[u, v] with the dm row-sharded over `axis_name`.

    dm_shard: i32[rows_per_shard, L] — this device's row block;
    u, v: i32[...] request indices, REPLICATED along `axis_name`.
    Returns i32[...] = full-matrix dm[u, v], replicated.

    Owner-computes: each shard gathers from its block where it owns row u
    (local index u - lo, clamped; non-owned lanes contribute 0) and a psum
    over the facts axis assembles the answer. Communication per call is one
    psum of the request-shaped payload — independent of L.
    """
    r = dm_shard.shape[0]
    me = jax.lax.axis_index(axis_name)
    lo = me.astype(jnp.int32) * r
    local = jnp.clip(u - lo, 0, r - 1)
    mine = (u >= lo) & (u < lo + r)
    vals = jnp.where(mine, dm_shard[local, v], 0)
    return jax.lax.psum(vals, axis_name)
