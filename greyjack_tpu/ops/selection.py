"""Random selection kernels: distinct-id sampling with tabu avoidance.

The reference's `Mover::select_non_tabu_ids` (`greyjack/src/agents/
metaheuristic_bases/mover.rs:75-96`) rejection-samples ids not in a
per-semantic-group FIFO set, mutating the FIFO as it goes. Sequential
rejection + mutation does not vectorize; the batched equivalent is Gumbel top-k:
every valid position gets an i.i.d. Gumbel score, tabu positions get a large
penalty, and the top-k positions are the selection — distinct by
construction, tabu-avoiding unless the group is nearly exhausted (the
penalty is finite, mirroring the reference's behavior of always finding
*some* selection). The FIFO becomes a functional ring buffer updated once
per step (documented relaxation, SURVEY.md §7.3).
"""

import jax
import jax.numpy as jnp

TABU_PENALTY = 1.0e9


def gumbel_topk_positions(key, limit, k_max, tabu_mask=None, max_len=None):
    """Select up to `k_max` distinct positions uniformly from [0, limit).

    limit: traced int (positions >= limit masked out with -inf).
    tabu_mask: optional bool[max_len], True = recently used (penalized).
    Returns int32[k_max] positions, ordered by descending preference;
    callers activate the first `count` of them.
    """
    g = jax.random.gumbel(key, (max_len,), dtype=jnp.float32)
    pos = jnp.arange(max_len, dtype=jnp.int32)
    valid = pos < limit
    score = jnp.where(valid, g, -jnp.inf)
    if tabu_mask is not None:
        score = score - jnp.where(tabu_mask & valid, TABU_PENALTY, 0.0)
    k_eff = min(k_max, max_len)
    _, top = jax.lax.top_k(score, k_eff)
    top = top.astype(jnp.int32)
    if k_eff < k_max:
        # group smaller than the move-size cap: cycle the selection (callers
        # mask by `count`, which can't exceed the group length anyway)
        reps = -(-k_max // k_eff)
        top = jnp.tile(top, reps)[:k_max]
    return top


def sample_distinct_pair(key, limit, tabu_masks=None, group_idx=None,
                         attempts=4):
    """Two distinct uniform positions in [0, limit) — O(attempts) per draw.

    The k=2 hot path of position selection: a full-width Gumbel top-k costs
    [group_len] random draws + a top-k PER NEIGHBOUR (measured 7.9ms of a
    37ms TS step at P=16k, n=1000); a distinct pair needs two uniforms —
    b is drawn in [0, limit-1) and shifted past a, which is exactly uniform
    over the remaining ids. Tabu avoidance is bounded rejection (`attempts`
    redraws, take the first non-tabu candidate), approximating the
    reference's unbounded rejection loop (`mover.rs:75-96`) with failure
    probability tabu_rate^attempts (documented relaxation).

    tabu_masks: bool[G, lmax] (whole-table lookup by (group_idx, cand) —
    tiny per-attempt gathers, no [lmax]-wide row ever materializes).
    Returns int32[2].
    """
    limit = jnp.maximum(limit, 1)
    ka, kb = jax.random.split(key)
    if tabu_masks is None:
        ua = jax.random.uniform(ka, (), dtype=jnp.float32)
        a = jnp.floor(ua * limit).astype(jnp.int32)
        ub = jax.random.uniform(kb, (), dtype=jnp.float32)
        b1 = jnp.floor(ub * jnp.maximum(limit - 1, 1)).astype(jnp.int32)
        b = jnp.where(limit > 1, b1 + (b1 >= a).astype(jnp.int32), a)
        return jnp.stack([a, b])

    def first_free(k, lim, taken_fn):
        us = jax.random.uniform(k, (attempts,), dtype=jnp.float32)
        cands = jnp.floor(us * lim).astype(jnp.int32)
        free = ~taken_fn(cands)
        # first free candidate; fall back to the last draw (reference always
        # selects *something* once the group is nearly exhausted)
        pick = jnp.argmax(free)
        any_free = jnp.any(free)
        return jnp.where(any_free, cands[pick], cands[attempts - 1])

    def is_tabu(c):
        return tabu_masks[group_idx, c]

    a = first_free(ka, limit, is_tabu)
    b1 = first_free(kb, jnp.maximum(limit - 1, 1),
                    lambda c: is_tabu(c + (c >= a).astype(jnp.int32)))
    b = jnp.where(limit > 1, b1 + (b1 >= a).astype(jnp.int32), a)
    return jnp.stack([a, b])


def make_tabu_state(n_groups, capacity):
    """Functional ring buffer per semantic group: recently-touched positions."""
    return {
        "ring": jnp.full((n_groups, capacity), -1, dtype=jnp.int32),
        "cursor": jnp.zeros((n_groups,), dtype=jnp.int32),
    }


def tabu_mask_for_group(tabu_state, group_idx, tabu_sizes, max_len):
    """bool[max_len]: positions currently tabu for this group.

    `tabu_sizes[g]` = ceil(tabu_entity_rate * group_len) (reference
    `tabu_search_base.rs:91`); only the most recent `tabu_sizes[g]` ring
    entries count.
    """
    ring = tabu_state["ring"][group_idx]
    cursor = tabu_state["cursor"][group_idx]
    cap = ring.shape[0]
    slot = jnp.arange(cap, dtype=jnp.int32)
    # age 0 = most recently written slot
    age = (cursor - 1 - slot) % cap
    recent = age < tabu_sizes[group_idx]
    entries = jnp.where(recent & (ring >= 0), ring, max_len)
    mask = jnp.zeros((max_len + 1,), dtype=bool).at[entries].set(True)
    return mask[:max_len]


def tabu_masks_all(tabu_state, tabu_sizes, max_len):
    """bool[G, max_len]: tabu masks for EVERY group in one pass.

    Hoisted out of the per-neighbour sampler: the tabu rings are shared by
    the whole neighbourhood, so the masks are built once per step (one small
    scatter) and each neighbour selects its group's row — the per-neighbour
    [max_len] scatter this replaces was ~2/3 of round 1's move-sampling
    time at population batch sizes.
    """
    ring = tabu_state["ring"]  # [G, cap]
    cursor = tabu_state["cursor"]  # [G]
    g, cap = ring.shape
    slot = jnp.arange(cap, dtype=jnp.int32)[None, :]
    age = (cursor[:, None] - 1 - slot) % cap
    recent = age < tabu_sizes[:, None]
    entries = jnp.where(recent & (ring >= 0), ring, -1)
    # compare-based (no scatter): scatters turn into serialized 3D scatters
    # under the island vmap; [G, cap, max_len] compares stay vector ops
    masks = jnp.any(entries[:, :, None]
                    == jnp.arange(max_len, dtype=jnp.int32)[None, None, :],
                    axis=1)
    return masks


def tabu_mask_row(tabu_masks, group_idx):
    """Select one group's mask row without a dynamic gather: the group count
    is tiny and static, so an unrolled where-chain fuses into the consumer."""
    g = tabu_masks.shape[0]
    row = jnp.zeros((tabu_masks.shape[1],), dtype=bool)
    for gi in range(g):
        row = jnp.where(group_idx == gi, tabu_masks[gi], row)
    return row


def tabu_push(tabu_state, group_idx, positions, count):
    """Push `positions[:count]` into the group's ring (oldest evicted).
    Compare-select writes (no scatter — see tabu_masks_all)."""
    ring = tabu_state["ring"]
    cursor = tabu_state["cursor"]
    g, cap = ring.shape
    k_max = positions.shape[0]
    i = jnp.arange(k_max, dtype=jnp.int32)
    cur = jnp.sum(jnp.where(jnp.arange(g) == group_idx, cursor, 0),
                  dtype=cursor.dtype)
    slots = jnp.where(i < count, (cur + i) % cap, -1)     # [k_max]
    m = ((jnp.arange(g)[:, None, None] == group_idx)
         & (jnp.arange(cap)[None, :, None] == slots[None, None, :]))
    val = jnp.sum(jnp.where(m, positions[None, None, :], 0), axis=2,
                  dtype=ring.dtype)
    ring = jnp.where(jnp.any(m, axis=2), val, ring)
    cursor = jnp.where(jnp.arange(g) == group_idx, (cur + count) % cap,
                       cursor)
    return {"ring": ring, "cursor": cursor}


def random_permutation_positions(key, k_max, count):
    """Random permutation of [0, count) padded with identity up to k_max.

    Used by the scramble move: positions >= count map to themselves.
    """
    g = jax.random.gumbel(key, (k_max,), dtype=jnp.float32)
    i = jnp.arange(k_max, dtype=jnp.int32)
    score = jnp.where(i < count, g, -jnp.inf - i.astype(jnp.float32))
    _, perm = jax.lax.top_k(score, k_max)
    perm = perm.astype(jnp.int32)
    return jnp.where(i < count, perm, i)
