"""The batched move library — array redesign of the reference `Mover`.

Reference (`greyjack/src/agents/metaheuristic_bases/mover.rs`): six move
types chosen by cumulative probability thresholds, operating on a random
semantic group, with per-group entity tabu and a Binomial change-count.
Every metaheuristic shares this library.

Array formulation: every move is a *permutation-with-resampling* of the
chromosome. The permutation is built WITHOUT per-element indexed loads
(written for a device whose gathers were serial; ROADMAP Design item 2
re-tests it against a gather on the GPU): selected positions are tiny [K]-sized
lookups, subrange rotations/reversals come from `roll`/`flip` of the
(dynamically sliced) group-member row, and the final application
`y[i] = x[p[i]]` uses the double-sort identity (`join.apply_permutation`)
— one [V]-wide sort instead of a [V]-wide gather. Under `vmap` the whole
population moves in a handful of fused full-width kernels.

Documented divergences from the reference (search-behavior only; score
functions are unaffected — SURVEY.md §7.3):
  * change-counts are capped at `config.MAX_MOVE_SIZE` (reference draws
    Binomial(n_vars, rate), which exceeds 8 with negligible probability at
    the default mutation rates);
  * `scramble` applies a uniformly random permutation of the window instead
    of the reference's sequential swap composition (`mover.rs:301-313`);
  * `insertion` uses the clean subrange rotation (the reference's
    *incremental* semantics, `mover.rs:362-369`);
  * entity tabu is a functional ring buffer updated once per step from the
    sampled positions (Gumbel-penalty avoidance) instead of a FIFO mutated
    mid-sampling.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from greyjack_tpu import config
from greyjack_tpu.ops import selection
from greyjack_tpu.ops.join import apply_permutation
from greyjack_tpu.utils.math_utils import round_decimal


def default_move_thresholds():
    """Reference default: six equal probabilities rounded to 3 decimals, the
    remainder folded into the first (`mover.rs:38-49`)."""
    inc = [round_decimal(1.0 / 6.0, 3)] * 6
    inc[0] += 1.0 - sum(inc)
    return np.cumsum(inc)


def thresholds_from_probas(move_probas):
    probas = list(move_probas)
    assert len(probas) == 6, "move_probas must have 6 entries"
    assert abs(sum(probas) - 1.0) < 1e-6, "move_probas must sum to 1.0"
    return np.cumsum(probas)


class MoverConfig:
    """Static (host-side) move configuration shared by all metaheuristics.

    Mirrors the reference Mover construction (`mover.rs:26-73`) plus the
    per-group mutation rates each metaheuristic base computes
    (`genetic_algorithm_base.rs:59-64`).

    Statically derives the delta-path geometry from the enabled move set:
    `delta_width` (positions a delta may carry) and `k_sel` (positions the
    selector must draw). A change+swap configuration with the default
    mutation rate (the reference's fastest VRP config, `vrp/src/main.rs:51`)
    needs only 2-wide deltas — 8x tighter shapes than the generic cap, which
    the whole downstream delta-scoring pipeline inherits.
    """

    def __init__(self, variables_manager, tabu_entity_rate=0.0,
                 mutation_rate_multiplier=None, move_probas=None):
        vm = variables_manager
        if move_probas is None:
            thr = default_move_thresholds()
            increments = np.diff(np.concatenate([[0.0], thr]))
        else:
            thr = thresholds_from_probas(move_probas)
            increments = np.asarray(move_probas, dtype=np.float64)
        self.thresholds = jnp.asarray(thr, dtype=jnp.float64)
        self.tabu_entity_rate = float(tabu_entity_rate)
        self.enabled = tuple(i for i in range(6) if increments[i] > 0.0)

        mult = 0.0 if mutation_rate_multiplier is None else float(mutation_rate_multiplier)
        self.rates_zero = mult == 0.0
        sizes = np.maximum(vm.group_sizes_np, 1)
        self.group_rates = jnp.asarray(mult / sizes, dtype=jnp.float64)
        # tabu size per group = max(ceil(rate * len), 1) (`tabu_search_base.rs:91`)
        self.tabu_sizes = jnp.asarray(
            np.minimum(
                np.maximum(np.ceil(tabu_entity_rate * sizes), 1).astype(np.int32),
                config.MAX_TABU_SIZE,
            )
        )
        self.use_tabu = tabu_entity_rate > 0.0
        self.n_groups = vm.n_semantic_groups
        self.max_group_size = vm.max_group_size
        self.group_sizes = vm.group_sizes

        # static per-move delta widths (positions a move may touch); with
        # zero mutation rates the Binomial change-count floor applies
        km = config.MAX_MOVE_SIZE
        widths = {
            0: 1 if self.rates_zero else km,        # change
            1: 2 if self.rates_zero else km,        # swap
            2: 4 if self.rates_zero else 2 * km,    # swap_edges (pairs)
            3: config.SCRAMBLE_MAX,                 # scramble window
            4: config.DELTA_MOVE_SIZE,              # insertion window cap
            5: config.DELTA_MOVE_SIZE,              # inverse window cap
        }
        sel_needs = {
            0: 1 if self.rates_zero else km,
            1: 2 if self.rates_zero else km,
            2: 2 if self.rates_zero else km,
            3: 0,
            4: 1,
            5: 1,
        }
        self.delta_width = max(widths[i] for i in self.enabled)
        self.k_sel = min(max(max(sel_needs[i] for i in self.enabled), 2), km)

    def init_tabu_state(self):
        cap = min(config.MAX_TABU_SIZE, max(2, self.max_group_size))
        return selection.make_tabu_state(max(1, self.n_groups), cap)

    def tabu_masks(self, tabu_state):
        """bool[G, lmax] masks, built once per step (see `tabu_masks_all`)."""
        if not self.use_tabu:
            return None
        return selection.tabu_masks_all(tabu_state, self.tabu_sizes,
                                        self.max_group_size)

    def tabu_free(self, tabu_state):
        """(free_list i32[G, Lmax], free_count i32[G]): per-group non-tabu
        slot ids, compacted ascending. Built ONCE per step (one small
        scatter); the narrow sampler then draws uniformly from the free set
        — exact tabu semantics (the bounded-rejection fallback could still
        pick tabu slots) and, decisively, no per-neighbour bool mask
        gather (at P=16k that gather cost more than the whole rest of the
        sampler).

        Accepts an island-batched state (ring [I, G, cap]) and returns
        [I, G, Lmax]/[I, G]: the batch flattens into the scatter's ROW
        axis, which XLA handles natively — under vmap the same build
        lowers to a batched 3D scatter (the kernel `prestep` hook exists
        exactly to route around that)."""
        ring = tabu_state["ring"]
        if ring.ndim == 3:
            i = ring.shape[0]
            flat = {"ring": ring.reshape(i * ring.shape[1], ring.shape[2]),
                    "cursor": tabu_state["cursor"].reshape(-1)}
            sizes_t = jnp.tile(self.tabu_sizes, i)
            gsizes_t = jnp.tile(self.group_sizes, i)
            fl, cnt = self._tabu_free_flat(flat, sizes_t, gsizes_t)
            return (fl.reshape(i, -1, self.max_group_size),
                    cnt.reshape(i, -1))
        return self._tabu_free_flat(tabu_state, self.tabu_sizes,
                                    self.group_sizes)

    def _tabu_free_flat(self, tabu_state, tabu_sizes, group_sizes):
        lmax = self.max_group_size
        slot = jnp.arange(lmax, dtype=jnp.int32)[None, :]
        free = slot < group_sizes[:, None]
        if self.use_tabu:
            free &= ~selection.tabu_masks_all(tabu_state, tabu_sizes, lmax)
        cnt = jnp.sum(free, axis=1, dtype=jnp.int32)
        # cumsum-rank scatter compaction (free slots first, ascending); an
        # argsort formulation put a sort network inside vmap x scan, whose
        # compile time was prohibitive at the bench geometry
        idx = jnp.cumsum(free, axis=1, dtype=jnp.int32) - 1
        g = free.shape[0]
        fl = jnp.zeros((g, lmax), jnp.int32).at[
            jnp.arange(g)[:, None], jnp.where(free, idx, lmax)
        ].set(jnp.broadcast_to(slot, free.shape), mode="drop")
        return fl, cnt


def _mswap(q, a, b, enable):
    """Swap q[a] <-> q[b] (scalar positions) when enabled."""
    va, vb = q[a], q[b]
    q = q.at[a].set(jnp.where(enable, vb, va))
    return q.at[b].set(jnp.where(enable, va, vb))


def do_move(key, candidate, vm, cfg: MoverConfig, tabu_masks):
    """Apply one randomly-drawn move to one candidate.

    candidate: f32/f64[V]. Returns (new_candidate, info) where info carries
    the touched group/positions for the per-step tabu update. Designed to
    be vmapped over the population axis. `tabu_masks`: bool[G, lmax] from
    `cfg.tabu_masks(tabu_state)` (shared by the whole batch) or None.
    """
    k_max = config.MAX_MOVE_SIZE
    lmax = cfg.max_group_size
    n_vars = vm.variables_count
    (k_move, k_group, k_count, k_sel, k_len, k_start, k_perm, k_res) = \
        jax.random.split(key, 8)

    u_move = jax.random.uniform(k_move, (), dtype=jnp.float64)
    move_type = jnp.sum(cfg.thresholds < u_move).astype(jnp.int32)

    g = jax.random.randint(k_group, (), 0, max(1, cfg.n_groups))
    length = vm.group_sizes[g].astype(jnp.int32)
    members_row = vm.group_members[g]  # [lmax] dynamic row slice (cheap)
    rate = cfg.group_rates[g]

    # Binomial(n_vars, rate) change count (`mover.rs:130-143`)
    c_raw = jnp.sum(
        jax.random.uniform(k_count, (n_vars,), dtype=jnp.float32)
        < rate.astype(jnp.float32)
    ).astype(jnp.int32)

    c_change = jnp.clip(jnp.maximum(c_raw, 1), 1, k_max)
    c_swap = jnp.clip(jnp.maximum(c_raw, 2), 2, k_max)
    c_edges = jnp.clip(jnp.maximum(c_raw, 2), 2,
                       jnp.maximum(jnp.minimum(length - 1, k_max), 2))
    k_scr = jax.random.randint(k_len, (), config.SCRAMBLE_MIN,
                               config.SCRAMBLE_MAX + 1)

    is_edges = move_type == 2
    sel_limit = jnp.where(is_edges, length - 1, length)
    tabu_mask = None
    if cfg.use_tabu and tabu_masks is not None:
        tabu_mask = selection.tabu_mask_row(tabu_masks, g)
    sel = selection.gumbel_topk_positions(k_sel, sel_limit, k_max, tabu_mask,
                                          lmax)
    # scramble window start: plain uniform draw (a full Gumbel top-k here
    # would double the selection cost; tabu avoidance for the window start
    # is a documented relaxation)
    start_limit = jnp.maximum(length - k_scr, 1)
    u_start = jax.random.uniform(k_start, (), dtype=jnp.float32)
    start = jnp.floor(u_start * start_limit).astype(jnp.int32)

    sel_vars = members_row[sel]  # [k_max] tiny lookup
    sel_next_vars = members_row[jnp.minimum(sel + 1, lmax - 1)]

    iota_v = jnp.arange(n_vars, dtype=jnp.int32)
    ii = jnp.arange(k_max, dtype=jnp.int32)
    v_oob = jnp.asarray(n_vars, jnp.int32)

    # Exactly one branch is active per candidate, so every branch scatters
    # into the same identity permutation with its targets masked by the
    # drawn move type — no [6, V] stack is ever materialized.
    noop0 = length < c_change
    noop1 = length < c_swap
    noop2 = length < 3
    noop3 = length <= k_scr
    a, b = sel[0], sel[1]
    noop45 = (length <= 1) | (a == b)

    p = iota_v
    # --- 1: swap — left-rotate values at selected vars (`mover.rs:179-216`)
    en1 = (move_type == 1) & ~noop1
    tgt1 = jnp.where(en1 & (ii < c_swap), sel_vars, v_oob)
    rot1 = sel_vars[(ii + 1) % jnp.maximum(c_swap, 1)]
    p = p.at[tgt1].set(rot1, mode="drop")
    # --- 2: swap_edges — exact sequential swap composition (`mover.rs:218-278`)
    en2 = (move_type == 2) & ~noop2
    for i in range(1, k_max):
        en = en2 & (i < c_edges)
        cm = jnp.maximum(c_edges, 1)
        prev_i = jnp.asarray(i, jnp.int32) % cm
        cur_i = jnp.asarray(i + 1, jnp.int32) % cm
        p = _mswap(p, sel_vars[prev_i], sel_vars[cur_i], en)
        p = _mswap(p, sel_next_vars[prev_i], sel_next_vars[cur_i], en)
    # --- 3: scramble — random permutation of window (`mover.rs:280-316`)
    en3 = (move_type == 3) & ~noop3
    w_vars = jax.lax.dynamic_slice(members_row, (start,),
                                   (config.SCRAMBLE_MAX,))
    perm = selection.random_permutation_positions(k_perm,
                                                  config.SCRAMBLE_MAX, k_scr)
    jj = jnp.arange(config.SCRAMBLE_MAX, dtype=jnp.int32)
    w_tgt = jnp.where(en3 & (jj < k_scr), w_vars, v_oob)
    p = p.at[w_tgt].set(w_vars[perm], mode="drop")
    # --- 4/5: subrange rotation / reversal (`mover.rs:318-421`) built from
    # roll/flip of the member row — no indexed gathers
    lo, hi = jnp.minimum(a, b), jnp.maximum(a, b)
    idxl = jnp.arange(lmax, dtype=jnp.int32)
    in_range = (idxl >= lo) & (idxl <= hi)
    m_lo = members_row[lo]
    m_hi = members_row[hi]
    shifted_l = jnp.roll(members_row, -1)
    shifted_r = jnp.roll(members_row, 1)
    src4 = jnp.where(a < b,
                     jnp.where(idxl == hi, m_lo, shifted_l),
                     jnp.where(idxl == lo, m_hi, shifted_r))
    # reversal: members_row[lo+hi-i] = roll(flip(members_row), lo+hi-(lmax-1))[i]
    rev_aligned = jnp.roll(jnp.flip(members_row), lo + hi - (lmax - 1))
    en45 = ((move_type == 4) | (move_type == 5)) & ~noop45
    tgt45 = jnp.where(en45 & in_range, members_row, v_oob)
    src45 = jnp.where(move_type == 4, src4, rev_aligned)
    p = p.at[tgt45].set(src45, mode="drop")

    new_candidate = apply_permutation(candidate, p)

    # change-move resampling: U[lb, ub) at the selected vars
    lo_b = vm.lower_bounds[sel_vars].astype(candidate.dtype)
    hi_b = vm.upper_bounds[sel_vars].astype(candidate.dtype)
    u = jax.random.uniform(k_res, (k_max,), dtype=candidate.dtype)
    rnd = lo_b + u * (hi_b - lo_b)
    rnd_tgt = jnp.where(
        (move_type == 0) & (ii < c_change) & ~noop0, sel_vars, v_oob
    )
    new_candidate = new_candidate.at[rnd_tgt].set(rnd, mode="drop")

    tabu_positions = jnp.where(move_type == 3, start * jnp.ones_like(sel), sel)
    tabu_count = jnp.where(
        move_type == 3, 1,
        jnp.stack([c_change, c_swap, c_edges, jnp.int32(1), jnp.int32(2),
                   jnp.int32(2)])[move_type],
    )
    info = {"group": g, "positions": tabu_positions, "count": tabu_count}
    return new_candidate, info


def do_move_delta(key, candidate, vm, cfg: MoverConfig, tabu_masks):
    """One randomly-drawn move in DELTA form: no [V] vector is materialized.

    Returns (delta, info) with delta = {"positions": i32[KD],
    "values": float[KD], "valid": bool[KD]} — the changed variables and
    their new values (KD = `cfg.delta_width`, statically derived from the
    enabled move set). This is the batched counterpart of the reference's
    incremental sampler, which returns per-neighbour (var_id, new_value)
    lists (`tabu_search_base.rs:107-137`, `mover.rs:145-421` incremental
    arms). Disabled move branches (probability 0) are pruned at trace time,
    so e.g. a change+swap config emits 2-wide deltas with no Binomial
    count draw and no scramble/window machinery at all.

    Move semantics match `do_move` with one documented divergence:
    insertion/inverse windows are capped at KD-1 (the second endpoint is
    drawn as a ±U{1..KD-1} offset from the first instead of an independent
    uniform id), keeping every move's changed set statically bounded.
    Duplicate positions (swap_edges overlaps) always carry equal values, so
    scatter application is well-defined.

    `tabu_masks`: bool[G, lmax] from `cfg.tabu_masks(tabu_state)` (shared
    by the whole neighbourhood) or None.
    """
    kd = cfg.delta_width
    ks = cfg.k_sel
    enabled = set(cfg.enabled)
    lmax = cfg.max_group_size
    n_vars = vm.variables_count
    (k_move, k_group, k_count, k_sel, k_len, k_start, k_perm, k_res) = \
        jax.random.split(key, 8)

    if len(cfg.enabled) == 1:
        move_type = jnp.asarray(cfg.enabled[0], jnp.int32)
    else:
        u_move = jax.random.uniform(k_move, (), dtype=jnp.float64)
        move_type = jnp.sum(cfg.thresholds < u_move).astype(jnp.int32)

    g = jax.random.randint(k_group, (), 0, max(1, cfg.n_groups))
    length = vm.group_sizes[g].astype(jnp.int32)

    if cfg.rates_zero:
        c_raw = jnp.zeros((), jnp.int32)
    else:
        rate = cfg.group_rates[g]
        c_raw = jnp.sum(
            jax.random.uniform(k_count, (n_vars,), dtype=jnp.float32)
            < rate.astype(jnp.float32)
        ).astype(jnp.int32)
    k_max = config.MAX_MOVE_SIZE
    c_change = jnp.clip(jnp.maximum(c_raw, 1), 1, min(k_max, kd))
    c_swap = jnp.clip(jnp.maximum(c_raw, 2), 2, min(k_max, kd))
    c_edges = jnp.clip(jnp.maximum(c_raw, 2), 2,
                       jnp.maximum(jnp.minimum(length - 1, ks), 2))

    is_edges = (move_type == 2) if 2 in enabled else False
    sel_limit = jnp.where(is_edges, length - 1, length)
    if ks == 2:
        # hot narrow configs: O(1) distinct-pair draw — no [group_len]-wide
        # Gumbel field or top-k per neighbour (see
        # `selection.sample_distinct_pair`)
        masks2 = tabu_masks if (cfg.use_tabu and tabu_masks is not None) \
            else None
        sel = selection.sample_distinct_pair(k_sel, sel_limit, masks2, g)
    else:
        tabu_mask = None
        if cfg.use_tabu and tabu_masks is not None:
            tabu_mask = selection.tabu_mask_row(tabu_masks, g)
        sel = selection.gumbel_topk_positions(k_sel, sel_limit, ks, tabu_mask,
                                              lmax)
    sel_vars = vm.group_members[g, sel]  # fused (g, sel) gather — no row

    if {3, 4, 5} & enabled:
        # padded member row for window slices: dynamic slices near the group
        # end stay aligned and rows shorter than the slice width still
        # trace; out-of-group slots repeat the last member and are always
        # masked by `valid`. Only windowed moves pay for the row.
        members_row = vm.group_members[g]
        mr_pad = jnp.concatenate(
            [members_row, jnp.broadcast_to(members_row[-1], (kd,))])

    jj = jnp.arange(kd, dtype=jnp.int32)

    def pad_to_kd(x, fill=0):
        if x.shape[0] >= kd:
            return x[:kd]
        return jnp.concatenate(
            [x, jnp.full((kd - x.shape[0],), fill, x.dtype)])

    # --- per-branch positions -------------------------------------------------
    positions = jnp.zeros((kd,), jnp.int32)
    if 0 in enabled or 1 in enabled:
        pad_sel = pad_to_kd(sel_vars)
        is01 = ((move_type == 0) | (move_type == 1)) \
            if len(cfg.enabled) > 1 else True
        positions = jnp.where(is01, pad_sel, positions)
    if 2 in enabled:
        sel_next_vars = vm.group_members[g, jnp.minimum(sel + 1, lmax - 1)]
        pos2 = pad_to_kd(jnp.concatenate([sel_vars, sel_next_vars]))
        positions = jnp.where(move_type == 2, pos2, positions)
    if 3 in enabled:
        k_scr = jax.random.randint(k_len, (), config.SCRAMBLE_MIN,
                                   config.SCRAMBLE_MAX + 1)
        start_limit = jnp.maximum(length - k_scr, 1)
        u_start = jax.random.uniform(k_start, (), dtype=jnp.float32)
        start = jnp.floor(u_start * start_limit).astype(jnp.int32)
        w_vars = jax.lax.dynamic_slice(mr_pad, (start,),
                                       (config.SCRAMBLE_MAX,))
        positions = jnp.where(move_type == 3, pad_to_kd(w_vars), positions)
    else:
        k_scr = jnp.zeros((), jnp.int32)
        start = jnp.zeros((), jnp.int32)
    if 4 in enabled or 5 in enabled:
        # capped insertion/inverse window: a = sel[0]; b = a +- U{1..KD-1}
        k_off, k_sign = jax.random.split(k_perm)
        a = sel[0]
        off = jax.random.randint(k_off, (), 1, kd)
        sign = jax.random.bernoulli(k_sign, 0.5)
        b = jnp.clip(jnp.where(sign, a + off, a - off), 0, length - 1)
        lo = jnp.minimum(a, b)
        r = jnp.abs(a - b)  # inclusive window [lo, lo + r], r <= kd - 1
        wm = jax.lax.dynamic_slice(mr_pad, (lo,), (kd,))
        is45 = (move_type == 4) | (move_type == 5)
        positions = jnp.where(is45, wm, positions)
    else:
        a = b = r = jnp.zeros((), jnp.int32)

    cand_at = candidate[positions]  # [KD] — the only O(KD) candidate gather

    noop0 = length < c_change
    noop1 = length < c_swap
    noop2 = length < 3
    noop3 = length <= k_scr
    noop45 = (length <= 1) | (r == 0)

    # --- per-branch new values over cand_at -----------------------------------
    bp = vm.bounds_pack[positions]      # one packed gather: (lb, ub, disc)
    lo_b = bp[..., 0].astype(candidate.dtype)
    hi_b = bp[..., 1].astype(candidate.dtype)
    disc = bp[..., 2] > 0.5

    branch_vals = []  # (move_idx, values[kd], valid[kd])
    if 0 in enabled:  # change: resample U[lb, ub)
        u = jax.random.uniform(k_res, (kd,), dtype=candidate.dtype)
        vals0 = lo_b + u * (hi_b - lo_b)
        branch_vals.append((0, vals0, (jj < c_change) & ~noop0))
    if 1 in enabled:  # swap: left-rotate the first c_swap values
        vals1 = cand_at[(jj + 1) % jnp.maximum(c_swap, 1)]
        branch_vals.append((1, vals1, (jj < c_swap) & ~noop1))
    if 2 in enabled:  # swap_edges: sequential swap-chain on the local view
        vals2 = cand_at
        for i in range(1, ks):
            en = i < c_edges
            cm = jnp.maximum(c_edges, 1)
            prev_i = jnp.asarray(i, jnp.int32) % cm
            cur_i = jnp.asarray(i + 1, jnp.int32) % cm
            for (xa, xb) in ((prev_i, cur_i), (prev_i + ks, cur_i + ks)):
                x = positions[xa]
                y = positions[xb]
                vx = vals2[jnp.argmax(positions == x)]
                vy = vals2[jnp.argmax(positions == y)]
                swap_to = jnp.where(positions == x, vy,
                                    jnp.where(positions == y, vx, vals2))
                vals2 = jnp.where(en, swap_to, vals2)
        valid2 = (jnp.where(jj < ks, jj, jj - ks) < c_edges) \
            & (jj < 2 * ks) & ~noop2
        branch_vals.append((2, vals2, valid2))
    if 3 in enabled:  # scramble: permute the first k_scr window values
        perm = selection.random_permutation_positions(
            jax.random.fold_in(k_perm, 1), config.SCRAMBLE_MAX, k_scr)
        perm_kd = jnp.concatenate(
            [perm, jnp.arange(config.SCRAMBLE_MAX, kd, dtype=jnp.int32)])
        vals3 = cand_at[perm_kd]
        branch_vals.append((3, vals3, (jj < k_scr) & ~noop3))
    if 4 in enabled:  # rotation of [0, r]: left when a < b, right when a > b
        src_left = jnp.where(jj == r, 0, jnp.minimum(jj + 1, kd - 1))
        src_right = jnp.where(jj == 0, r, jnp.maximum(jj - 1, 0))
        src4 = jnp.where(a < b, src_left, src_right)
        branch_vals.append((4, cand_at[src4], (jj <= r) & ~noop45))
    if 5 in enabled:  # reversal of [0, r]
        vals5 = cand_at[jnp.clip(r - jj, 0, kd - 1)]
        branch_vals.append((5, vals5, (jj <= r) & ~noop45))

    values, valid = branch_vals[-1][1], branch_vals[-1][2]
    for idx, vals, vld in reversed(branch_vals[:-1]):
        sel_this = move_type == idx
        values = jnp.where(sel_this, vals, values)
        valid = jnp.where(sel_this, vld, valid)

    # per-target fix: clamp + rint for discrete (`variables_manager.rs:187-201`)
    values = jnp.clip(values, lo_b, hi_b)
    values = jnp.where(disc, jnp.round(values), values)

    tabu_positions = jnp.where(move_type == 3, start * jnp.ones_like(sel), sel)
    tabu_count = jnp.where(
        move_type == 3, 1,
        jnp.stack([c_change, c_swap, c_edges, jnp.int32(1), jnp.int32(2),
                   jnp.int32(2)])[move_type],
    )
    info = {"group": g, "positions": tabu_positions, "count": tabu_count}
    delta = {"positions": positions, "values": values, "valid": valid}
    return delta, info


def _move_population_delta_narrow(key, base, n, vm, cfg, free):
    """Flat-batch sampler for the hot narrow configs (change/swap only,
    zero mutation-rate multiplier, 2-wide deltas): the whole neighbourhood
    draws from 3 batched PRNG calls and 3 small gathers, replacing
    per-neighbour key splitting (~10 threefry call sites) and the generic
    multi-branch machinery of `do_move_delta`. Slot choice is an EXACT
    uniform draw from the per-group tabu-free slot list (`cfg.tabu_free`,
    built once per step) — no per-neighbour mask lookups, no rejection.
    Move semantics otherwise match the reference (uniform move/group/pair/
    value choice); the PRNG stream differs — fine, the reference draws OS
    entropy anyway (`mover.rs:104`, SURVEY §5)."""
    free_list, free_count = free
    kd = cfg.delta_width
    ku, kg, kv = jax.random.split(key, 3)
    # f32 draws for move-type/slot choice (software-emulated f64 PRNG off
    # the hot path); only the replacement-value lerp draws in base dtype
    u = jax.random.uniform(ku, (n, 3), dtype=jnp.float32)
    uv = jax.random.uniform(kv, (n, kd), dtype=base.dtype)
    g = jax.random.randint(kg, (n,), 0, max(1, cfg.n_groups))
    fc = free_count[g]                                    # [n] tiny gather

    if len(cfg.enabled) == 1:
        move_type = jnp.full((n,), cfg.enabled[0], jnp.int32)
    else:
        move_type = jnp.sum(
            cfg.thresholds.astype(jnp.float32)[None, :] < u[:, :1],
            axis=1).astype(jnp.int32)

    # distinct free-slot pair in O(1): draw a uniformly over fc free slots,
    # b over the remaining fc-1 with a shift past a's index
    fc1 = jnp.maximum(fc, 1)
    a_idx = jnp.minimum(jnp.floor(u[:, 1] * fc1.astype(jnp.float32))
                        .astype(jnp.int32), fc1 - 1)
    fb = jnp.maximum(fc - 1, 1)
    b1 = jnp.minimum(jnp.floor(u[:, 2] * fb.astype(jnp.float32))
                     .astype(jnp.int32), fb - 1)
    b_idx = jnp.where(fc >= 2, b1 + (b1 >= a_idx).astype(jnp.int32), a_idx)
    sel = free_list[g[:, None], jnp.stack([a_idx, b_idx], axis=1)]  # [n, 2]

    # ONE packed (member, lo, hi, discrete) gather + the base-value gather
    sp = vm.slot_pack[g[:, None], sel]                    # [n, 2, 4] gather
    positions = sp[..., 0].astype(jnp.int32)
    cand_at = base[positions]                             # [n, 2] gather
    lo_b = sp[..., 1].astype(base.dtype)
    hi_b = sp[..., 2].astype(base.dtype)
    disc = sp[..., 3] > 0.5

    vals_change = lo_b + uv.astype(base.dtype) * (hi_b - lo_b)
    is_swap = (move_type == 1)[:, None]
    values = jnp.where(is_swap, cand_at[:, ::-1], vals_change)
    jj = jnp.arange(kd, dtype=jnp.int32)[None, :]
    # rates_zero: change touches exactly 1 var, swap exactly 2; a move
    # needs enough FREE slots (1 / 2) — exact tabu semantics
    valid = jnp.where(is_swap, fc[:, None] >= 2,
                      (jj < 1) & (fc[:, None] >= 1))
    values = jnp.clip(values, lo_b, hi_b)
    values = jnp.where(disc, jnp.round(values), values)

    info = {"group": g, "positions": sel,
            "count": jnp.where(move_type == 1, 2, 1).astype(jnp.int32)}
    return ({"positions": positions, "values": values, "valid": valid},
            info)


def move_population_delta(key, base, n_neighbours, vm, cfg: MoverConfig,
                          tabu_state, free=None):
    """n_neighbours independent delta moves off one base candidate f[V].

    Returns (delta, info) with leading [n_neighbours] axes — no [n, V]
    neighbour matrix is ever materialized. The tabu masks are built once
    and shared by the whole neighbourhood. `free` optionally supplies a
    precomputed `cfg.tabu_free` pair (the island runner's prestep hook
    builds it for all islands at once, outside the vmap).
    """
    if (cfg.rates_zero and set(cfg.enabled) <= {0, 1}
            and cfg.delta_width == 2 and cfg.k_sel == 2):
        if free is None:
            free = cfg.tabu_free(tabu_state)
        return _move_population_delta_narrow(key, base, n_neighbours, vm,
                                             cfg, free)
    masks = cfg.tabu_masks(tabu_state)
    keys = jax.random.split(key, n_neighbours)

    def one(k):
        return do_move_delta(k, base, vm, cfg, masks)

    return jax.vmap(one)(keys)


def dedupe_delta(delta):
    """Mask out later duplicates of the same position (swap_edges aliasing;
    duplicates always carry equal values, so dropping them is exact).
    Required before histogram-style delta math (`segments.nunique_delta`)
    so one changed variable contributes one event. O(K^2) masked compare."""
    pos = delta["positions"]
    k = pos.shape[0]
    idx = jnp.arange(k)
    eq = (pos[:, None] == pos[None, :]) & delta["valid"][:, None] \
        & delta["valid"][None, :]
    earlier_dup = jnp.any(eq & (idx[None, :] < idx[:, None]), axis=1)
    return {**delta, "valid": delta["valid"] & ~earlier_dup}


def apply_delta(base, delta):
    """Materialize one delta. iota-compare-select instead of a scatter:
    selects over f[V] are pure vector ops that XLA fuses with their
    neighbours, where a scatter is an op of its own. Later delta rows win on
    position collisions, matching `.at[].set` semantics.

    Width-dispatched: narrow deltas (the random-move paths, KD <= 8) unroll
    to KD chained selects; wide deltas (full-tour sweep winners, KD ~ N)
    use one [KD, V] match matrix + last-valid-row reduction — the unrolled
    form at KD ~ 1000 emits a 1000-op serial dependency chain that
    dominated both compile and step time (round-5 uncapped-2-opt lesson)."""
    iota = jnp.arange(base.shape[-1], dtype=jnp.int32)
    kd = delta["positions"].shape[0]
    if kd <= 8:
        out = base
        for k in range(kd):
            m = delta["valid"][k] & (iota == delta["positions"][k])
            out = jnp.where(m, delta["values"][k].astype(base.dtype), out)
        return out
    match = delta["valid"][:, None] & (delta["positions"][:, None]
                                       == iota[None, :])        # [KD, V]
    kidx = jnp.arange(kd, dtype=jnp.int32)
    last_k = jnp.max(jnp.where(match, kidx[:, None], -1), axis=0)  # [V]
    val = jnp.sum(
        jnp.where(kidx[:, None] == last_k[None, :],
                  delta["values"][:, None].astype(base.dtype), 0), axis=0)
    return jnp.where(last_k >= 0, val, base)


def take_one(tree, idx):
    """Extract row `idx` from every leaf's leading axis via a masked
    reduction (one vector pass per leaf) instead of dynamic-slice/gather
    ops — the winner-materialization hot path after argmin."""
    def sel(x):
        p = x.shape[0]
        m = jnp.arange(p, dtype=jnp.int32) == idx
        mm = m.reshape((p,) + (1,) * (x.ndim - 1))
        if x.dtype == jnp.bool_:
            return jnp.any(mm & x, axis=0)
        return jnp.sum(jnp.where(mm, x, jnp.zeros((), x.dtype)), axis=0,
                       dtype=x.dtype)
    return jax.tree.map(sel, tree)


def move_population(key, population, vm, cfg: MoverConfig, tabu_state):
    """Vmapped `do_move` over a population f32/f64[P, V].

    `vm`/`cfg` are static schema holders (closed over); `tabu_state` is a
    shared (unbatched) pytree whose masks are built once for the batch.
    """
    p = population.shape[0]
    keys = jax.random.split(key, p)
    masks = cfg.tabu_masks(tabu_state)

    def one(k, c, m):
        return do_move(k, c, vm, cfg, m)

    return jax.vmap(one, in_axes=(0, 0, None))(keys, population, masks)


def update_tabu_from_info(tabu_state, info, sample_idx, active=None):
    """Push one candidate's touched positions into the group ring.
    `active=False` freezes the ring exactly (count 0 writes nothing and
    leaves the cursor in place) — the self-gating step contract."""
    row = take_one({"group": info["group"], "positions": info["positions"],
                    "count": info["count"]}, sample_idx)
    count = row["count"]
    if active is not None:
        count = jnp.where(active, count, 0)
    return selection.tabu_push(tabu_state, row["group"], row["positions"],
                               count)
