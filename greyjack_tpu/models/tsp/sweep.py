"""Sweep-neighbourhood scorer for TSP: dense value sweeps over tour stops.

The TSP analog of `models/vrp/sweep.py` (see its docstring for the design
rationale), radically simpler because there are no time windows: every
candidate's score delta is EXACT closed-form leg arithmetic.

  * **change-sweep** — for T sampled tour positions, score assigning EVERY
    location id to the position: [T, Lc] tiles; distance delta =
    dm[prev, c] + dm[c, next] - in_leg - out_leg, duplicate-count delta
    from the value histogram.
  * **swap-sweep** — swap each target position's value with every other
    position's: [T, N]; the general 6-leg splice plus the standard
    adjacent-pair correction (the shared leg is replaced by its reverse).

dm rows ride one-hot matmuls (exact for milli values < 2^24 at HIGHEST
precision, never TF32); no scalar gathers anywhere on the candidate axis. The
winner materializes as a width-`cfg.kd` delta; its exact (d_hard, d_dist)
key comes straight from the sweep tiles — every family delta is exact
closed-form leg arithmetic, parity-pinned against full rescores
(reference semantics
`examples/tsp/src/score/incremental_score_calculator.rs:31-86`).
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

_STUB = np.int32(np.iinfo(np.int32).max)
# Default winner-delta width = the FULL tour (SweepConfig.kd): reversal /
# insertion spans are uncapped, so the sweep covers every classic 2-opt and
# or-opt move — long-range uncrossing moves decide quality at n >= 1000
# (round-5 race diagnosis: the span-32 cap lost the n=1000 leg to the
# reference's unrestricted swap_edges). Winner materialization is O(N)
# vector work per step against the O(T*N) sweep — noise.


def eligible(utils):
    """Static eligibility: f32-exact dm magnitudes for the one-hot matmuls
    and i32-safe tour-distance deltas."""
    if utils.get("dm_max_milli", 1 << 30) >= (1 << 24):
        return False
    if utils["n_locations"] >= (1 << 16):
        return False
    return True


class SweepConfig:
    """Host-compiled statics: variable ids (one per tour position), the
    single semantic group's slot maps, and the transposed milli matrix."""

    def __init__(self, requester, targets=None, window=None):
        if targets is None:  # explicit check — `or` would swallow 0
            targets = os.environ.get("GJ_SWEEP_TARGETS", 64)
        self.targets = int(targets)
        if self.targets <= 0:
            raise ValueError(f"sweep targets must be positive, got "
                             f"{self.targets}")
        schema0 = requester.planning_schema["path_stops"]
        # clamp to the tour length: the target sampler draws from at most
        # n_rows free slots (targets > n_rows crashed on small instances)
        self.targets = min(self.targets,
                           len(schema0["var_ids_np"]["locations_vec_id"]))
        self.window = 0 if window is None else int(window)  # unused: exact
        schema = requester.planning_schema["path_stops"]
        vm = requester.variables_manager
        self.var_ids = jnp.asarray(
            np.asarray(schema["var_ids_np"]["locations_vec_id"], np.int32))
        self.n_rows = int(self.var_ids.shape[0])
        self.float_dtype = vm.float_dtype
        self.g0 = 0  # single semantic group ("common")
        members = vm.group_members_np
        var_row = np.zeros(vm.variables_count, np.int32)
        var_row[np.asarray(schema["var_ids_np"]["locations_vec_id"])] = \
            np.arange(self.n_rows, dtype=np.int32)
        self.row_of_slot = jnp.asarray(var_row[members[self.g0]])
        # inverse map for tabu_push, which expects group SLOT indices —
        # -1 for rows with no slot (frozen/pinned stops are excluded from
        # semantic groups, `variables_manager.rs:94-101`); propose() drops
        # slotless partners from the push count (ADVICE r4)
        slot_of_row = np.full(self.n_rows, -1, np.int32)
        rs = var_row[members[self.g0]][: int(vm.group_sizes_np[self.g0])]
        slot_of_row[rs] = np.arange(len(rs), dtype=np.int32)
        self.slot_of_row = jnp.asarray(slot_of_row)
        self.group_lmax = vm.max_group_size
        self.slot_valid = jnp.asarray(
            np.arange(vm.max_group_size) < int(vm.group_sizes_np[self.g0]))
        utils = requester._delta_utils()
        self.dm = utils["distance_matrix_milli"].astype(jnp.int32)
        self.dmT = self.dm.T
        # winner-delta width: full tour by default (uncapped reversal /
        # insertion spans — see module note); window > 0 restores a cap
        self.kd = self.n_rows if self.window <= 0 else min(self.n_rows,
                                                           self.window)

    def conservative_moves_per_step(self, utils, tabu_rate):
        """Static LOWER bound on candidates per island-step (bench
        accounting without device reads): change-sweep minus the no-op,
        swap-sweep minus worst-case tabu/self/equal-value partners."""
        n = self.n_rows
        lc = utils["n_locations"] - 2       # values 1..L-1 minus the no-op
        tabu_cap = int(np.ceil(tabu_rate * n))
        return self.targets * (lc + max(0, n - 1 - tabu_cap))


def _onehot_rows(idx, l, mat):
    oh = (idx[..., None] == jnp.arange(l, dtype=jnp.int32)).astype(
        jnp.float32)
    return jnp.dot(oh, mat.astype(jnp.float32),
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)


def _permute_cols(mat_tl, idx_n, l):
    oh = (jnp.arange(l, dtype=jnp.int32)[:, None] == idx_n[None, :]).astype(
        jnp.float32)
    return jnp.dot(mat_tl.astype(jnp.float32), oh,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)


def score_candidates(ctx, t_rows, t_valid, row_tabu, cfg: SweepConfig,
                     utils, tables=None):
    """Exact delta arrays for both families: change [T, Lc] and swap
    [T, N] (hard = duplicate-count delta, dist = tour-milli delta)."""
    t = t_rows.shape[0]
    l = utils["n_locations"]
    lc = l - 1                              # legal values 1..L-1
    n = cfg.n_rows
    dm, dmt = cfg.dm, cfg.dmT
    dmf = utils["dm_flat_milli"]
    s = ctx["s"]
    counts = ctx["counts"]
    legs = ctx["legs"]                      # [N+1]

    # per-stop neighbour tables (depot 0 at both boundaries)
    p_vec = jnp.concatenate([jnp.zeros((1,), s.dtype), s[:-1]])   # [N]
    n_vec = jnp.concatenate([s[1:], jnp.zeros((1,), s.dtype)])
    iota_n = jnp.arange(n, dtype=jnp.int32)

    def pick(x):                            # [N] -> [T] at t_rows
        return jnp.sum(jnp.where(iota_n[None, :] == t_rows[:, None],
                                 x[None, :], 0), axis=1, dtype=x.dtype)

    t_c = pick(s)
    t_p = pick(p_vec)
    t_n = pick(n_vec)
    t_inleg = pick(legs[:-1])               # legs[t]
    t_outleg = pick(legs[1:])               # legs[t+1]

    row_p = _onehot_rows(t_p, l, dm)        # dm[prev, :]
    row_n = _onehot_rows(t_n, l, dmt)       # dm[:, next]
    row_s = _onehot_rows(t_c, l, dm)        # dm[c_t, :]
    row_sT = _onehot_rows(t_c, l, dmt)      # dm[:, c_t]

    # --- change-sweep [T, Lc]: values c = 1..L-1 ----------------------------
    cand = jnp.arange(1, l, dtype=jnp.int32)
    a_dist = row_p[:, 1:] + row_n[:, 1:] - (t_inleg + t_outleg)[:, None]
    dups_gone = (counts[t_c] == 1).astype(jnp.int32)
    appears_new = (counts[None, 1:] == 0).astype(jnp.int32)
    same = cand[None, :] == t_c[:, None]
    a_hard = jnp.where(same, 0, dups_gone[:, None] - appears_new)
    a_valid = t_valid[:, None] & ~same      # no-op candidate excluded

    # --- swap-sweep [T, N] --------------------------------------------------
    # general 6-leg splice; adjacent pairs replace the shared leg by its
    # reverse (standard 2-swap correction)
    g = (_permute_cols(row_p, s, l) + _permute_cols(row_n, s, l)
         + _permute_cols(row_sT, p_vec, l) + _permute_cols(row_s, n_vec, l)
         - (t_inleg + t_outleg)[:, None]
         - (legs[:-1] + legs[1:])[None, :])
    rev_in = dmf[t_c * l + t_p]             # dm[c_t, prev_t]
    rev_out = dmf[t_n * l + t_c]            # dm[next_t, c_t]
    is_next = t_rows[:, None] + 1 == iota_n[None, :]
    is_prev = t_rows[:, None] - 1 == iota_n[None, :]
    c_dist = (g
              + jnp.where(is_next, rev_out[:, None] + t_outleg[:, None], 0)
              + jnp.where(is_prev, rev_in[:, None] + t_inleg[:, None], 0))
    c_hard = jnp.zeros((t, n), jnp.int32)
    c_valid = (t_valid[:, None]
               & (iota_n[None, :] != t_rows[:, None])
               & (s[None, :] != t_c[:, None])     # equal-value swap = no-op
               & ~row_tabu[None, :])

    # --- 2-opt reversal sweep [T, N]: reverse positions [min(t,j),
    # max(t,j)] — the classic O(1)-delta 2-opt; interior legs are unchanged
    # only for SYMMETRIC matrices (this model always builds Euclidean ones,
    # `ops/distance.euclidean_matrix`). Span capped at cfg.kd-1 (default:
    # the full tour — uncapped).
    rps = _permute_cols(row_p, s, l)        # dm[p_t, c_j]
    rsn = _permute_cols(row_s, n_vec, l)    # dm[c_t, n_j]
    rstp = _permute_cols(row_sT, p_vec, l)  # dm[p_j, c_t]
    rns = _permute_cols(row_n, s, l)        # dm[c_j, n_t]
    legs_j = legs[:-1][None, :]
    legs_j1 = legs[1:][None, :]
    jgt = iota_n[None, :] > t_rows[:, None]
    r_dist = jnp.where(
        jgt, rps + rsn - t_inleg[:, None] - legs_j1,
        rstp + rns - legs_j - t_outleg[:, None])
    span_ok = jnp.abs(iota_n[None, :] - t_rows[:, None]) <= cfg.kd - 1
    r_valid = (t_valid[:, None] & (iota_n[None, :] != t_rows[:, None])
               & span_ok & ~row_tabu[None, :])
    r_hard = jnp.zeros((t, n), jnp.int32)

    # --- or-opt insertion sweep [T, N]: move the target's city to sit
    # right after position j (remove splice + insert splice; exact for
    # asymmetric matrices too). Span capped like the reversal.
    splice_t = dmf[t_p * l + t_n]           # dm[p_t, n_t]
    rss = _permute_cols(row_sT, s, l)       # dm[c_j, c_t]
    i_dist = ((splice_t - t_inleg - t_outleg)[:, None]
              + rss + rsn - legs_j1)
    i_valid = (t_valid[:, None]
               & (iota_n[None, :] != t_rows[:, None])
               & (iota_n[None, :] != t_rows[:, None] - 1)
               & span_ok & ~row_tabu[None, :])
    i_hard = jnp.zeros((t, n), jnp.int32)

    ones = jnp.ones((t, lc), bool)
    return {
        "a_hard": a_hard, "a_dist": a_dist, "a_valid": a_valid,
        "a_conv": ones,
        "c_hard": c_hard, "c_dist": c_dist, "c_valid": c_valid,
        "c_conv": jnp.ones((t, n), bool),
        "r_hard": r_hard, "r_dist": r_dist, "r_valid": r_valid,
        "i_hard": i_hard, "i_dist": i_dist, "i_valid": i_valid,
        "t_rows": t_rows, "t_c": t_c, "s": s,
    }


def propose(key, ctx, free, tabu_masks, cfg: SweepConfig, utils,
            tables=None):
    """Sweep proposal over four families (change / swap / 2-opt reversal /
    or-opt insertion): returns (winner_delta width cfg.kd, exact i32[2]
    (d_hard, d_dist_milli), tabu_info, stats). Same interface as the VRP
    module so the TabuSearch/LateAcceptance/SimulatedAnnealing sweep
    kernels are shared."""
    t = cfg.targets
    n = cfg.n_rows
    l = utils["n_locations"]
    lc = l - 1

    free_list, free_count = free
    fc = free_count[cfg.g0]
    lmax = cfg.group_lmax
    keys_rnd = jax.random.uniform(key, (lmax,), jnp.float32) \
        + jnp.where(jnp.arange(lmax) < fc, 0.0, 2.0)
    order = jnp.argsort(keys_rnd)[:t]
    t_valid = jnp.arange(t, dtype=jnp.int32) < fc
    t_rows = cfg.row_of_slot[free_list[cfg.g0][order]]

    if tabu_masks is None:
        row_tabu = jnp.zeros((n,), bool)
    else:
        row_tabu = jnp.zeros((n,), bool).at[cfg.row_of_slot].max(
            tabu_masks[cfg.g0] & cfg.slot_valid, mode="drop")

    sc = score_candidates(ctx, t_rows, t_valid, row_tabu, cfg, utils)

    def keyrow(hard, dist, val):
        k2 = jnp.stack([hard, dist], axis=-1)
        return jnp.where(val[..., None], k2, _STUB).reshape(-1, 2)

    keys_all = jnp.concatenate([
        keyrow(sc["a_hard"], sc["a_dist"], sc["a_valid"]),
        keyrow(sc["c_hard"], sc["c_dist"], sc["c_valid"]),
        keyrow(sc["r_hard"], sc["r_dist"], sc["r_valid"]),
        keyrow(sc["i_hard"], sc["i_dist"], sc["i_valid"]),
    ], axis=0)
    from greyjack_tpu.ops import lexico
    best = lexico.lex_argmin(keys_all)
    n_a = t * lc
    sizes = jnp.asarray([n_a, t * n, t * n, t * n], jnp.int32)
    offs = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(sizes)[:-1]])
    fam = jnp.sum((best >= offs).astype(jnp.int32)) - 1      # 0..3
    off = best - offs[fam]
    per = jnp.where(fam == 0, lc, n)
    ti = off // per
    vi = off % per

    def pick_t(x):
        return jnp.sum(jnp.where(jnp.arange(t) == ti, x, 0)).astype(x.dtype)

    s_tour = sc["s"]
    w_row = pick_t(sc["t_rows"])
    w_c_old = pick_t(sc["t_c"])
    j_c = jnp.sum(jnp.where(jnp.arange(n) == vi, s_tour, 0))

    # --- winner delta, width cfg.kd ----------------------------------------
    kidx = jnp.arange(cfg.kd, dtype=jnp.int32)
    a = jnp.minimum(w_row, vi)
    b = jnp.maximum(w_row, vi)
    span = b - a + 1

    # per-family value/validity at positions a + kidx
    def s_at(idx):
        return s_tour[jnp.clip(idx, 0, n - 1)]

    # fam 0 change: one var at w_row gets value 1+vi
    # fam 1 swap:   vars w_row/vi exchange values
    # fam 2 reversal: positions a..b get s[b - kidx]
    # fam 3 insertion after j: j > t changes [t..j] (rotate left:
    #   s[a+1+kidx], last slot gets s[a]); j < t changes [j+1..t] (rotate
    #   right: first slot gets s[t], then s[j+kidx])
    jgt = vi > w_row
    start = jnp.where((fam == 3) & ~jgt, a + 1, a)
    pos_var = cfg.var_ids[jnp.clip(start + kidx, 0, n - 1)]
    v_change = jnp.where(kidx == 0, 1 + vi, 0)
    pos_change = jnp.where(kidx == 0, cfg.var_ids[w_row], pos_var)
    v_swap = jnp.where(kidx == 0, j_c, w_c_old)
    pos_swap = jnp.where(
        kidx == 0, cfg.var_ids[w_row],
        cfg.var_ids[jnp.minimum(vi, n - 1)])
    v_rev = s_at(b - kidx)
    v_ins = jnp.where(
        jgt,
        jnp.where(kidx == span - 1, s_at(a), s_at(a + 1 + kidx)),
        jnp.where(kidx == 0, s_at(b), s_at(start + kidx - 1)))

    is01 = fam <= 1
    positions = jnp.where(is01,
                          jnp.where(kidx < 2,
                                    jnp.where(fam == 0, pos_change, pos_swap),
                                    pos_var),
                          pos_var).astype(jnp.int32)
    values = jnp.where(fam == 0, v_change,
                       jnp.where(fam == 1, v_swap,
                                 jnp.where(fam == 2, v_rev, v_ins)))
    any_valid = jnp.sum(jnp.where(jnp.arange(keys_all.shape[0]) == best,
                                  keys_all[:, 0], 0)) != _STUB
    nvalid = jnp.where(fam == 0, 1,
                       jnp.where(fam == 1, 2,
                                 jnp.where(fam == 2, span,
                                           jnp.where(jgt, span, span - 1))))
    valid = (kidx < nvalid) & any_valid
    delta = {
        "positions": positions,
        "values": values.astype(cfg.float_dtype),
        "valid": valid,
    }

    # winner's exact (d_hard, d_dist): taken straight from the sweep tiles
    # — every TSP family delta is exact closed-form leg arithmetic, pinned
    # bit-for-bit against full rescores by test_tsp_sweep_family_parity /
    # test_tsp_sweep_winner_decode_exact, so the former defence-in-depth
    # `_delta_parts` re-score here was pure per-step cost (a sort + ~6
    # fixed-cost gathers; removing it bought back much of the uncapped-span
    # step-time increase)
    exact = jnp.sum(
        jnp.where((jnp.arange(keys_all.shape[0]) == best)[:, None],
                  keys_all, 0), axis=0).astype(jnp.int32)
    exact = jnp.where(any_valid, exact, _STUB)

    # tabu_push expects group SLOT indices, not stop rows (they coincide
    # only while no stop is frozen) — map through slot_of_row and drop a
    # slotless (frozen) partner from the push count
    w_slot = cfg.slot_of_row[w_row]
    partner_slot = cfg.slot_of_row[jnp.minimum(vi, n - 1)]
    has_partner = (fam >= 1) & (partner_slot >= 0)
    info = {
        "group": jnp.asarray(cfg.g0, jnp.int32),
        "positions": jnp.stack([w_slot,
                                jnp.where(has_partner, partner_slot,
                                          w_slot)]).astype(jnp.int32),
        "count": jnp.where(has_partner, 2, 1).astype(jnp.int32),
    }
    n_scored = (jnp.sum(sc["a_valid"], dtype=jnp.int64)
                + jnp.sum(sc["c_valid"], dtype=jnp.int64)
                + jnp.sum(sc["r_valid"], dtype=jnp.int64)
                + jnp.sum(sc["i_valid"], dtype=jnp.int64))
    stats = {"n_scored": n_scored,
             "n_nonconv": jnp.zeros((), jnp.int64)}
    return delta, exact, info, stats


def exact_score_row(ctx, exact_ints, utils):
    """f64[2] score row of the winner from exact integer sums (for the
    LateAcceptance ring comparisons)."""
    from greyjack_tpu.ops import lexico
    hard = (ctx["hard"] + exact_ints[0]).astype(jnp.float64)
    soft = (ctx["soft_milli"] + exact_ints[1]).astype(jnp.float64) / 1000.0
    row = jnp.stack([hard, soft])
    return jnp.where(exact_ints[0] == _STUB, lexico.stub_score_row(2), row)
