"""Sweep-neighbourhood scorer for VRP: dense value-sweeps over sampled stops.

The per-move wall (DESIGN.md §5): scoring one random narrow move
materializes up to 4 full route rows per neighbour — mostly padding for
~25-stop routes — and pays one distance-matrix gather per move (the
int-delta chunk is 1.5x the sweep chunk on the H100 while scoring 155x
fewer candidates; PERF.md). Random (position, value) moves CANNOT
amortize those costs; value-structured neighbourhoods CAN. This module
redefines the TabuSearch neighbourhood as dense *sweeps*:

  * **change-sweep**  — for T sampled target stops, score replacing the
    stop's customer with EVERY legal customer id: a [T, Lc] tile.
  * **vehicle-sweep** — reassign each target stop to every vehicle: [T, K].
  * **swap-sweep**    — swap each target's customer with every other stop's
    (cross-route): [T, N].

Per step one island scores T*(Lc + K + N) ≈ 130k complete candidate moves
(vs 2-4k random ones) with *less* total work, because the expensive factors
are shared along the value axis:

  * distance deltas need only dm ROWS of the target's route neighbours —
    fetched with one-hot matmuls (exact: values < 2^24, HIGHEST precision,
    so no TF32 rounding on a GPU), never per-move scalar gathers;
  * lateness deltas come from per-position route cumulants: for a payload
    change at slot s, downstream completions are post'_m = P_m +
    max(u, W_m) where P = inclusive service cumsum, W_m = max of
    D_i = floor_i - P_i over (s, m], and u = (new completion at s) - P_s.
    Only the scalar u depends on the candidate value, so each candidate
    costs W hinge terms against shared window tables (the classic route-
    concatenation evaluation, cf. Vidal et al.; reference semantics
    `examples/vrp/src/score/incremental_score_calculator.rs:55-139`);
  * capacity / duplicate-count deltas are O(1) table lookups.

Exactness contract: hard (duplicates + overflow) and soft (distance) deltas
are EXACT for every candidate. Lateness deltas are exact whenever the
perturbation provably re-converges with the stored schedule within the
W-position window (`conv` flag; the vehicle-sweep evaluates full suffixes
and is always exact); non-converged candidates carry a valid OPTIMISTIC
lower bound, and the argmin winner is re-scored exactly (`_delta_parts`)
before the accept decision — so an accepted move's score is always exact
and a candidate can only ever be *under*-estimated, never unfairly skipped
in favour of a worse one whose bound was loose.

The winner materializes as a standard narrow delta (kd=2), so apply /
update_ctx / checkpoint / migration machinery is shared with the random-
move path unchanged.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

_BIG = 1 << 28          # -inf stand-in for i32 time math (times < 2^22)
_STUB = np.int32(np.iinfo(np.int32).max)


def _relu(x):
    return jnp.maximum(x, jnp.int32(0))


def eligible(utils):
    """Static eligibility: i32 accumulation, f32-exact dm magnitudes for the
    one-hot matmuls, and time bounds small enough that the (nrem+1)*shift
    lateness lower bound cannot overflow i32 (see `_suffix_window`)."""
    if utils["acc_dtype"] != jnp.int32:
        return False
    if utils.get("dm_max_milli", 1 << 30) >= (1 << 24):
        return False
    if utils.get("t_max", 0) >= (1 << 22):
        return False
    if utils["n_locations"] >= (1 << 16):
        return False
    return True


class SweepConfig:
    """Host-compiled static tables + knobs for the sweep step.

    Built once per kernel from the requester's schema: per-row variable ids,
    frozen masks, tabu-group slot maps, and the transposed milli distance
    matrix (built outside the island vmap so it is shared, not replicated).
    """

    def __init__(self, requester, targets=None, window=None):
        # explicit None checks: `targets or default` would silently replace
        # an explicit 0 with the env default instead of rejecting it
        if targets is None:
            targets = os.environ.get("GJ_SWEEP_TARGETS", 64)
        if window is None:
            window = os.environ.get("GJ_SWEEP_WINDOW", 16)
        self.targets = int(targets)
        self.window = int(window)
        if self.targets <= 0 or self.window <= 0:
            raise ValueError(
                f"sweep targets/window must be positive, got "
                f"targets={self.targets} window={self.window}")
        # clamp to the stop count: the target sampler draws from at most
        # n_rows free slots (targets > n_rows crashed on small instances)
        self.targets = min(
            self.targets,
            len(requester.planning_schema["planning_stops"]
                ["var_ids_np"]["customer_id"]))
        schema = requester.planning_schema["planning_stops"]
        vm = requester.variables_manager
        cust_vars = np.asarray(schema["var_ids_np"]["customer_id"], np.int32)
        veh_vars = np.asarray(schema["var_ids_np"]["vehicle_id"], np.int32)
        self.n_rows = len(cust_vars)
        frozen = vm.frozen_mask_np  # host copy — never read device arrays
        # at build time
        self.frozen_cust_np = frozen[cust_vars]
        self.frozen_veh_np = frozen[veh_vars]
        self.cust_var = jnp.asarray(cust_vars)
        self.veh_var = jnp.asarray(veh_vars)
        self.frozen_cust = jnp.asarray(self.frozen_cust_np)
        self.frozen_veh = jnp.asarray(self.frozen_veh_np)
        self.float_dtype = vm.float_dtype

        keys = vm.semantic_group_keys
        self.g_cust = keys.index("customer_assignment")
        self.g_veh = keys.index("vehicle_assignment")
        # group slot <-> stop row maps (group members exclude frozen vars)
        members = vm.group_members_np
        var_row = np.zeros(vm.variables_count, np.int32)
        var_row[cust_vars] = np.arange(self.n_rows, dtype=np.int32)
        var_row[veh_vars] = np.arange(self.n_rows, dtype=np.int32)
        self.row_of_cust_slot = jnp.asarray(var_row[members[self.g_cust]])
        slot_of_row_c = np.full(self.n_rows, -1, np.int32)
        cs = var_row[members[self.g_cust]][: vm.group_sizes_np[self.g_cust]]
        slot_of_row_c[cs] = np.arange(len(cs), dtype=np.int32)
        slot_of_row_v = np.full(self.n_rows, -1, np.int32)
        vs = var_row[members[self.g_veh]][: vm.group_sizes_np[self.g_veh]]
        slot_of_row_v[vs] = np.arange(len(vs), dtype=np.int32)
        self.slot_of_row_cust = jnp.asarray(slot_of_row_c)
        self.slot_of_row_veh = jnp.asarray(slot_of_row_v)
        self.cust_group_lmax = vm.max_group_size
        self.cust_slot_valid = jnp.asarray(
            np.arange(vm.max_group_size)
            < int(vm.group_sizes_np[self.g_cust]))

        utils = requester._delta_utils()
        self.dm = utils["distance_matrix_milli"].astype(jnp.int32)
        self.dmT = self.dm.T  # device-resident, shared across islands

    def conservative_moves_per_step(self, utils, tabu_rate):
        """Static LOWER bound on candidates scored per island-step — used by
        the bench so throughput accounting needs no device read inside the
        timed window. Counts
        the change-sweep exactly, the swap-sweep minus worst-case masked
        partners (frozen + tabu capacity + one full route), and the
        vehicle-sweep as zero."""
        n = self.n_rows
        lc = utils["n_stops"] - 1          # the no-op candidate is excluded
        frozen = int(self.frozen_cust_np.sum())
        tabu_cap = int(np.ceil(tabu_rate * max(1, n - frozen)))
        swap_lb = max(0, n - frozen - tabu_cap - utils["route_cap"] - 1)
        return self.targets * (lc + swap_lb)


# --------------------------------------------------------------------------
# per-step tables (from ctx, O(K*R) work)
# --------------------------------------------------------------------------

_NC_BASE = 20  # window columns start here in the stop table


def _shift_left(x, s, fill):
    if s == 0:
        return x
    pad = jnp.full(x.shape[:-1] + (s,), fill, x.dtype)
    return jnp.concatenate([x[..., s:], pad], axis=-1)


def _route_view(ctx, veh_sel):
    """[A, R] slices of the ctx route grids + [A]-shaped vehicle scalars for
    the selected vehicle ids (None = all K). Selection uses masked reduces,
    not gathers (they fuse with the consumers); ids
    out of range [0, K) yield all-sentinel rows that downstream scatters
    drop."""
    grids = ("r_stop", "r_ct", "r_floor", "r_ce", "r_c", "r_leg")
    if veh_sel is None:
        view = {g: ctx[g] for g in grids}
        view["vp"] = ctx["veh_pack"]
        view["len"] = ctx["len"].astype(jnp.int32)
        return view
    kk = ctx["r_stop"].shape[0]
    n = ctx["v"].shape[0]
    m = jnp.arange(kk, dtype=jnp.int32)[None, :] == veh_sel[:, None]  # [A, K]
    any_m = jnp.any(m, axis=1)

    def red(x):                                     # [K, ...] -> [A, ...]
        mm = m.reshape(m.shape + (1,) * (x.ndim - 1))
        return jnp.sum(jnp.where(mm, x[None], 0), axis=1, dtype=x.dtype)

    view = {g: red(ctx[g]) for g in grids}
    # unmatched selections must scatter nowhere: force sentinel stop ids
    view["r_stop"] = jnp.where(any_m[:, None], view["r_stop"], n)
    view["vp"] = red(ctx["veh_pack"])
    view["len"] = red(ctx["len"].astype(jnp.int32))
    return view


def _tables_core(view, cfg: SweepConfig, utils, n):
    """Cumulant arrays for the viewed routes: the packed per-stop grid rows
    [A*R, C] (C = 20 + 4W) plus the [A, R]/[A] route arrays the
    vehicle-sweep needs. Pure function of the view — `build_tables` runs it
    over all K routes, `patch_tables` over the <=2 routes an accepted move
    touched."""
    w = cfg.window
    kk, r = view["r_stop"].shape
    tw = bool(utils["time_windowed"])
    dm = cfg.dm

    valid = view["r_stop"] < n
    len_k = view["len"]
    iota_r = jnp.arange(r, dtype=jnp.int32)[None, :]
    w0 = view["vp"][:, 0:1]
    w1 = view["vp"][:, 1]
    ct = jnp.where(valid, view["r_ct"], 0)
    fl = jnp.where(valid, view["r_floor"], -_BIG)
    ce = view["r_ce"]
    p_arr = jnp.cumsum(ct, axis=1)
    d_arr = fl - p_arr
    if tw:
        m_arr = jax.lax.cummax(d_arr, axis=1)
        post = p_arr + jnp.maximum(w0, m_arr)
        late = jnp.where(valid, _relu(post - ce), 0)
        ot = jnp.where(len_k > 0, _relu(post[:, -1] - w1), 0)
    else:
        post = p_arr
        late = jnp.zeros_like(p_arr)
        ot = jnp.zeros((kk,), jnp.int32)
    e_arr = p_arr - ce

    # anchor grids [A, R]: value at a = state *entering* slot a
    pprev = jnp.concatenate([jnp.zeros((kk, 1), jnp.int32), p_arr[:, :-1]],
                            axis=1)
    postprev = jnp.concatenate([jnp.broadcast_to(w0, (kk, 1)),
                                post[:, :-1]], axis=1)

    depots = view["vp"][:, 7]
    c_g = view["r_c"]
    first_c = c_g[:, 0]
    last_onehot = iota_r == (len_k[:, None] - 1)
    last_c = jnp.sum(jnp.where(last_onehot, c_g, 0), axis=1)
    # ONE consolidated flat-dm gather for the 2A depot legs
    dmf = utils["dm_flat_milli"]
    l = utils["n_locations"]
    legs2 = dmf[jnp.concatenate([depots * l + first_c, last_c * l + depots])]
    startleg = jnp.where(len_k > 0, legs2[:kk], 0)
    endleg = jnp.where(len_k > 0, legs2[kk:], 0)

    # per-stop in/out legs incl depot boundary legs
    r_leg = view["r_leg"]
    inleg = jnp.where(iota_r == 0, startleg[:, None],
                      jnp.concatenate([jnp.zeros((kk, 1), jnp.int32),
                                       r_leg[:, :-1]], axis=1))
    outleg = jnp.where(iota_r == len_k[:, None] - 1, endleg[:, None], r_leg)
    prev_c = jnp.where(iota_r == 0, depots[:, None],
                       jnp.concatenate([jnp.zeros((kk, 1), jnp.int32),
                                        c_g[:, :-1]], axis=1))
    next_c = jnp.where(iota_r == len_k[:, None] - 1, depots[:, None],
                       jnp.concatenate([c_g[:, 1:],
                                        jnp.zeros((kk, 1), jnp.int32)],
                                       axis=1))

    # window tables anchored at a = slot+1: Wsh[., s, j] = max D[s+1..s+1+j]
    wsh, esh, lsh, psh = [], [], [], []
    run = jnp.full((kk, r), -_BIG, jnp.int32)
    for j in range(w):
        run = jnp.maximum(run, _shift_left(d_arr, j + 1, -_BIG))
        wsh.append(run)
        esh.append(_shift_left(e_arr, j + 1, 0))
        lsh.append(_shift_left(late, j + 1, 0))
        psh.append(_shift_left(p_arr, j + 1, 0))

    veh_col = jnp.broadcast_to(view.get("veh_ids",
                                        jnp.arange(kk, dtype=jnp.int32))
                               [:, None], (kk, r))
    cols = [
        veh_col,                                # v
        c_g,                                    # c
        jnp.broadcast_to(iota_r, (kk, r)),      # pos
        0 * c_g,                                # dem (filled by caller)
        ct, fl, ce,
        postprev, p_arr, late,
        post - p_arr,                           # u0 of suffix anchor slot+1
        inleg, outleg, prev_c, next_c,
        jnp.broadcast_to(len_k[:, None], (kk, r)),
        jnp.broadcast_to(w1[:, None], (kk, r)),
        jnp.broadcast_to(ot[:, None], (kk, r)),
        jnp.broadcast_to(view["vp"][:, 5:6], (kk, r)),   # load
        jnp.broadcast_to(view["vp"][:, 6:7], (kk, r)),   # cap
    ] + wsh + esh + lsh + psh
    grid = jnp.stack(cols, axis=-1).reshape(kk * r, len(cols))

    # vehicle-sweep insertion grids [A, R]: value at insertion rank a
    gapleg = jnp.where(
        iota_r == 0,
        startleg[:, None],
        jnp.where(iota_r < len_k[:, None], inleg,
                  jnp.where(iota_r == len_k[:, None], endleg[:, None], 0)))
    pcand = jnp.where(iota_r == 0, depots[:, None], prev_c)
    # at a == len the slot holds no stop: next after insertion is the depot
    ncand = jnp.where(iota_r < len_k[:, None], c_g, depots[:, None])

    route = {"d": d_arr, "e": e_arr, "late": late, "p": p_arr,
             "valid": valid, "len": len_k, "w1": w1, "ot": ot,
             "pprev": pprev, "postprev": postprev,
             "gapleg": gapleg, "pcand": pcand, "ncand": ncand,
             "depots": depots}
    return grid, route


def build_tables(ctx, cfg: SweepConfig, utils):
    """Per-position route cumulants, packed as one stop-indexed table
    S[N, 20+4W] (scatter by r_stop — one cheap scatter, no gathers) plus
    [K, R] insertion-anchor grids for the vehicle-sweep."""
    n = ctx["v"].shape[0]
    view = _route_view(ctx, None)
    grid, route = _tables_core(view, cfg, utils, n)
    stop_tbl = jnp.zeros((n, grid.shape[1]), jnp.int32).at[
        ctx["r_stop"].reshape(-1)].set(grid, mode="drop")
    # dem column from cust_packed (constant per customer, not per slot)
    stop_tbl = stop_tbl.at[:, 3].set(utils["cust_packed"][ctx["c"], 0])
    return stop_tbl, route


def patch_tables(tables, ctx, av2, cfg: SweepConfig, utils):
    """Incrementally update (stop_tbl, route) after `update_ctx`: only the
    <=2 routes in `av2` (i32[2] vehicle ids; out-of-range = no-op slot)
    are recomputed and merged — bit-identical to `build_tables(ctx)` (the
    tables are a pure function of the ctx; tests/test_sweep.py pins the
    invariant). The full rebuild profiled at 2.6ms of the 7ms flagship
    step (PROF_SWEEP_r04.json); the patch is ~60x less table work.

    NOT wired into the agent kernels: carrying (stop_tbl, route) through
    the island-vmapped scan state and patching per step MEASURED SLOWER
    than the per-step full rebuild (commit b782048 — the state-carried
    tables break XLA's scan-carry aliasing and the where-merges cost more
    than the rebuild they save). Kept, with the invariant test, as the
    building block for a future non-vmapped single-island mode where the
    ~60x table-work saving does materialize."""
    stop_tbl, route = tables
    n = ctx["v"].shape[0]
    kk = ctx["r_stop"].shape[0]
    view = _route_view(ctx, av2)
    view["veh_ids"] = av2
    grid, rr = _tables_core(view, cfg, utils, n)

    iota_k = jnp.arange(kk, dtype=jnp.int32)
    route = dict(route)
    for name, old in route.items():
        val = rr[name]
        for i in range(av2.shape[0]):
            m = iota_k == av2[i]
            mm = m.reshape(m.shape + (1,) * (old.ndim - 1))
            old = jnp.where(mm, val[i][None] if old.ndim > 1
                            else val[i], old)
        route[name] = old

    stop_tbl = stop_tbl.at[view["r_stop"].reshape(-1)].set(grid, mode="drop")
    stop_tbl = stop_tbl.at[:, 3].set(utils["cust_packed"][ctx["c"], 0])
    return stop_tbl, route


def _onehot_rows(idx, l, mat):
    """mat rows selected by idx via one-hot matmul — exact for i32
    payloads < 2^24 (HIGHEST precision keeps f32 inputs unrounded; a
    default-precision f32 matmul may run in TF32 on a GPU and round them).
    A plain row gather is the alternative (ROADMAP Speed item 6)."""
    oh = (idx[..., None] == jnp.arange(l, dtype=jnp.int32)).astype(
        jnp.float32)
    return jnp.dot(oh, mat.astype(jnp.float32),
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)


def _permute_cols(mat_tl, idx_n, l):
    """[T, L] -> [T, N] column permutation by a shared index vector, as a
    matmul against a one-hot [L, N] (same exactness argument)."""
    oh = (jnp.arange(l, dtype=jnp.int32)[:, None] == idx_n[None, :]).astype(
        jnp.float32)
    return jnp.dot(mat_tl.astype(jnp.float32), oh,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)


def _suffix_window(trow, u, tw, w):
    """Windowed suffix lateness delta for a payload change at the anchor's
    slot: d = sum_j hinge(max(u, W_j) + e_j) - late_j over the W downstream
    positions, plus the in-window overtime delta. Returns (lower bound,
    conv) — exact when `conv` (window covers the suffix or the schedule
    provably re-converges at the window edge).

    trow: anchor data broadcastable against u — dict with a_true (slot+1),
    len_r, u0, w1, ot and window rows w2/e2/l2/p2 each [..., W].
    """
    if not tw:
        z = jnp.zeros(jnp.broadcast_shapes(u.shape, trow["a"].shape),
                      jnp.int32)
        return z, z == 0
    a = trow["a"]
    ln = trow["len"]
    d = jnp.zeros(jnp.broadcast_shapes(u.shape, a.shape), jnp.int32)
    for j in range(w):
        vw = (a + j) < ln
        m = jnp.maximum(u, trow["w2"][..., j])
        d = d + jnp.where(vw, _relu(m + trow["e2"][..., j])
                          - trow["l2"][..., j], 0)
        endw = vw & ((a + j) == ln - 1)
        d = d + jnp.where(endw, _relu(m + trow["p2"][..., j] - trow["w1"])
                          - trow["ot"], 0)
    covered = (ln - a) <= w
    wl = trow["w2"][..., w - 1]
    conv = covered | (jnp.maximum(u, wl) == jnp.maximum(trow["u0"], wl))
    # optimistic remainder: each beyond-window term (and the overtime) can
    # drop by at most the backward shift u0-u; i32-safe by the t_max < 2^22
    # eligibility gate (nrem+1 <= R+1, shift < 2^22)
    nrem = _relu(ln - a - w)
    d = d - jnp.where(conv, 0, (nrem + 1) * _relu(trow["u0"] - u))
    return d, conv


def _target_window(stbl_rows):
    """Anchor-data dict from gathered stop-table rows [..., C]."""
    w = (stbl_rows.shape[-1] - _NC_BASE) // 4
    return {
        "a": stbl_rows[..., 2] + 1,
        "len": stbl_rows[..., 15],
        "u0": stbl_rows[..., 10],
        "w1": stbl_rows[..., 16],
        "ot": stbl_rows[..., 17],
        "w2": stbl_rows[..., _NC_BASE:_NC_BASE + w],
        "e2": stbl_rows[..., _NC_BASE + w:_NC_BASE + 2 * w],
        "l2": stbl_rows[..., _NC_BASE + 2 * w:_NC_BASE + 3 * w],
        "p2": stbl_rows[..., _NC_BASE + 3 * w:_NC_BASE + 4 * w],
    }


# --------------------------------------------------------------------------
# candidate scoring (separated from target sampling for parity tests)
# --------------------------------------------------------------------------

def score_candidates(ctx, t_rows, t_valid, row_tabu, cfg: SweepConfig,
                     utils, tables=None):
    """Score every sweep candidate for the given target rows.

    Returns a dict of per-family i32 delta arrays (hard/late/dist), validity
    and lateness-exactness (`conv`) masks, plus the per-target scalars the
    winner decode needs. `late` entries are exact where `conv`, else a valid
    optimistic lower bound (see module docstring)."""
    t = t_rows.shape[0]
    w = cfg.window
    n = cfg.n_rows
    l = utils["n_locations"]
    nd = l - utils["n_stops"]
    lc = utils["n_stops"]
    kk = utils["k_vehicles"]
    r = utils["route_cap"]
    tw = bool(utils["time_windowed"])
    dm, dmt = cfg.dm, cfg.dmT

    if tables is None:
        tables = build_tables(ctx, cfg, utils)
    stbl, route = tables

    trow = stbl[t_rows]                                         # [T, C]
    t_v = trow[:, 0]
    t_c = trow[:, 1]
    t_pos = trow[:, 2]
    t_dem = trow[:, 3]
    t_ct, t_fl, t_ce = trow[:, 4], trow[:, 5], trow[:, 6]
    t_postprev, t_p = trow[:, 7], trow[:, 8]
    t_late = trow[:, 9]
    t_inleg, t_outleg = trow[:, 11], trow[:, 12]
    t_prev, t_next = trow[:, 13], trow[:, 14]
    t_len = trow[:, 15]
    t_w1, t_ot = trow[:, 16], trow[:, 17]
    t_load, t_cap = trow[:, 18], trow[:, 19]
    twin = _target_window(trow)
    is_last = t_pos == t_len - 1

    # dm rows for the target's neighbourhood (4 one-hot matmuls)
    row_prev = _onehot_rows(t_prev, l, dm)                      # dm[prev, :]
    row_next = _onehot_rows(t_next, l, dmt)                     # dm[:, next]
    row_self = _onehot_rows(t_c, l, dm)                         # dm[c, :]
    row_selfT = _onehot_rows(t_c, l, dmt)                       # dm[:, c]
    iota_l = jnp.arange(l, dtype=jnp.int32)
    splice = jnp.sum(jnp.where(iota_l[None, :] == t_next[:, None],
                               row_prev, 0), axis=1)            # dm[prev,next]

    cust = utils["cust_packed"]                                 # [L, 4]
    counts = ctx["counts"]
    dups_gone = (counts[t_c] == 1).astype(jnp.int32)            # [T]

    def twin_bc(axis):
        # broadcast target window rows against a trailing candidate axis
        if axis == 1:
            return {k2: v[:, None] if v.ndim == 1 else v[:, None, :]
                    for k2, v in twin.items()}
        raise ValueError(axis)

    # =================== family A: change-sweep [T, Lc] =====================
    cand = jnp.arange(nd, l, dtype=jnp.int32)                   # [Lc]
    c_dem = cust[nd:, 0][None, :]
    c_ct = cust[nd:, 3][None, :]
    c_fl = (cust[nd:, 1] + cust[nd:, 3])[None, :]
    c_ce = cust[nd:, 2][None, :]

    a_dist = (row_prev[:, nd:] + row_next[:, nd:]
              - (t_inleg + t_outleg)[:, None])
    a_over = (_relu(t_load[:, None] - t_dem[:, None] + c_dem - t_cap[:, None])
              - _relu(t_load - t_cap)[:, None])
    same = cand[None, :] == t_c[:, None]
    # d_dups = dups' - dups = uniq - uniq': removing the old customer loses
    # a unique iff its count was 1; adding the candidate gains one iff its
    # count was 0 (`segments.nunique_delta` semantics, single-row case)
    appears_new = (counts[None, nd:] == 0).astype(jnp.int32)
    a_dups = jnp.where(same, 0, dups_gone[:, None] - appears_new)
    if tw:
        post_new = jnp.maximum(t_postprev[:, None] + c_ct, c_fl)
        u_a = post_new - t_p[:, None]
        d_at = _relu(post_new - c_ce) - t_late[:, None]
        sfx, conv_a = _suffix_window(twin_bc(1), u_a, tw, w)
        d_end = jnp.where(is_last[:, None],
                          _relu(post_new - t_w1[:, None]) - t_ot[:, None], 0)
        a_late = d_at + sfx + d_end
    else:
        a_late = jnp.zeros((t, lc), jnp.int32)
        conv_a = jnp.ones((t, lc), bool)
    a_hard = 1000 * a_dups + a_over
    # exclude the no-op candidate (c == current customer): it ties every
    # real sideways move at exactly 0 and wins by index order, freezing the
    # search at local optima — with it excluded, 0-delta REAL moves walk
    # plateaus and strictly-worse sweeps are honestly rejected (measured in
    # the r4 quality race: the no-op-winner stagnation lost the non-tw
    # n=1000 race leg by 1.9%)
    a_valid = t_valid[:, None] & ~same

    # =================== family B: vehicle-sweep [T, K] =====================
    # removal side (exact, [T, R] suffix grid on the target's route)
    rt_d = route["d"][t_v]
    rt_e = route["e"][t_v]
    rt_late = route["late"][t_v]
    rt_p = route["p"][t_v]
    iota_rr = jnp.arange(r, dtype=jnp.int32)[None, :]
    u_rem = t_postprev - t_p
    if tw:
        m_sfx = iota_rr > t_pos[:, None]
        w_rem = jax.lax.cummax(jnp.where(m_sfx, rt_d, -_BIG), axis=1)
        vv = m_sfx & (iota_rr < t_len[:, None])
        mterm = jnp.maximum(u_rem[:, None], w_rem)
        d_sfx = jnp.sum(jnp.where(vv, _relu(mterm + rt_e) - rt_late, 0),
                        axis=1)
        endm = vv & (iota_rr == t_len[:, None] - 1)
        d_ot = jnp.sum(jnp.where(endm, _relu(mterm + rt_p - t_w1[:, None])
                                 - t_ot[:, None], 0), axis=1)
        rem_late = (-t_late + d_sfx + d_ot
                    + jnp.where(is_last,
                                _relu(t_postprev - t_w1) - t_ot, 0))  # [T]
    else:
        rem_late = jnp.zeros((t,), jnp.int32)
    rem_dist = splice - t_inleg - t_outleg
    rem_over = _relu(t_load - t_dem - t_cap) - _relu(t_load - t_cap)

    # insertion side: rank by stop-id order (matches the sorted merge of
    # `_delta_parts_sorted`), exact full-suffix evaluation on [T, K, R]
    rstop = ctx["r_stop"]
    rho = jnp.sum((rstop[None, :, :] < t_rows[:, None, None]).astype(
        jnp.int32), axis=2)                                     # [T, K]
    iota_r3 = jnp.arange(r, dtype=jnp.int32)[None, None, :]
    at_rho = iota_r3 == rho[:, :, None]

    def _at_rho(g):
        return jnp.sum(jnp.where(at_rho, g[None, :, :], 0), axis=2)

    i_pprev = _at_rho(route["pprev"])
    i_postprev = _at_rho(route["postprev"])
    i_gapleg = _at_rho(route["gapleg"])
    i_pc = _at_rho(route["pcand"])
    i_nc = _at_rho(route["ncand"])
    # append rank (rho == len) reads the grids' a == len cells, which carry
    # the correct entering-end values; len == R routes are masked invalid
    if tw:
        post_new_b = jnp.maximum(i_postprev + t_ct[:, None], t_fl[:, None])
        u_ins = post_new_b - i_pprev
        m_ins = iota_r3 >= rho[:, :, None]
        w_ins = jax.lax.cummax(
            jnp.where(m_ins, route["d"][None, :, :], -_BIG), axis=2)
        vv_b = m_ins & (iota_r3 < route["len"][None, :, None])
        mterm_b = jnp.maximum(u_ins[:, :, None], w_ins)
        d_sfx_b = jnp.sum(
            jnp.where(vv_b, _relu(mterm_b + route["e"][None])
                      - route["late"][None], 0), axis=2)
        endm_b = vv_b & (iota_r3 == route["len"][None, :, None] - 1)
        d_ot_b = jnp.sum(
            jnp.where(endm_b,
                      _relu(mterm_b + route["p"][None]
                            - route["w1"][None, :, None])
                      - route["ot"][None, :, None], 0), axis=2)
        append = rho == route["len"][None, :]
        ins_late = (_relu(post_new_b - t_ce[:, None]) + d_sfx_b + d_ot_b
                    + jnp.where(append,
                                _relu(post_new_b - route["w1"][None, :])
                                - route["ot"][None, :], 0))
    else:
        ins_late = jnp.zeros((t, kk), jnp.int32)
    # legs dm[pc, c_t] + dm[c_t, nc] via the target's own dm rows
    leg_in_b = jnp.sum(jnp.where(iota_l[None, None, :] == i_pc[:, :, None],
                                 row_selfT[:, None, :], 0), axis=2)
    leg_out_b = jnp.sum(jnp.where(iota_l[None, None, :] == i_nc[:, :, None],
                                  row_self[:, None, :], 0), axis=2)
    ins_dist = leg_in_b + leg_out_b - i_gapleg
    loads = ctx["veh_pack"][:, 5][None, :]
    caps = ctx["veh_pack"][:, 6][None, :]
    ins_over = _relu(loads + t_dem[:, None] - caps) - _relu(loads - caps)

    b_hard = rem_over[:, None] + ins_over
    b_late = rem_late[:, None] + ins_late
    b_dist = rem_dist[:, None] + ins_dist
    b_valid = (t_valid[:, None]
               & (jnp.arange(kk, dtype=jnp.int32)[None, :] != t_v[:, None])
               & (route["len"][None, :] < r)
               & ~cfg.frozen_veh[t_rows][:, None])
    conv_b = jnp.ones((t, kk), bool)

    # =================== family C: swap-sweep [T, N] ========================
    s_c = ctx["c"]                                              # [N]
    s_v = stbl[:, 0]
    s_ct, s_fl, s_ce = stbl[:, 4], stbl[:, 5], stbl[:, 6]
    s_dem = stbl[:, 3]
    s_postprev, s_p = stbl[:, 7], stbl[:, 8]
    s_late = stbl[:, 9]
    s_inleg, s_outleg = stbl[:, 11], stbl[:, 12]
    s_prev, s_next = stbl[:, 13], stbl[:, 14]
    s_len, s_pos = stbl[:, 15], stbl[:, 2]
    s_w1, s_ot = stbl[:, 16], stbl[:, 17]
    swin = _target_window(stbl)                                 # [N, ...]

    if tw:
        # side 1: target's slot gets stop j's customer
        post1 = jnp.maximum(t_postprev[:, None] + s_ct[None, :],
                            s_fl[None, :])
        u1 = post1 - t_p[:, None]
        d_at1 = _relu(post1 - s_ce[None, :]) - t_late[:, None]
        sfx1, conv1 = _suffix_window(twin_bc(1), u1, tw, w)
        d_end1 = jnp.where(is_last[:, None],
                           _relu(post1 - t_w1[:, None]) - t_ot[:, None], 0)
        # side 2: stop j's slot gets the target's customer
        post2 = jnp.maximum(s_postprev[None, :] + t_ct[:, None],
                            t_fl[:, None])
        u2 = post2 - s_p[None, :]
        d_at2 = _relu(post2 - t_ce[:, None]) - s_late[None, :]
        sfx2, conv2 = _suffix_window(
            {k2: v[None, :] if v.ndim == 1 else v[None, :, :]
             for k2, v in swin.items()}, u2, tw, w)
        d_end2 = jnp.where((s_pos == s_len - 1)[None, :],
                           _relu(post2 - s_w1[None, :]) - s_ot[None, :], 0)
        c_late = (d_at1 + sfx1 + d_end1) + (d_at2 + sfx2 + d_end2)
        conv_c = conv1 & conv2
    else:
        c_late = jnp.zeros((t, n), jnp.int32)
        conv_c = jnp.ones((t, n), bool)

    # distances: 4 permuted dm-row tensors (shared one-hot [L, N] operands)
    d1 = _permute_cols(row_prev, s_c, l) + _permute_cols(row_next, s_c, l) \
        - (t_inleg + t_outleg)[:, None]
    d2 = _permute_cols(row_selfT, s_prev, l) \
        + _permute_cols(row_self, s_next, l) \
        - (s_inleg + s_outleg)[None, :]
    c_dist = d1 + d2
    c_over = (_relu(t_load[:, None] - t_dem[:, None] + s_dem[None, :]
                    - t_cap[:, None]) - _relu(t_load - t_cap)[:, None]
              + _relu(stbl[:, 18][None, :] - s_dem[None, :] + t_dem[:, None]
                      - stbl[:, 19][None, :])
              - _relu(stbl[:, 18] - stbl[:, 19])[None, :])
    c_valid = (t_valid[:, None]
               & (s_v[None, :] != t_v[:, None])
               & (s_c[None, :] != t_c[:, None])  # equal-value swap = no-op
               & ~cfg.frozen_cust[None, :]
               & ~row_tabu[None, :])
    c_hard = c_over

    return {
        "a_hard": a_hard, "a_late": a_late, "a_dist": a_dist,
        "a_valid": a_valid, "a_conv": conv_a,
        "b_hard": b_hard, "b_late": b_late, "b_dist": b_dist,
        "b_valid": b_valid, "b_conv": conv_b,
        "c_hard": c_hard, "c_late": c_late, "c_dist": c_dist,
        "c_valid": c_valid, "c_conv": conv_c,
        "t_rows": t_rows, "t_c": t_c, "s_c": s_c,
    }


# --------------------------------------------------------------------------
# the sweep proposal
# --------------------------------------------------------------------------

def propose(key, ctx, free, tabu_masks, cfg: SweepConfig, utils,
            tables=None):
    """Score all sweep candidates against `ctx`, pick the lexicographic
    winner, re-score it exactly, and return
    (winner_delta, exact_int_row[3], tabu_info, stats).

    The winner delta is a standard narrow (kd=2) delta consumable by
    `moves.apply_delta` / `update_ctx`; `exact_int_row` is INT32_MAX-stubbed
    when no valid candidate exists (accept-if-<=0 then rejects)."""
    t = cfg.targets
    n = cfg.n_rows
    l = utils["n_locations"]
    nd = l - utils["n_stops"]
    lc = utils["n_stops"]
    kk = utils["k_vehicles"]

    # --- targets: T distinct tabu-free customer-group rows -------------------
    free_list, free_count = free
    fc = free_count[cfg.g_cust]
    lmax = cfg.cust_group_lmax
    keys_rnd = jax.random.uniform(key, (lmax,), jnp.float32) \
        + jnp.where(jnp.arange(lmax) < fc, 0.0, 2.0)
    order = jnp.argsort(keys_rnd)[:t]
    t_valid = (jnp.arange(t, dtype=jnp.int32) < fc) & ~ctx["base_over"]
    t_slots = free_list[cfg.g_cust][order]
    t_rows = cfg.row_of_cust_slot[t_slots]                      # [T]

    # partner tabu mask by row: `.max` (OR) scatter — the member table's pad
    # slots alias row 0 with False and must not erase a real True write
    if tabu_masks is None:
        row_tabu = jnp.zeros((n,), bool)
    else:
        row_tabu = jnp.zeros((n,), bool).at[cfg.row_of_cust_slot].max(
            tabu_masks[cfg.g_cust] & cfg.cust_slot_valid, mode="drop")

    sc = score_candidates(ctx, t_rows, t_valid, row_tabu, cfg, utils,
                          tables)

    # =================== combine + winner ===================================
    def keyrow(hard, late, dist, val):
        k3 = jnp.stack([hard, late, dist], axis=-1)
        return jnp.where(val[..., None], k3, _STUB).reshape(-1, 3)

    keys_all = jnp.concatenate([
        keyrow(sc["a_hard"], sc["a_late"], sc["a_dist"], sc["a_valid"]),
        keyrow(sc["b_hard"], sc["b_late"], sc["b_dist"], sc["b_valid"]),
        keyrow(sc["c_hard"], sc["c_late"], sc["c_dist"], sc["c_valid"]),
    ], axis=0)
    from greyjack_tpu.ops import lexico
    best = lexico.lex_argmin(keys_all)
    n_a, n_b = t * lc, t * kk
    fam = jnp.where(best < n_a, 0, jnp.where(best < n_a + n_b, 1, 2))
    off = best - jnp.where(fam == 0, 0, jnp.where(fam == 1, n_a, n_a + n_b))
    per = jnp.where(fam == 0, lc, jnp.where(fam == 1, kk, n))
    ti = off // per
    vi = off % per                      # candidate index within the family

    def pick_t(x):                      # [T] -> scalar at ti
        return jnp.sum(jnp.where(jnp.arange(t) == ti, x, 0)).astype(x.dtype)

    w_row = pick_t(sc["t_rows"])
    w_c_old = pick_t(sc["t_c"])
    j_c = jnp.sum(jnp.where(jnp.arange(n) == vi, sc["s_c"], 0))  # fam C
    val1 = jnp.where(fam == 0, nd + vi,
                     jnp.where(fam == 1, vi, j_c)).astype(jnp.int32)
    pos1 = jnp.where(fam == 1, cfg.veh_var[w_row], cfg.cust_var[w_row])
    pos2 = jnp.where(fam == 2, cfg.cust_var[jnp.minimum(vi, n - 1)], pos1)
    # masked-reduce winner-key read (take_one pattern — no dynamic gather)
    any_valid = jnp.sum(jnp.where(jnp.arange(keys_all.shape[0]) == best,
                                  keys_all[:, 0], 0)) != _STUB

    delta = {
        "positions": jnp.stack([pos1, pos2]).astype(jnp.int32),
        "values": jnp.stack([val1, w_c_old]).astype(cfg.float_dtype),
        "valid": jnp.stack([any_valid, (fam == 2) & any_valid]),
    }

    # exact re-score of the single winner (the narrow XLA path) — the accept
    # decision never trusts a windowed bound
    from greyjack_tpu.models.vrp import cotwin_builder as cb
    parts = cb._delta_parts(ctx, delta, utils)
    d_hard = (1000 * (parts["new_dups"] - ctx["dups"])
              + parts["d_over"]).astype(jnp.int32)
    exact = jnp.stack([d_hard, parts["d_late"].astype(jnp.int32),
                       parts["d_dist"].astype(jnp.int32)])
    exact = jnp.where(parts["over_cap"] | ctx["base_over"] | ~any_valid,
                      _STUB, exact)

    # tabu info (winner's touched group slots; reference pushes touched ids
    # during sampling, `mover.rs:75-96`)
    slot1 = jnp.where(fam == 1, cfg.slot_of_row_veh[w_row],
                      cfg.slot_of_row_cust[w_row])
    slot2 = jnp.where(fam == 2, cfg.slot_of_row_cust[jnp.minimum(vi, n - 1)],
                      slot1)
    # affected vehicles of the winner (pre-update ids; <=2 by construction)
    # — `patch_tables` recomputes exactly these routes' cumulant rows
    iota_n = jnp.arange(n, dtype=jnp.int32)
    av_a = jnp.sum(jnp.where(iota_n == w_row, ctx["v"], 0)).astype(jnp.int32)
    v_of_vi = jnp.sum(jnp.where(iota_n == vi, ctx["v"], 0)).astype(jnp.int32)
    av_b = jnp.where(fam == 1, vi.astype(jnp.int32),
                     jnp.where(fam == 2, v_of_vi, jnp.int32(kk)))
    info = {
        "group": jnp.where(fam == 1, cfg.g_veh, cfg.g_cust).astype(jnp.int32),
        "positions": jnp.stack([slot1, slot2]).astype(jnp.int32),
        "count": jnp.where(fam == 2, 2, 1).astype(jnp.int32),
        "av": jnp.stack([av_a, av_b]),
    }

    n_scored = (jnp.sum(sc["a_valid"], dtype=jnp.int64)
                + jnp.sum(sc["b_valid"], dtype=jnp.int64)
                + jnp.sum(sc["c_valid"], dtype=jnp.int64))
    n_nonconv = (jnp.sum(sc["a_valid"] & ~sc["a_conv"], dtype=jnp.int64)
                 + jnp.sum(sc["c_valid"] & ~sc["c_conv"], dtype=jnp.int64))
    stats = {"n_scored": n_scored, "n_nonconv": n_nonconv}
    return delta, exact, info, stats


def exact_score_row(ctx, exact_ints, utils):
    """f64[3] score row of the winner candidate, computed exactly from the
    ctx's integer sums + the winner's exact integer deltas (bit-equal to
    `ctx_score_row` of the post-accept ctx). Stub row when the winner is
    stubbed. Used by acceptance rules that compare against stored f64
    scores (LateAcceptance's ring)."""
    from greyjack_tpu.ops import lexico
    hard = (1000.0 * ctx["dups"].astype(jnp.float64)
            + ctx["sum_overflow"].astype(jnp.float64)
            + exact_ints[0].astype(jnp.float64))
    medium = (ctx["sum_late"] + exact_ints[1]).astype(jnp.float64)
    soft = (ctx["sum_dist"] + exact_ints[2]).astype(jnp.float64) / 1000.0
    row = jnp.stack([hard, medium, soft])
    bad = (exact_ints[0] == _STUB) | ctx["base_over"]
    return jnp.where(bad, lexico.stub_score_row(3), row)
