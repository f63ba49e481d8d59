"""VRP cotwin + fused score kernels — the flagship workload.

Reference: `examples/vrp/src/persistence/cotwin_builder.rs`
(two planning vars per stop — vehicle_id with semantic groups
["vehicle_assignment", "common"], customer_id with ["customer_assignment",
"common"]; capacity-aware greedy nearest-neighbour init; frozen-flag
pinning for replanning) and the score semantics of the fused all-in-one
constraint (`score/incremental_score_calculator.rs:32-142`):

  hard   = 1000 * duplicate-stops + capacity overflow
  medium = time-window lateness (+ work-day overtime)
  soft   = total route distance

Array formulation: the prescoring step stably sorts stops by vehicle (the
reference's common_df join+sort, `plain_score_calculator.rs:39-45`) and runs
one `vrp_routes` scan producing distance and lateness together; the
duplicate and capacity penalties are bincount / segment-sum kernels. All of
it is vmapped over the population by the score requester.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from greyjack_tpu.cotwin import Cotwin, CotwinBuilderBase
from greyjack_tpu.variables import GJInteger
from greyjack_tpu.score_calculation.scores import HardMediumSoftScore
from greyjack_tpu.score_calculation.score_calculators import (
    PlainScoreCalculator,
    IncrementalScoreCalculator,
)
from greyjack_tpu.ops import segments, routes, join, moves, lexico


class CotStop:
    def __init__(self, vehicle_id, customer_id):
        self.vehicle_id = vehicle_id
        self.customer_id = customer_id

    def to_vec(self):
        return [("vehicle_id", self.vehicle_id), ("customer_id", self.customer_id)]


class CotCustomer:
    def __init__(self, customer_id, demand, time_window_start, time_window_end,
                 service_time):
        self._fields = [
            ("customer_id", customer_id),
            ("demand", demand),
            ("time_window_start", time_window_start),
            ("time_window_end", time_window_end),
            ("service_time", service_time),
        ]

    def to_vec(self):
        return list(self._fields)


class CotVehicle:
    def __init__(self, vehicle_id, capacity, depot_vec_id, work_day_start,
                 work_day_end):
        self._fields = [
            ("vehicle_id", vehicle_id),
            ("capacity", capacity),
            ("depot_vec_id", depot_vec_id),
            ("work_day_start", work_day_start),
            ("work_day_end", work_day_end),
        ]

    def to_vec(self):
        return list(self._fields)


# --- constraints ------------------------------------------------------------

def build_common(planning, facts, utils):
    """Prescoring: sort stops by vehicle + one fused route walk
    (the reference's common_df build, plus the route walks both distance and
    lateness constraints share).

    Fast path (default): gather-free joins — the vehicle sort, a sort-merge
    lookup of the packed customer-fact table (which yields the duplicate
    count for free), and the packed route kernel whose only O(N) gather is
    the chain-leg lookup. `exact_fp_scores=True` switches to the
    sequential-order kernel that reproduces the reference's f64 fold
    bit-for-bit."""
    stops = planning["planning_stops"]
    v = stops["vehicle_id"]
    c = stops["customer_id"]
    sorted_v, perm = routes.sort_stops_by_vehicle(v)

    if utils["exact_fp_scores"]:
        sorted_c = c[perm]
        tw = {}
        if utils["time_windowed"]:
            tw = dict(
                work_day_start=utils["work_day_start"],
                work_day_end=utils["work_day_end"],
                tw_start=utils["tw_start"], tw_end=utils["tw_end"],
                service_time=utils["service_time"],
            )
        dist, lateness = routes.vrp_routes(
            sorted_v, sorted_c, utils["distance_matrix"],
            utils["vehicle_depot_ids"], utils["k_vehicles"], **tw,
        )
        dups = segments.count_minus_n_unique(c, utils["n_locations"])
        demands = utils["demand_by_vec_id"][c]
        loads = segments.segment_sum(demands, v, utils["k_vehicles"])
    else:
        sorted_c = join.apply_permutation(c, perm)
        # direct row gather: measured ~20x faster than the sort-merge join at
        # population batch shapes (profile 2026-08-18: 380ms merge vs 18ms
        # gather for [2048, 1000]) — XLA's serial gather beats the
        # full-width forward-fill cascade once the batch is large
        cust_rows = utils["cust_packed"][sorted_c]
        dups = segments.count_minus_n_unique(c, utils["n_locations"])
        dist, lateness = routes.vrp_routes_packed(
            sorted_v, sorted_c, utils["dm_flat_milli"],
            utils["n_locations"], utils["k_vehicles"],
            utils["vehicle_depot_ids"],
            utils.get("work_day_start_k"), utils.get("work_day_end_k"),
            cust_rows, utils["time_windowed"],
            dm_at=utils.get("dm_at"),
        )
        loads = segments.segment_sum(cust_rows[:, 0], sorted_v,
                                     utils["k_vehicles"])
    return {
        "route_distance": dist,
        "route_lateness": lateness,
        "dup_count": dups,
        "vehicle_loads": loads,
    }


def no_duplicating_stops_constraint(planning, facts, utils):
    z = jnp.zeros((), jnp.float64)
    return (1000.0 * utils["dup_count"], z, z)


def capacity_constraint(planning, facts, utils):
    over = jnp.maximum(utils["vehicle_loads"] - utils["capacities"], 0)
    overflow = jnp.sum(over).astype(jnp.float64)
    z = jnp.zeros((), jnp.float64)
    return (overflow, z, z)


def minimize_distance(planning, facts, utils):
    z = jnp.zeros((), jnp.float64)
    return (z, z, utils["route_distance"])


def late_arrival_penalty(planning, facts, utils):
    z = jnp.zeros((), jnp.float64)
    return (z, utils["route_lateness"], z)


# --- delta (incremental) kernels ---------------------------------------------
# The reference's fused incremental VRP scorer patches the base tour with the
# delta rows and re-walks the routes in Rust (~20x over plain,
# `examples/vrp/src/score/incremental_score_calculator.rs:21-26,55-139`). Array
# formulation: the ctx carries per-vehicle ROUTE BUFFERS [k, R] in stable
# (vehicle, stop-index) order — the stop index as sort key plus the per-stop
# facts (customer id, service time, window floor/end, outgoing chain leg) as
# PAYLOAD columns, so a neighbour re-walks only the <= 2*KD routes its
# changed stops touch (KD = the sampler's static delta width).
#
# Two merge paths produce identical buffers:
#   * KD <= 4 (`_delta_parts_small`, the hot path for change/swap/edges
#     configs): removals/insertions become per-slot SHIFTS; the new buffers
#     are built from 2*KD+1 masked rolls — no sort, no scatter, no
#     full-width gather. Distances use the CARRIED-LEG trick: each stop
#     carries its outgoing leg value through the merge, only the O(KD)
#     pairs adjacent to an edit are "dirty", and one consolidated gather of
#     [3*KD + 2*A] distance-matrix entries per neighbour corrects them
#     (over-flagging a clean pair is a no-op: its correction is zero).
#     Lateness is the prefix form  post = P + max(w0, cummax(floor - P)),
#     P = cumsum(service)  — one cumsum + one cummax per route row.
#   * KD > 4 (`_delta_parts_sorted`, generic fallback for scramble /
#     windowed moves): the round-1 variadic-sort merge with full-width leg
#     gathers.
#
# R (`route_cap`) is a static per-instance bound on route length. Any
# neighbour that would grow a route beyond R scores as the stub (worst)
# score and is therefore never accepted — a documented divergence from the
# plain path, unreachable in practice (R >= 4x the mean route length, and
# capacity hard penalties repel long routes; instances with <= 64 stops or
# route_cap == n_stops are exact by construction).

_PAYLOAD_KEYS = ("r_stop", "r_c", "r_ct", "r_floor", "r_ce")
_ALL_BUF_KEYS = _PAYLOAD_KEYS + ("r_leg",)
_SMALL_DELTA_MAX = 4


def _route_cap(n_stops, k):
    return int(min(n_stops, max(48, -(-4 * n_stops // k))))


def _payload_from_customers(cids, utils):
    """(c, service, floor=tw_start+service, tw_end) for customer ids."""
    crows = utils["cust_packed"][cids]
    cs = crows[..., 1]
    ce = crows[..., 2]
    ct = crows[..., 3]
    return cids, ct, cs + ct, ce


def _late_from_buffers(bufs, valid, length, veh_ids, utils):
    """Time-window lateness per route row, prefix form.

    The arrival recurrence post_j = max(post_{j-1}, cs_j) + ct_j unrolls to
        post_j = P_j + max(w0, cummax_{i<=j}(floor_i - P_i)),
    P = inclusive cumsum of service times, floor = cs + ct — one cumsum and
    one cummax per row instead of the (add, floor)-pair doubling scan
    (measured ~10x faster at neighbourhood batch shapes, scripts/bench_ops).
    Integer math, bit-identical to the sequential walk. Beyond the valid
    prefix ct is 0 and floor is -inf, so post[:, -1] IS the route's final
    arrival — no indexed read needed.
    """
    acc = utils["acc_dtype"]
    a, wd = valid.shape
    big = jnp.asarray(1 << 30, jnp.int32)
    ct = jnp.where(valid, bufs["r_ct"], 0)
    floor = jnp.where(valid, bufs["r_floor"], -big)
    w0 = utils["work_day_start_k"][veh_ids].astype(jnp.int32)
    w1 = utils["work_day_end_k"][veh_ids].astype(jnp.int32)
    p = jnp.cumsum(ct, axis=1)
    post = p + jnp.maximum(w0[:, None], jax.lax.cummax(floor - p, axis=1))
    late = jnp.where(valid, jnp.maximum(post - bufs["r_ce"], 0), 0)
    has = length > 0
    overtime = jnp.where(has, jnp.maximum(post[:, -1] - w1, 0), 0)
    return jnp.sum(late, axis=1, dtype=acc) + overtime.astype(acc)


def _buffer_metrics(bufs, veh_ids, utils, return_legs=False):
    """Per-route metrics straight off payload buffers (sorted-merge path).

    bufs: dict of i32[A, W] arrays (`_PAYLOAD_KEYS`), rows sorted by r_stop
    with sentinel n_stops padding (valid entries form a prefix); veh_ids:
    i32[A]. Returns (dist i64[A], late i64[A], length i32[A]) — plus the
    masked chain-leg matrix i32[A, W-1] when `return_legs` — with
    per-vehicle semantics identical to `routes.vrp_routes_packed`.
    """
    acc = utils["acc_dtype"]
    l = utils["n_locations"]
    dmf = utils["dm_flat_milli"]
    n = utils["n_stops"]
    key = bufs["r_stop"]
    rc = bufs["r_c"]
    a, wd = key.shape
    valid = key < n
    length = jnp.sum(valid, axis=1).astype(jnp.int32)
    has = length > 0

    legs = dmf[rc[:, :-1] * l + rc[:, 1:]]
    legs = jnp.where(valid[:, 1:], legs, 0)
    depots = utils["vehicle_depot_ids"][veh_ids].astype(jnp.int32)
    first = rc[:, 0]
    last_onehot = jnp.arange(wd)[None, :] == (length[:, None] - 1)
    last = jnp.sum(jnp.where(last_onehot, rc, 0), axis=1, dtype=jnp.int32)
    ends = (dmf[depots * l + first].astype(acc)
            + dmf[last * l + depots].astype(acc))
    dist = jnp.where(has, ends + jnp.sum(legs, axis=1, dtype=acc), 0)

    if utils["time_windowed"]:
        late_total = _late_from_buffers(bufs, valid, length, veh_ids, utils)
    else:
        late_total = jnp.zeros((a,), acc)
    if return_legs:
        return dist, late_total, length, legs
    return dist, late_total, length


def build_delta_ctx(planning, facts, utils):
    """O(N) base pass: payload route buffers + per-vehicle metrics + totals."""
    stops = planning["planning_stops"]
    v = stops["vehicle_id"].astype(jnp.int32)
    c = stops["customer_id"].astype(jnp.int32)
    n = v.shape[0]
    l = utils["n_locations"]
    k = utils["k_vehicles"]
    r = utils["route_cap"]

    counts = jnp.zeros((l,), jnp.int32).at[c].add(1)
    dups = (n - jnp.sum(counts > 0)).astype(jnp.int32)

    sorted_v, perm = routes.sort_stops_by_vehicle(v)
    posi = jnp.arange(n, dtype=jnp.int32)
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_v[1:] != sorted_v[:-1]])
    first_pos = jnp.zeros((k,), jnp.int32).at[
        jnp.where(is_first, sorted_v, k)].set(posi, mode="drop")
    rank = posi - first_pos[jnp.minimum(sorted_v, k - 1)]
    rank_c = jnp.minimum(rank, r - 1)
    r_stop = jnp.full((k, r), n, jnp.int32).at[
        sorted_v, rank_c].set(perm, mode="drop")
    pos = jnp.zeros((n,), jnp.int32).at[perm].set(rank_c)

    cid, ct, floor, ce = _payload_from_customers(c[perm], utils)
    zero = jnp.zeros((k, r), jnp.int32)
    bufs = {"r_stop": r_stop}
    for name, col in (("r_c", cid), ("r_ct", ct),
                      ("r_floor", floor), ("r_ce", ce)):
        bufs[name] = zero.at[sorted_v, rank_c].set(col, mode="drop")

    veh_ids = jnp.arange(k, dtype=jnp.int32)
    dist, late, length, legs = _buffer_metrics(bufs, veh_ids, utils,
                                               return_legs=True)
    # carried-leg payload: slot j's outgoing chain leg (0 at the route's
    # last stop and at sentinels) — rides the small-delta merge so clean
    # pairs never re-touch the distance matrix
    bufs["r_leg"] = jnp.concatenate(
        [legs, jnp.zeros((k, 1), legs.dtype)], axis=1)
    load = jnp.zeros((k,), jnp.int32).at[v].add(
        utils["cust_packed"][c, 0], mode="drop")
    overflow = jnp.maximum(load - utils["capacities"], 0).astype(jnp.int64)
    # base-over-cap guard: a base whose route exceeds route_cap would have
    # its overflow stops collapsed into slot r-1 (wrong metrics). Such a
    # base can only come from initial sampling / an externally fed solution
    # (accepted deltas are never over-cap); flag it so `score_delta` can
    # poison every neighbour with the stub instead of mis-scoring silently.
    true_counts = jnp.zeros((k,), jnp.int32).at[v].add(1, mode="drop")
    base_over = jnp.any(true_counts > r)
    return {"v": v, "c": c, "counts": counts, "dups": dups, "pos": pos,
            "base_over": base_over,
            **bufs,
            "dist": dist, "late": late, "load": load, "len": length,
            # packed lookup tables: the per-stop and per-vehicle scalars the
            # delta scorer needs are packed into one row-gather apiece
            # instead of 3-8 separate ones
            "row_pack": jnp.stack(
                [v, c, pos, utils["cust_packed"][c, 0]], axis=-1),
            "veh_pack": jnp.stack([
                utils["work_day_start_k"].astype(jnp.int32),
                utils["work_day_end_k"].astype(jnp.int32),
                length.astype(jnp.int32),
                dist.astype(jnp.int32) if dist.dtype == jnp.int32 else
                jnp.clip(dist, -(2**31) + 1, 2**31 - 1).astype(jnp.int32),
                late.astype(jnp.int32) if late.dtype == jnp.int32 else
                jnp.clip(late, -(2**31) + 1, 2**31 - 1).astype(jnp.int32),
                load,
                utils["capacities"],
                utils["vehicle_depot_ids"].astype(jnp.int32),
            ], axis=-1),
            "sum_dist": jnp.sum(dist), "sum_late": jnp.sum(late),
            "sum_overflow": jnp.sum(overflow)}


def _delta_parts_sorted(ctx, delta, utils):
    """Generic-width delta analysis (variadic-sort merge): per-row patched
    (vehicle, customer) values, affected-route payload rebuild, exact
    metric deltas. Fallback for wide deltas (scramble / windowed moves);
    `_delta_parts_small` covers the hot narrow-move configs."""
    delta = moves.dedupe_delta(delta)
    schema = utils["delta_schema"]
    k = utils["k_vehicles"]
    r = utils["route_cap"]
    n = ctx["v"].shape[0]
    kd = delta["positions"].shape[0]

    rows = schema["var_row"][delta["positions"]]
    cols = schema["var_col"][delta["positions"]]
    valid = delta["valid"]
    nv = jnp.round(delta["values"]).astype(jnp.int32)
    is_veh = cols == 0

    # row-representative dedupe + per-row patched values (a row may have
    # both its vehicle and customer vars in the delta)
    rid = jnp.where(valid, rows, n)
    idx = jnp.arange(kd)
    eqr = rid[:, None] == rid[None, :]
    rep = valid & ~jnp.any(eqr & (idx[None, :] < idx[:, None]), axis=1)
    veh_match = eqr & is_veh[None, :] & valid[None, :]
    cust_match = eqr & (~is_veh)[None, :] & valid[None, :]
    old_v = ctx["v"][rows]
    old_c = ctx["c"][rows]
    new_v = jnp.where(jnp.any(veh_match, axis=1),
                      nv[jnp.argmax(veh_match, axis=1)], old_v)
    new_c = jnp.where(jnp.any(cust_match, axis=1),
                      nv[jnp.argmax(cust_match, axis=1)], old_c)

    d_unique = segments.nunique_delta(ctx["counts"], old_c, new_c, rep)
    new_dups = ctx["dups"] - d_unique

    # affected vehicles (old of every changed row, new of moved rows), deduped
    veh_changed = rep & (new_v != old_v)
    av = jnp.concatenate([jnp.where(rep, old_v, k),
                          jnp.where(veh_changed, new_v, k)])
    idxa = jnp.arange(2 * kd)
    eqa = av[:, None] == av[None, :]
    arep = (av < k) & ~jnp.any(eqa & (idxa[None, :] < idxa[:, None]), axis=1)
    av_safe = jnp.minimum(av, k - 1)
    # affected-list slot of each rep row's OLD vehicle (its arep occurrence)
    old_v_at = (av[None, :] == old_v[:, None]) & arep[None, :]   # [KD, 2KD]
    a_of_row = jnp.argmax(old_v_at, axis=1).astype(jnp.int32)

    # rebuild affected routes on payload buffers: patch changed customers at
    # their known slots, clear moved-away stops, append moved-in stops,
    # one variadic sort by stop index (== stable (vehicle, index) order)
    slot_of_row = ctx["pos"][rows]
    a2 = 2 * kd
    patch_a = jnp.where(rep, a_of_row, a2)
    clear_a = jnp.where(veh_changed, a_of_row, a2)
    dem_old = utils["cust_packed"][old_c, 0]
    dem_new = utils["cust_packed"][new_c, 0]
    npay = _payload_from_customers(new_c, utils)
    base = {name: ctx[name][av_safe] for name in _PAYLOAD_KEYS}
    base["r_stop"] = base["r_stop"].at[clear_a, slot_of_row].set(
        n, mode="drop")
    for name, col in zip(_PAYLOAD_KEYS[1:], npay):
        base[name] = base[name].at[patch_a, slot_of_row].set(col, mode="drop")

    ins_here = veh_changed[None, :] & (new_v[None, :] == av[:, None])
    ins = {"r_stop": jnp.where(ins_here, rows[None, :], n)}
    for name, col in zip(_PAYLOAD_KEYS[1:], npay):
        ins[name] = jnp.broadcast_to(col[None, :], (a2, kd))

    operands = tuple(
        jnp.concatenate([base[name], ins[name]], axis=1)
        for name in _PAYLOAD_KEYS)
    sorted_ops = jax.lax.sort(operands, dimension=1, num_keys=1,
                              is_stable=False)
    bufs = dict(zip(_PAYLOAD_KEYS, sorted_ops))

    dist, late, length, legs = _buffer_metrics(bufs, av_safe, utils,
                                               return_legs=True)
    bufs["r_leg"] = jnp.concatenate(
        [legs, jnp.zeros((legs.shape[0], 1), legs.dtype)], axis=1)

    # O(K) arithmetic load update — no demand payload in the sort
    is_old = old_v[None, :] == av[:, None]          # [A, KD]
    is_new = new_v[None, :] == av[:, None]
    contrib = (
        jnp.where(veh_changed[None, :] & is_old, -dem_old[None, :], 0)
        + jnp.where(veh_changed[None, :] & is_new, dem_new[None, :], 0)
        + jnp.where(rep[None, :] & ~veh_changed[None, :] & is_old,
                    (dem_new - dem_old)[None, :], 0))
    # cast the row sum back: under x64 the i32 sum promotes to i64 and the
    # later scatter into the i32 ctx['load'] would be a hard error in
    # future JAX releases
    load = ctx["load"][av_safe] + jnp.sum(contrib, axis=1).astype(jnp.int32)

    cap_a = utils["capacities"][av_safe]
    m = arep
    d_dist = jnp.sum(jnp.where(m, dist - ctx["dist"][av_safe], 0))
    d_late = jnp.sum(jnp.where(m, late - ctx["late"][av_safe], 0))
    d_over = jnp.sum(jnp.where(
        m,
        jnp.maximum(load - cap_a, 0).astype(jnp.int64)
        - jnp.maximum(ctx["load"][av_safe] - cap_a, 0).astype(jnp.int64),
        0))
    over_cap = jnp.any(m & (length > r))
    return {"rows": rows, "rep": rep, "new_v": new_v, "new_c": new_c,
            "old_c": old_c, "av": av, "arep": arep, "bufs": bufs,
            "dist": dist, "late": late, "load": load, "len": length,
            "d_dist": d_dist, "d_late": d_late, "d_over": d_over,
            "new_dups": new_dups, "over_cap": over_cap}


def _delta_common(ctx, delta, utils):
    """Shared per-neighbour scalar analysis: patched (vehicle, customer)
    values, affected-route table, row->route-slot maps. Used identically by
    the shift-merge kernel (`_delta_parts_small`). `delta` must already be
    deduped."""
    schema = utils["delta_schema"]
    k = utils["k_vehicles"]
    n = ctx["v"].shape[0]
    kd = delta["positions"].shape[0]

    rc2 = schema["var_rowcol"][delta["positions"]]   # one packed gather
    rows = rc2[..., 0]
    cols = rc2[..., 1]
    valid = delta["valid"]
    nv = jnp.round(delta["values"]).astype(jnp.int32)
    is_veh = cols == 0

    rid = jnp.where(valid, rows, n)
    idx = jnp.arange(kd)
    eqr = rid[:, None] == rid[None, :]
    rep = valid & ~jnp.any(eqr & (idx[None, :] < idx[:, None]), axis=1)
    veh_match = eqr & is_veh[None, :] & valid[None, :]
    cust_match = eqr & (~is_veh)[None, :] & valid[None, :]
    rp_row = ctx["row_pack"][rows]                   # one packed gather
    old_v = rp_row[..., 0]
    old_c = rp_row[..., 1]
    slot_of_row = rp_row[..., 2]
    dem_old = rp_row[..., 3]
    new_v = jnp.where(jnp.any(veh_match, axis=1),
                      nv[jnp.argmax(veh_match, axis=1)], old_v)
    new_c = jnp.where(jnp.any(cust_match, axis=1),
                      nv[jnp.argmax(cust_match, axis=1)], old_c)

    d_unique = segments.nunique_delta(ctx["counts"], old_c, new_c, rep)
    new_dups = ctx["dups"] - d_unique

    veh_changed = rep & (new_v != old_v)
    stay = rep & ~veh_changed

    av = jnp.concatenate([jnp.where(rep, old_v, k),
                          jnp.where(veh_changed, new_v, k)])
    idxa = jnp.arange(2 * kd)
    eqa = av[:, None] == av[None, :]
    arep = (av < k) & ~jnp.any(eqa & (idxa[None, :] < idxa[:, None]), axis=1)
    av_safe = jnp.minimum(av, k - 1)
    # affected-list slots of each rep row's OLD and NEW vehicles
    a_of_row = jnp.argmax((av[None, :] == old_v[:, None]) & arep[None, :],
                          axis=1).astype(jnp.int32)
    a_of_new = jnp.argmax((av[None, :] == new_v[:, None]) & arep[None, :],
                          axis=1).astype(jnp.int32)
    return {"rows": rows, "rep": rep, "valid": valid, "old_v": old_v,
            "old_c": old_c, "new_v": new_v, "new_c": new_c,
            "dem_old": dem_old,
            "veh_changed": veh_changed, "stay": stay, "av": av,
            "arep": arep, "av_safe": av_safe, "a_of_row": a_of_row,
            "a_of_new": a_of_new, "slot_of_row": slot_of_row,
            "new_dups": new_dups}


def _delta_parts_small(ctx, delta, utils):
    """Narrow-delta analysis (KD <= 4): shift-merge + carried-leg accounting.

    The whole per-neighbour pipeline is elementwise over [A, R] grids plus
    ONE consolidated distance-matrix gather of [3*KD + 2*A] entries — no
    sort, no scatter, no full-width gather (design rationale in the section
    comment above; operator costs in scripts/bench_ops.py).
    """
    delta = moves.dedupe_delta(delta)
    k = utils["k_vehicles"]
    r = utils["route_cap"]
    n = ctx["v"].shape[0]
    l = utils["n_locations"]
    dmf = utils["dm_flat_milli"]
    kd = delta["positions"].shape[0]
    a2 = 2 * kd
    idxa = jnp.arange(a2)

    c = _delta_common(ctx, delta, utils)
    rows = c["rows"]
    rep = c["rep"]
    old_c = c["old_c"]
    new_v = c["new_v"]
    new_c = c["new_c"]
    old_v = c["old_v"]
    veh_changed = c["veh_changed"]
    stay = c["stay"]
    av = c["av"]
    arep = c["arep"]
    av_safe = c["av_safe"]
    a_of_row = c["a_of_row"]
    a_of_new = c["a_of_new"]
    slot_of_row = c["slot_of_row"]
    new_dups = c["new_dups"]

    base = {name: ctx[name][av_safe] for name in _ALL_BUF_KEYS}  # [A, R]

    jgrid = jnp.arange(r, dtype=jnp.int32)
    # per-row one-hot grids [KD, A, R] (tiny: KD*A*R), scatter-free
    row_at = ((idxa[None, :, None] == a_of_row[:, None, None])
              & (jgrid[None, None, :] == slot_of_row[:, None, None]))

    # patch stay rows' customer payloads in place
    npay = _payload_from_customers(new_c, utils)
    pm = row_at & stay[:, None, None]
    pm_any = jnp.any(pm, axis=0)
    for name, col in zip(_PAYLOAD_KEYS[1:], npay):
        pval = jnp.sum(jnp.where(pm, col[:, None, None], 0), axis=0,
                       dtype=jnp.int32)
        base[name] = jnp.where(pm_any, pval, base[name])

    # --- shifts: removals close gaps, insertions open them --------------------
    cleared = jnp.any(row_at & veh_changed[:, None, None], axis=0)  # [A, R]
    ins_into = (veh_changed[:, None]
                & (idxa[None, :] == a_of_new[:, None]))             # [KD, A]
    key_gt_row = rows[:, None, None] < base["r_stop"][None]         # [KD, A, R]
    ins_before = jnp.sum(ins_into[:, :, None] & key_gt_row, axis=0,
                         dtype=jnp.int32)
    cum_clr = jnp.cumsum(cleared.astype(jnp.int32), axis=1)
    rem_before = cum_clr - cleared
    shift = ins_before - rem_before                                  # [A, R]
    survives = ~cleared

    # insert positions: survivors with smaller key + earlier same-route inserts
    ins_key = jnp.where(veh_changed, rows, n)
    same_new = (veh_changed[:, None] & veh_changed[None, :]
                & (a_of_new[:, None] == a_of_new[None, :]))
    ins_rank_ins = jnp.sum(same_new & (ins_key[None, :] < ins_key[:, None]),
                           axis=1, dtype=jnp.int32)
    ins_rank_base = jnp.sum(
        ins_into[:, :, None] & survives[None] & ~key_gt_row, axis=(1, 2),
        dtype=jnp.int32)
    ins_pos = (ins_rank_base + ins_rank_ins).astype(jnp.int32)

    # --- merge: 2*KD+1 masked rolls + one-hot insert + sentinel fill ----------
    received = jnp.zeros((a2, r), jnp.int32)
    merged = {name: jnp.zeros_like(base[name]) for name in _ALL_BUF_KEYS}
    for s in range(-kd, kd + 1):
        m = survives & (shift == s)
        # forbid roll wrap-around: sources shifted past either end (tail
        # sentinels pushed off by insertions, and over-cap growth) must be
        # dropped, not wrapped onto the other side
        keep = (jgrid >= s) if s >= 0 else (jgrid < r + s)
        received = received + jnp.where(
            keep, jnp.roll(m.astype(jnp.int32), s, axis=1), 0)
        for name in _ALL_BUF_KEYS:
            merged[name] = merged[name] + jnp.where(
                keep, jnp.roll(jnp.where(m, base[name], 0), s, axis=1), 0)
    im = (veh_changed[:, None, None]
          & (idxa[None, :, None] == a_of_new[:, None, None])
          & (jgrid[None, None, :] == ins_pos[:, None, None]))
    im_any = jnp.any(im, axis=0)
    ins_cols = dict(zip(_PAYLOAD_KEYS[1:], npay))
    ins_cols["r_stop"] = rows
    ins_cols["r_leg"] = jnp.zeros((kd,), jnp.int32)
    bufs = {}
    for name in _ALL_BUF_KEYS:
        ival = jnp.sum(jnp.where(im, ins_cols[name][:, None, None], 0),
                       axis=0, dtype=jnp.int32)
        bufs[name] = jnp.where(im_any, ival, merged[name])
    received = jnp.where(im_any, 1, received)
    bufs["r_stop"] = jnp.where(received > 0, bufs["r_stop"], n)

    # --- lengths / loads -------------------------------------------------------
    n_clr = jnp.sum(cleared, axis=1).astype(jnp.int32)
    n_ins = jnp.sum(ins_into, axis=0).astype(jnp.int32)
    length = ctx["len"][av_safe] - n_clr + n_ins
    over_cap = jnp.any(arep & (length > r))
    valid_j = jgrid[None, :] < length[:, None]
    has = length > 0

    dem_old = utils["cust_packed"][old_c, 0]
    dem_new = utils["cust_packed"][new_c, 0]
    is_old = old_v[None, :] == av[:, None]
    is_new = new_v[None, :] == av[:, None]
    contrib = (
        jnp.where(veh_changed[None, :] & is_old, -dem_old[None, :], 0)
        + jnp.where(veh_changed[None, :] & is_new, dem_new[None, :], 0)
        + jnp.where(rep[None, :] & ~veh_changed[None, :] & is_old,
                    (dem_new - dem_old)[None, :], 0))
    load = ctx["load"][av_safe] + jnp.sum(contrib, axis=1).astype(jnp.int32)

    # --- distance: carried legs + dirty-pair corrections -----------------------
    # every possibly-dirty pair is adjacent to an edit locus; over-flagging
    # a clean pair is harmless (its correction is dm[u,v] - carried == 0),
    # so flag generously: 3 candidates per rep row
    shift_at_row = jnp.sum(jnp.where(row_at, shift[None], 0), axis=(1, 2),
                           dtype=jnp.int32)
    locus = slot_of_row + shift_at_row
    er = jnp.concatenate([a_of_row,
                          jnp.where(veh_changed, a_of_new, a_of_row),
                          a_of_new])
    el = jnp.concatenate([locus - 1,
                          jnp.where(veh_changed, ins_pos - 1, locus),
                          ins_pos])
    ev = jnp.concatenate([rep, rep, veh_changed])
    len_at = jnp.sum(jnp.where(idxa[None, :] == er[:, None],
                               length[None, :], 0), axis=1, dtype=jnp.int32)
    ev = ev & (el >= 0) & (el <= len_at - 2)
    ekey = jnp.where(ev, er * (r + 1) + el, -1)
    ii3 = jnp.arange(3 * kd)
    edup = jnp.any((ekey[:, None] == ekey[None, :]) & ev[:, None]
                   & ev[None, :] & (ii3[None, :] < ii3[:, None]), axis=1)
    ev = ev & ~edup

    pair_l = ((idxa[None, :, None] == er[:, None, None])
              & (jgrid[None, None, :] == el[:, None, None]))   # [3KD, A, R]
    pair_r = ((idxa[None, :, None] == er[:, None, None])
              & (jgrid[None, None, :] == el[:, None, None] + 1))
    u = jnp.sum(jnp.where(pair_l, bufs["r_c"][None], 0), axis=(1, 2),
                dtype=jnp.int32)
    v_right = jnp.sum(jnp.where(pair_r, bufs["r_c"][None], 0), axis=(1, 2),
                      dtype=jnp.int32)
    carried = jnp.sum(jnp.where(pair_l, bufs["r_leg"][None], 0),
                      axis=(1, 2), dtype=jnp.int32)

    depots = utils["vehicle_depot_ids"][av_safe].astype(jnp.int32)
    first_c = bufs["r_c"][:, 0]
    last_c = jnp.sum(
        jnp.where(jgrid[None, :] == (length[:, None] - 1), bufs["r_c"], 0),
        axis=1, dtype=jnp.int32)
    gidx = jnp.concatenate([
        jnp.where(ev, u * l + v_right, 0),
        jnp.where(has, depots * l + first_c, 0),
        jnp.where(has, last_c * l + depots, 0),
    ])
    gvals = dmf[gidx]  # the ONE consolidated per-neighbour dm gather
    leg_new = gvals[:3 * kd]
    start_leg = jnp.where(has, gvals[3 * kd:3 * kd + a2], 0)
    end_leg = jnp.where(has, gvals[3 * kd + a2:], 0)

    acc = utils["acc_dtype"]
    corr = jnp.where(ev, leg_new - carried, 0)
    corr_by_route = jnp.sum(
        jnp.where(idxa[None, :] == er[:, None],
                  corr[:, None].astype(acc), 0), axis=0, dtype=acc)
    chain = (jnp.sum(jnp.where(valid_j[:, :-1] & valid_j[:, 1:],
                               bufs["r_leg"][:, :-1], 0),
                     axis=1, dtype=acc)
             + corr_by_route)
    dist = jnp.where(has, start_leg.astype(acc)
                     + end_leg.astype(acc) + chain, 0)

    # exact r_leg for ctx updates: patch dirty pairs, zero out-of-pair slots
    rl_patch = jnp.sum(jnp.where(pair_l & ev[:, None, None],
                                 leg_new[:, None, None], 0), axis=0,
                       dtype=jnp.int32)
    rl_dirty = jnp.any(pair_l & ev[:, None, None], axis=0)
    pairv = valid_j[:, :-1] & valid_j[:, 1:]
    bufs["r_leg"] = jnp.where(
        jnp.concatenate([pairv, jnp.zeros((a2, 1), bool)], axis=1),
        jnp.where(rl_dirty, rl_patch, bufs["r_leg"]), 0)

    if utils["time_windowed"]:
        late = _late_from_buffers(bufs, valid_j, length, av_safe, utils)
    else:
        late = jnp.zeros((a2,), acc)

    cap_a = utils["capacities"][av_safe]
    m = arep
    d_dist = jnp.sum(jnp.where(m, dist - ctx["dist"][av_safe], 0))
    d_late = jnp.sum(jnp.where(m, late - ctx["late"][av_safe], 0))
    d_over = jnp.sum(jnp.where(
        m,
        jnp.maximum(load - cap_a, 0).astype(jnp.int64)
        - jnp.maximum(ctx["load"][av_safe] - cap_a, 0).astype(jnp.int64),
        0))
    return {"rows": rows, "rep": rep, "new_v": new_v, "new_c": new_c,
            "old_c": old_c, "av": av, "arep": arep, "bufs": bufs,
            "dist": dist, "late": late, "load": load, "len": length,
            "d_dist": d_dist, "d_late": d_late, "d_over": d_over,
            "new_dups": new_dups, "over_cap": over_cap}


def _delta_parts(ctx, delta, utils):
    """Width-dispatched delta analysis: shift-merge for narrow deltas,
    variadic-sort merge for wide ones. Both produce identical buffers."""
    if delta["positions"].shape[0] <= _SMALL_DELTA_MAX:
        return _delta_parts_small(ctx, delta, utils)
    return _delta_parts_sorted(ctx, delta, utils)


def score_delta(ctx, delta, utils):
    """O(K)-per-neighbour score, bitwise-equal to the plain fast path."""
    p = _delta_parts(ctx, delta, utils)
    hard = (1000.0 * p["new_dups"].astype(jnp.float64)
            + (ctx["sum_overflow"] + p["d_over"]).astype(jnp.float64))
    medium = (ctx["sum_late"] + p["d_late"]).astype(jnp.float64)
    soft = (ctx["sum_dist"] + p["d_dist"]).astype(jnp.float64) / 1000.0
    row = jnp.stack([hard, medium, soft])
    return jnp.where(p["over_cap"] | ctx["base_over"],
                     lexico.stub_score_row(3), row)


def score_delta_ints(ctx, delta, utils):
    """i32[3] integer delta row (1000*d_dups + d_overflow, d_late,
    d_dist_milli) of one neighbour against the ctx's base candidate.

    Each component of the `score_delta` row is (base integer sum + this
    delta) under a monotonic map to f64 (exact below 2^53; the soft column
    is divided by 1000), so the rows are lexicographically order-equivalent
    to the f64 rows and a neighbour is accepted iff its row is <= 0.
    Over-cap neighbours and a poisoned base become INT32_MAX rows, which
    never win an accept-if-<=-zero compare. Valid only where
    `delta_ints_eligible` holds."""
    p = _delta_parts(ctx, delta, utils)
    d_hard = 1000 * (p["new_dups"] - ctx["dups"]) + p["d_over"]
    row = jnp.stack([d_hard, p["d_late"], p["d_dist"]]).astype(jnp.int32)
    return jnp.where(p["over_cap"] | ctx["base_over"],
                     jnp.iinfo(jnp.int32).max, row)


def delta_ints_eligible(utils, delta_width):
    """Static: i32 rows are exact when per-route metrics accumulate in i32
    (`acc_dtype`, chosen with 4x headroom against overflow) and a delta
    touches at most 4 routes (width <= 2), so each summed route delta
    stays inside that headroom."""
    return utils["acc_dtype"] == jnp.int32 and delta_width <= 2


def ctx_score_row(ctx, utils):
    """f64[3] score of the ctx's own base candidate, from its exact integer
    sums — used by the int-delta local-search loop to materialize the score
    only for the accepted winner (bit-equal to `score_delta` of a no-op
    delta; f64 stays off the per-neighbour hot path)."""
    hard = (1000.0 * ctx["dups"].astype(jnp.float64)
            + ctx["sum_overflow"].astype(jnp.float64))
    medium = ctx["sum_late"].astype(jnp.float64)
    soft = ctx["sum_dist"].astype(jnp.float64) / 1000.0
    row = jnp.stack([hard, medium, soft])
    return jnp.where(ctx["base_over"], lexico.stub_score_row(3), row)


def ctx_int_totals(ctx, utils):
    """i64[3] exact integer totals (1000*dups + overflow, lateness,
    distance milli) — with int_scales [1, 1, 1000] this reproduces
    `ctx_score_row` bit-for-bit (modulo the base_over stub, which the
    agents' stub guards handle) and keeps the int-delta/sweep fast paths
    live under `score_precision` (accept-boundary rounding)."""
    hard = (1000 * ctx["dups"].astype(jnp.int64)
            + ctx["sum_overflow"].astype(jnp.int64))
    return jnp.stack([hard, ctx["sum_late"].astype(jnp.int64),
                      ctx["sum_dist"].astype(jnp.int64)])


def update_ctx(ctx, delta, utils):
    """Apply one ACCEPTED delta to the ctx (identity for all-invalid
    deltas; over-cap deltas are never accepted — their score is the stub).

    The single winner goes through the variadic-sort merge rather than the
    shift-merge: at batch size 1 the shift-merge's ~80 masked-grid ops cost
    more in op overhead than one [A, R+KD] sort (`GJ_UPDATE_SHIFTMERGE=1`
    restores the old path for A/B)."""
    if (delta["positions"].shape[0] <= _SMALL_DELTA_MAX
            and os.environ.get("GJ_UPDATE_SHIFTMERGE")):
        p = _delta_parts_small(ctx, delta, utils)
    else:
        p = _delta_parts_sorted(ctx, delta, utils)
    k = utils["k_vehicles"]
    l = utils["n_locations"]
    r = utils["route_cap"]
    n = ctx["v"].shape[0]
    rowsel = jnp.where(p["rep"], p["rows"], n)
    vehsel = jnp.where(p["arep"], p["av"], k)
    out = dict(ctx)

    # Every table patch below is an iota-compare-select (masked reduction
    # over the KD/A2 axis) instead of a scatter: the touched tables are tiny
    # ([N], [K, R], [L]) so the compares are trivial vector work that XLA
    # fuses — this function sits on the once-per-step accept path. Sentinel
    # indices (n / k for dropped rows) simply never match.
    iota_n = jnp.arange(n, dtype=jnp.int32)
    iota_k = jnp.arange(k, dtype=jnp.int32)
    iota_l = jnp.arange(l, dtype=jnp.int32)

    mrow = iota_n[:, None] == rowsel[None, :]              # [N, KD]
    hit_row = jnp.any(mrow, axis=1)

    def _rowval(vals, old):
        v = jnp.sum(jnp.where(mrow, vals[None, :], 0), axis=1,
                    dtype=old.dtype)
        return jnp.where(hit_row, v, old)

    out["v"] = _rowval(p["new_v"], ctx["v"])
    out["c"] = _rowval(p["new_c"], ctx["c"])
    mold = iota_l[:, None] == jnp.where(p["rep"], p["old_c"], l)[None, :]
    mnew = iota_l[:, None] == jnp.where(p["rep"], p["new_c"], l)[None, :]
    cdt = ctx["counts"].dtype
    out["counts"] = (ctx["counts"]
                     + jnp.sum(mnew.astype(cdt), axis=1, dtype=cdt)
                     - jnp.sum(mold.astype(cdt), axis=1, dtype=cdt))
    out["dups"] = p["new_dups"]

    mveh = iota_k[:, None] == vehsel[None, :]              # [K, A2]
    hit_veh = jnp.any(mveh, axis=1)
    # zero payloads in sentinel slots so the updated ctx is leaf-identical
    # to a fresh `build_delta_ctx` of the patched candidate (tested invariant)
    new_stop_r = p["bufs"]["r_stop"][:, :r]
    valid_r = new_stop_r < n

    def _vehrows(rows_a2, old):                            # [A2, R] -> [K, R]
        v = jnp.sum(jnp.where(mveh[:, :, None], rows_a2[None, :, :], 0),
                    axis=1, dtype=old.dtype)
        return jnp.where(hit_veh[:, None], v, old)

    out["r_stop"] = _vehrows(new_stop_r, ctx["r_stop"])
    for name in _ALL_BUF_KEYS[1:]:
        out[name] = _vehrows(jnp.where(valid_r, p["bufs"][name][:, :r], 0),
                             ctx[name])
    # slots shifted inside every affected route: rewrite pos for their stops
    slot_idx = jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[None, :],
                                new_stop_r.shape)
    mpos = iota_n[:, None, None] == jnp.where(
        valid_r & p["arep"][:, None], new_stop_r, n)[None, :, :]  # [N, A2, R]
    hit_pos = jnp.any(mpos, axis=(1, 2))
    pos_val = jnp.sum(jnp.where(mpos, slot_idx[None], 0), axis=(1, 2),
                      dtype=ctx["pos"].dtype)
    out["pos"] = jnp.where(hit_pos, pos_val, ctx["pos"])

    def _vehscal(val_a2, old):                             # [A2] -> [K]
        v = jnp.sum(jnp.where(mveh, val_a2[None, :].astype(old.dtype), 0),
                    axis=1, dtype=old.dtype)
        return jnp.where(hit_veh, v, old)

    out["dist"] = _vehscal(p["dist"], ctx["dist"])
    out["late"] = _vehscal(p["late"], ctx["late"])
    out["load"] = _vehscal(p["load"], ctx["load"])
    out["len"] = _vehscal(p["len"], ctx["len"])
    out["sum_dist"] = ctx["sum_dist"] + p["d_dist"]
    out["sum_late"] = ctx["sum_late"] + p["d_late"]
    out["sum_overflow"] = ctx["sum_overflow"] + p["d_over"]

    # maintain the packed lookup tables (see build_delta_ctx): per-stop rows
    # first get the route-wide slot rewrite, then the changed rows' values
    dem_new = utils["cust_packed"][p["new_c"], 0]
    lane2 = jnp.where(hit_pos, pos_val, ctx["row_pack"][:, 2])
    pos_rows = jnp.sum(jnp.where(mrow, out["pos"][:, None], 0), axis=0,
                       dtype=jnp.int32)
    rp_vals = jnp.stack([p["new_v"], p["new_c"], pos_rows, dem_new],
                        axis=-1)                           # [KD, 4]
    rp_new = jnp.sum(jnp.where(mrow[:, :, None], rp_vals[None], 0), axis=1,
                     dtype=jnp.int32)
    row_pack = jnp.concatenate(
        [ctx["row_pack"][:, :2], lane2[:, None], ctx["row_pack"][:, 3:]],
        axis=1)
    out["row_pack"] = jnp.where(hit_row[:, None], rp_new, row_pack)

    def _pack32(x):
        if x.dtype == jnp.int32:
            return x
        return jnp.clip(x, -(2**31) + 1, 2**31 - 1).astype(jnp.int32)

    lane_vals = {2: p["len"].astype(jnp.int32), 3: _pack32(p["dist"]),
                 4: _pack32(p["late"]), 5: p["load"].astype(jnp.int32)}
    vp_cols = []
    for j in range(ctx["veh_pack"].shape[1]):
        if j in lane_vals:
            nv = jnp.sum(jnp.where(mveh, lane_vals[j][None, :], 0), axis=1,
                         dtype=jnp.int32)
            vp_cols.append(jnp.where(hit_veh, nv, ctx["veh_pack"][:, j]))
        else:
            vp_cols.append(ctx["veh_pack"][:, j])
    out["veh_pack"] = jnp.stack(vp_cols, axis=-1)
    return out


# --- greedy init (host) -------------------------------------------------------

def greedy_init(dm, demands, capacities, depot_ids, n_depots):
    """Capacity-aware nearest-neighbour fill, vehicle by vehicle — the
    reference's host loop (`cotwin_builder.rs:153-255`), kept HOST-side in
    numpy: it runs once, off the hot path, and is inherently sequential
    (an O(n)-length `lax.scan` would be one long serial device loop). Returns
    (vehicle_ids, customer_ids) int32 arrays of length n_stops + k; -1 rows
    mean "no greedy slot" (left to uniform init, as the reference pads with
    None)."""
    dm = np.asarray(dm)
    demands = np.asarray(demands)
    capacities = np.asarray(capacities)
    depot_ids = np.asarray(depot_ids)
    l = dm.shape[0]
    k = capacities.shape[0]
    n_stops = l - n_depots
    steps = n_stops + k

    remaining = np.zeros((l,), bool)
    remaining[n_depots:] = True
    veh = 0
    prev = int(depot_ids[0])
    load = 0
    veh_out = np.full((steps,), -1, np.int32)
    cust_out = np.full((steps,), -1, np.int32)
    for i in range(steps):
        if veh >= k or not remaining.any():
            break
        d = np.where(remaining, dm[prev], np.inf)
        cand = int(np.argmin(d))
        cand_demand = int(demands[cand])
        if load + cand_demand <= capacities[veh]:
            remaining[cand] = False
            veh_out[i] = veh
            cust_out[i] = cand
            prev = cand
            load += cand_demand
        else:
            # advance to the next vehicle (reference `break`)
            veh += 1
            prev = int(depot_ids[min(veh, k - 1)])
            load = 0
    return veh_out, cust_out


class CotwinBuilder(CotwinBuilderBase):
    def __init__(self, use_incremental_score_calculation=True,
                 use_greed_init=True, exact_fp_scores=False):
        self.use_incremental_score_calculation = use_incremental_score_calculation
        self.use_greed_init = use_greed_init
        self.exact_fp_scores = exact_fp_scores

    def _initial_ids(self, domain, is_already_initialized):
        n_depots = len(domain.depot_vec)
        n_locations = len(domain.customers_vec)
        n_stops = n_locations - n_depots
        k = len(domain.vehicles)
        initial_vehicle = [None] * n_stops
        initial_customer = [None] * n_stops
        frozen = [False] * n_stops

        if is_already_initialized:
            i = 0
            for kk, vehicle in enumerate(domain.vehicles):
                for customer in vehicle.customers:
                    initial_vehicle[i] = kk
                    initial_customer[i] = customer.vec_id
                    frozen[i] = customer.frozen
                    i += 1
        elif self.use_greed_init:
            demands = np.array([c.demand for c in domain.customers_vec],
                               np.int64)
            capacities = np.array([v.capacity for v in domain.vehicles],
                                  np.int64)
            depot_ids = np.array([v.depot_vec_id for v in domain.vehicles],
                                 np.int32)
            # host-side distance matrix rebuilt from coordinates: the
            # domain's matrix is a DEVICE array, and building the cotwin
            # reads nothing back from the device. The greedy init only needs
            # nearest-neighbour argmins, where sub-ulp sqrt differences vs
            # the device matrix are quality-neutral.
            xs = np.array([c.latitude for c in domain.customers_vec])
            ys = np.array([c.longitude for c in domain.customers_vec])
            d = np.sqrt((xs[:, None] - xs[None, :]) ** 2
                        + (ys[:, None] - ys[None, :]) ** 2)
            fl = np.floor(d)
            dm_host = fl + np.floor((d - fl) * 1000.0) / 1000.0
            veh, cust = greedy_init(dm_host, demands,
                                    capacities, depot_ids, n_depots)
            valid = veh >= 0
            veh, cust = veh[valid].tolist(), cust[valid].tolist()
            for i in range(min(len(veh), n_stops)):
                initial_vehicle[i] = veh[i]
                initial_customer[i] = cust[i]
        return initial_vehicle, initial_customer, frozen

    def build_cotwin(self, domain, is_already_initialized):
        n_depots = len(domain.depot_vec)
        n_locations = len(domain.customers_vec)
        n_stops = n_locations - n_depots
        k = len(domain.vehicles)

        init_v, init_c, frozen = self._initial_ids(domain, is_already_initialized)

        stops = []
        for i in range(n_stops):
            stops.append(CotStop(
                vehicle_id=GJInteger(init_v[i], 0, k - 1, frozen[i],
                                     ["vehicle_assignment", "common"]),
                customer_id=GJInteger(init_c[i], n_depots, n_locations - 1,
                                      frozen[i],
                                      ["customer_assignment", "common"]),
            ))

        fact_customers = [
            CotCustomer(c.vec_id, c.demand, c.time_window_start,
                        c.time_window_end, c.service_time)
            for c in domain.customers_vec[n_depots:]
        ]
        fact_vehicles = [
            CotVehicle(i, v.capacity, v.depot_vec_id, v.work_day_start,
                       v.work_day_end)
            for i, v in enumerate(domain.vehicles)
        ]

        cotwin = Cotwin()
        cotwin.add_problem_facts("vehicles", fact_vehicles)
        cotwin.add_problem_facts("customers", fact_customers)
        cotwin.add_planning_entities("planning_stops", stops)

        calc_cls = (
            IncrementalScoreCalculator
            if self.use_incremental_score_calculation
            else PlainScoreCalculator
        )
        calculator = calc_cls(HardMediumSoftScore)
        cust = domain.customers_vec
        calculator.add_utility_object("distance_matrix", domain.distance_matrix)
        dm_milli = routes.distance_matrix_to_milli(domain.distance_matrix)
        calculator.add_utility_object("distance_matrix_milli", dm_milli)
        calculator.add_utility_object("dm_flat_milli", dm_milli.reshape(-1))
        calculator.add_utility_object("exact_fp_scores", self.exact_fp_scores)
        # packed per-location fact rows [L, 4]: demand, tw_start, tw_end,
        # service — one sort-merge lookup replaces four gathers
        calculator.add_utility_object(
            "cust_packed",
            jnp.asarray(np.array(
                [[c.demand, c.time_window_start, c.time_window_end,
                  c.service_time] for c in cust], np.int32)))
        calculator.add_utility_object(
            "work_day_start_k",
            jnp.asarray(np.array([v.work_day_start for v in domain.vehicles],
                                 np.int32)))
        calculator.add_utility_object(
            "work_day_end_k",
            jnp.asarray(np.array([v.work_day_end for v in domain.vehicles],
                                 np.int32)))
        calculator.add_utility_object("n_locations", n_locations)
        calculator.add_utility_object("k_vehicles", k)
        calculator.add_utility_object("time_windowed", domain.time_windowed)
        calculator.add_utility_object(
            "demand_by_vec_id",
            jnp.asarray(np.array([c.demand for c in cust], np.int32)))
        calculator.add_utility_object(
            "capacities",
            jnp.asarray(np.array([v.capacity for v in domain.vehicles], np.int32)))
        calculator.add_utility_object(
            "vehicle_depot_ids",
            jnp.asarray(np.array([v.depot_vec_id for v in domain.vehicles], np.int32)))
        if domain.time_windowed:
            calculator.add_utility_object(
                "work_day_start",
                jnp.asarray(np.array([v.work_day_start for v in domain.vehicles], np.int32)))
            calculator.add_utility_object(
                "work_day_end",
                jnp.asarray(np.array([v.work_day_end for v in domain.vehicles], np.int32)))
            calculator.add_utility_object(
                "tw_start",
                jnp.asarray(np.array([c.time_window_start for c in cust], np.int32)))
            calculator.add_utility_object(
                "tw_end",
                jnp.asarray(np.array([c.time_window_end for c in cust], np.int32)))
            calculator.add_utility_object(
                "service_time",
                jnp.asarray(np.array([c.service_time for c in cust], np.int32)))

        route_cap = _route_cap(n_stops, k)
        calculator.add_utility_object("route_cap", route_cap)
        calculator.add_utility_object("n_stops", n_stops)
        # static accumulation dtype for per-route metrics: i32 (half the
        # bytes of i64, and the integer-delta rows need it) whenever
        # host-side instance bounds guarantee 4x headroom against overflow.
        # Bounds come from coordinates/facts, so building the cotwin needs
        # no device->host read of the distance matrix.
        xs = [c.latitude for c in cust]
        ys = [c.longitude for c in cust]
        dm_max_milli = int(1000.0 * (
            (max(xs) - min(xs)) ** 2 + (max(ys) - min(ys)) ** 2) ** 0.5) + 1
        dist_bound = (route_cap + 2) * dm_max_milli
        late_bound = 0
        if domain.time_windowed:
            ct_max = max(c.service_time for c in cust)
            floor_max = max(c.time_window_start + c.service_time
                            for c in cust)
            w_max = max(v.work_day_start for v in domain.vehicles)
            t_max = max(w_max, floor_max) + (route_cap + 1) * ct_max
            late_bound = (route_cap + 1) * t_max
        acc_i32 = 4 * max(dist_bound, late_bound) < 2 ** 31
        calculator.add_utility_object(
            "acc_dtype", jnp.int32 if acc_i32 else jnp.int64)
        # magnitude bounds for the sweep's f32-exact one-hot row fetches
        calculator.add_utility_object("dm_max_milli", dm_max_milli)
        calculator.add_utility_object(
            "t_max", t_max if domain.time_windowed else 0)
        calculator.add_prescoring_function("build_common", build_common)
        calculator.add_constraint("no_duplicating_stops_constraint",
                                  no_duplicating_stops_constraint)
        calculator.add_constraint("capacity_constraint", capacity_constraint)
        calculator.add_constraint("minimize_distance", minimize_distance)
        calculator.add_constraint("late_arrival_penalty", late_arrival_penalty)
        if not domain.time_windowed:
            calculator.remove_constraint("late_arrival_penalty")
        if self.use_incremental_score_calculation and not self.exact_fp_scores:
            calculator.set_delta_kernels(build_delta_ctx, score_delta,
                                         update_ctx, ctx_score=ctx_score_row,
                                         ctx_ints=ctx_int_totals,
                                         int_scales=[1.0, 1.0, 1000.0])
            calculator.set_delta_ints_kernel(score_delta_ints,
                                             delta_ints_eligible)
            from greyjack_tpu.models.vrp import sweep
            calculator.set_sweep_module(sweep)
        cotwin.add_score_calculator(calculator)
        return cotwin
