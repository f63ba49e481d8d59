"""TSP cotwin + device score kernels.

Reference: `examples/tsp/src/persistence/cotwin_builder.rs`
(one GJInteger location id per stop, bounds 1..L-1, greedy nearest-neighbour
init) and `score/plain_score_calculator.rs:26-87` / the fused
`all_in_one_constraint` (`incremental_score_calculator.rs:31-86`): hard =
duplicate stops, soft = tour distance. The greedy init runs on device as a
`lax.scan` over masked argmin (the reference's host loop,
`cotwin_builder.rs:139-168`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from greyjack_tpu.cotwin import Cotwin, CotwinBuilderBase
from greyjack_tpu.variables import GJInteger
from greyjack_tpu.score_calculation.scores import HardSoftScore
from greyjack_tpu.score_calculation.score_calculators import (
    PlainScoreCalculator,
    IncrementalScoreCalculator,
)
from greyjack_tpu.ops import segments, routes, moves


class CotStop:
    def __init__(self, stop_id, locations_vec_id):
        self.stop_id = stop_id
        self.locations_vec_id = locations_vec_id

    def to_vec(self):
        return [
            ("stop_id", self.stop_id),
            ("locations_vec_id", self.locations_vec_id),
        ]


def greedy_tour(dm):
    """Nearest-neighbour tour from the depot (location 0), HOST-side numpy.

    Init runs once, off the hot path — exactly where the reference computes
    it (`cotwin_builder.rs:139-168`). The round-1 `lax.scan` formulation is
    gone: an O(L)-length scan is one long serial device loop, while the
    numpy loop takes milliseconds and keeps the device free for solving.
    Returns int32[L-1] location ids.
    """
    dm = np.asarray(dm)
    l = dm.shape[0]
    visited = np.zeros((l,), bool)
    visited[0] = True
    tour = np.empty((l - 1,), np.int32)
    prev = 0
    inf = np.inf
    for i in range(l - 1):
        d = np.where(visited, inf, dm[prev])
        nxt = int(np.argmin(d))
        visited[nxt] = True
        tour[i] = nxt
        prev = nxt
    return tour


def no_duplicating_stops_constraint(planning, facts, utils):
    stops = planning["path_stops"]["locations_vec_id"]
    n_locations = utils["n_locations"]
    hard = segments.count_minus_n_unique(stops, n_locations)
    return (hard, jnp.zeros((), jnp.float64))


def minimize_distance(planning, facts, utils):
    stops = planning["path_stops"]["locations_vec_id"]
    if utils["exact_fp_scores"]:
        soft = routes.tour_distance(stops, utils["distance_matrix"], depot=0)
    else:
        soft = routes.tour_distance_fast(stops, utils["distance_matrix_milli"],
                                         depot=0, dm_at=utils.get("dm_at"),
                                         n_locations=utils["n_locations"])
    return (jnp.zeros((), jnp.float64), soft)


# --- delta (incremental) kernels ---------------------------------------------

def build_delta_ctx(planning, facts, utils):
    """O(N) base pass for delta scoring: tour values, value histogram, per-leg
    distances (integer milli, so delta sums are exact and drift-free), base
    score components. The array analog of the reference ISC's base candidate df
    (`oop_score_requester.rs:443-463`)."""
    s = planning["path_stops"]["locations_vec_id"]
    l = utils["n_locations"]
    dmf = utils["dm_flat_milli"]
    n = s.shape[0]
    counts = jnp.zeros((l,), jnp.int32).at[s].add(1)
    # legs[i] joins position i-1 -> i; positions -1 and n are the depot (0)
    sl = jnp.concatenate([jnp.zeros((1,), s.dtype), s])
    sr = jnp.concatenate([s, jnp.zeros((1,), s.dtype)])
    legs = dmf[sl * l + sr]  # [N+1]
    soft_milli = jnp.sum(legs.astype(jnp.int64))
    hard = (n - jnp.sum(counts > 0)).astype(jnp.int32)
    return {"s": s, "counts": counts, "legs": legs,
            "hard": hard, "soft_milli": soft_milli}


def _delta_parts(ctx, delta, utils):
    """Shared O(K) analysis of one delta: changed rows, affected legs, exact
    n_unique and distance deltas."""
    delta = moves.dedupe_delta(delta)
    l = utils["n_locations"]
    dmf = utils["dm_flat_milli"]
    s = ctx["s"]
    n = s.shape[0]
    rows = utils["delta_schema"]["var_row"][delta["positions"]]
    valid = delta["valid"]
    nv = jnp.round(delta["values"]).astype(jnp.int32)
    old = s[rows]

    d_unique = segments.nunique_delta(
        ctx["counts"], jnp.where(valid, old, 0), jnp.where(valid, nv, 0),
        valid)

    # affected legs: rows and rows+1, deduped after sorting
    sent = jnp.asarray(n + 1, jnp.int32)
    legids = jnp.concatenate([jnp.where(valid, rows, sent),
                              jnp.where(valid, rows + 1, sent)])
    sortedl = jnp.sort(legids)
    lfirst = jnp.concatenate(
        [jnp.ones((1,), bool), sortedl[1:] != sortedl[:-1]])
    lvalid = lfirst & (sortedl <= n)
    old_leg = ctx["legs"][jnp.minimum(sortedl, n)]

    def patched(j):
        # tour value at position j after the patch; depot at j=-1 / j=n
        base_val = jnp.where((j < 0) | (j >= n), 0, s[jnp.clip(j, 0, n - 1)])
        match = (rows[None, :] == j[:, None]) & valid[None, :]
        pick = nv[jnp.argmax(match, axis=1)]
        return jnp.where(jnp.any(match, axis=1), pick, base_val)

    u = patched(sortedl - 1)
    w = patched(sortedl)
    new_leg = dmf[jnp.clip(u * l + w, 0, l * l - 1)]
    d_soft = jnp.sum(
        jnp.where(lvalid, (new_leg - old_leg).astype(jnp.int64), 0))
    return {"rows": rows, "valid": valid, "nv": nv, "old": old,
            "leg_ids": sortedl, "leg_valid": lvalid, "new_leg": new_leg,
            "d_unique": d_unique, "d_soft": d_soft}


def score_delta(ctx, delta, utils):
    """O(K) neighbour score: exact n_unique delta via the base histogram +
    distance delta over the <=2K affected legs. Matches the full rescore of
    the patched tour bit-for-bit (fast-path integer-milli semantics)."""
    p = _delta_parts(ctx, delta, utils)
    hard = (ctx["hard"] - p["d_unique"]).astype(jnp.float64)
    soft = (ctx["soft_milli"] + p["d_soft"]).astype(jnp.float64) / 1000.0
    return jnp.stack([hard, soft])


def ctx_score_row(ctx, utils):
    """f64[2] score of the ctx's base candidate from its exact sums (the
    local-search int-accept / sweep paths materialize f64 only here)."""
    return jnp.stack([ctx["hard"].astype(jnp.float64),
                      ctx["soft_milli"].astype(jnp.float64) / 1000.0])


def ctx_int_totals(ctx, utils):
    """i64[2] exact integer totals (hard count, distance milli) — with
    int_scales [1, 1000] this reproduces `ctx_score_row` bit-for-bit and
    keeps the sweep fast path live under the reference's shipped
    `score_precision=[3,3]` TSP config (`examples/tsp/src/main.rs:56`)."""
    return jnp.stack([ctx["hard"].astype(jnp.int64),
                      ctx["soft_milli"].astype(jnp.int64)])


def update_ctx(ctx, delta, utils):
    """Apply an accepted delta to the base ctx in O(K) scatters (a delta with
    no valid entries is the identity)."""
    p = _delta_parts(ctx, delta, utils)
    l = utils["n_locations"]
    n = ctx["s"].shape[0]
    drop_row = jnp.where(p["valid"], p["rows"], n)
    s2 = ctx["s"].at[drop_row].set(p["nv"], mode="drop")
    counts2 = (
        ctx["counts"]
        .at[jnp.where(p["valid"], p["old"], l)].add(-1, mode="drop")
        .at[jnp.where(p["valid"], p["nv"], l)].add(1, mode="drop")
    )
    legs2 = ctx["legs"].at[
        jnp.where(p["leg_valid"], p["leg_ids"], n + 1)
    ].set(p["new_leg"], mode="drop")
    return {"s": s2, "counts": counts2, "legs": legs2,
            "hard": ctx["hard"] - p["d_unique"],
            "soft_milli": ctx["soft_milli"] + p["d_soft"]}


class CotwinBuilder(CotwinBuilderBase):
    def __init__(self, use_incremental_score_calculation=True,
                 use_greed_init=True, exact_fp_scores=False):
        self.use_incremental_score_calculation = use_incremental_score_calculation
        self.use_greed_init = use_greed_init
        self.exact_fp_scores = exact_fp_scores

    def build_cotwin(self, domain, is_already_initialized):
        n_locations = len(domain.locations_vec)
        n_stops = n_locations - 1

        if is_already_initialized and domain.trip_path:
            initial_ids = [int(i) for i in domain.trip_path]
        elif self.use_greed_init:
            # host-side matrix rebuild: the domain's matrix is a device
            # array, and building the cotwin reads nothing back from it
            xs = np.array([lc.latitude for lc in domain.locations_vec])
            ys = np.array([lc.longitude for lc in domain.locations_vec])
            dm_host = np.sqrt((xs[:, None] - xs[None, :]) ** 2
                              + (ys[:, None] - ys[None, :]) ** 2)
            initial_ids = np.asarray(greedy_tour(dm_host)).tolist()
        else:
            initial_ids = [i + 1 for i in range(n_stops)]

        stops = []
        for i in range(n_stops):
            stops.append(
                CotStop(
                    stop_id=i,
                    locations_vec_id=GJInteger(initial_ids[i], 1,
                                               n_locations - 1, False, None),
                )
            )

        cotwin = Cotwin()
        cotwin.add_planning_entities("path_stops", stops)

        calc_cls = (
            IncrementalScoreCalculator
            if self.use_incremental_score_calculation
            else PlainScoreCalculator
        )
        calculator = calc_cls(HardSoftScore)
        calculator.add_utility_object("distance_matrix", domain.distance_matrix)
        dm_milli = routes.distance_matrix_to_milli(domain.distance_matrix)
        calculator.add_utility_object("distance_matrix_milli", dm_milli)
        calculator.add_utility_object("dm_flat_milli", dm_milli.reshape(-1))
        calculator.add_utility_object("exact_fp_scores", self.exact_fp_scores)
        calculator.add_utility_object("n_locations", n_locations)
        # magnitude bound for the sweep module's f32-exact one-hot matmuls
        # (host-side from coordinates — no device reads at build time)
        xs = [lc.latitude for lc in domain.locations_vec]
        ys = [lc.longitude for lc in domain.locations_vec]
        calculator.add_utility_object(
            "dm_max_milli",
            int(1000.0 * ((max(xs) - min(xs)) ** 2
                          + (max(ys) - min(ys)) ** 2) ** 0.5) + 1)
        calculator.add_constraint("no_duplicating_stops_constraint",
                                  no_duplicating_stops_constraint)
        calculator.add_constraint("minimize_distance", minimize_distance)
        if self.use_incremental_score_calculation and not self.exact_fp_scores:
            calculator.set_delta_kernels(build_delta_ctx, score_delta,
                                         update_ctx, ctx_score=ctx_score_row,
                                         ctx_ints=ctx_int_totals,
                                         int_scales=[1.0, 1000.0])
            from greyjack_tpu.models.tsp import sweep
            calculator.set_sweep_module(sweep)
        cotwin.add_score_calculator(calculator)
        return cotwin
