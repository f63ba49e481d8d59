"""Route-walk kernels for tour/route scoring (TSP/VRP family).

The reference walks routes with sequential per-sample Rust loops over Polars
partitions (`examples/tsp/src/score/plain_score_calculator.rs:62-87`,
`examples/vrp/src/score/incremental_score_calculator.rs:95-137`). Here a
walk is a single `lax.scan` with a vmapped (population-wide) carry: the scan
length is the number of stops, every scan step is a full-population vector
op, and all distance-matrix lookups are hoisted into one batched gather
before the scan.

Floating-point parity: the reference computes each route's distance as
``(depot_leg + return_leg) + fold(0.0, chain_legs)`` with the chain folded
left-to-right, then folds the per-vehicle totals in ascending vehicle-id
order. These kernels reproduce that exact f64 summation order (BASELINE
bit-identical score requirement). Time-window arithmetic is integer-valued,
hence order-independent.
"""

import jax
import jax.numpy as jnp


def _seq_sum(values, init=None):
    """Left-to-right sequential f64 fold, reproducing Rust `fold(0.0, +)`."""
    if init is None:
        init = jnp.zeros((), values.dtype)

    def body(acc, x):
        return acc + x, None

    total, _ = jax.lax.scan(body, init, values)
    return total


def tour_distance(stops, distance_matrix, depot=0):
    """Closed-tour distance in the reference's exact summation order.

    stops: int[N] location ids; distance_matrix: f64[L, L].
    Order (tsp `plain_score_calculator.rs:73-76`):
        (dm[depot, s0] + dm[s_last, depot]) + fold(0.0, chain_legs)
    """
    legs = distance_matrix[stops[:-1], stops[1:]]
    ends = distance_matrix[depot, stops[0]] + distance_matrix[stops[-1], depot]
    return ends + _seq_sum(legs)


def sort_stops_by_vehicle(vehicle_ids, num_vehicles=None):
    """Stable sort of stop positions by vehicle id.

    Replaces the common_df sort (sample_id, vehicle_id, index) of the VRP
    prescoring join (`vrp/score/plain_score_calculator.rs:39-45`). Returns
    (sorted_vehicle_ids, perm) with perm[i] = original stop position.
    """
    n = vehicle_ids.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    sorted_v, perm = jax.lax.sort((vehicle_ids, idx), num_keys=1, is_stable=True)
    return sorted_v, perm


def vrp_routes(
    sorted_vehicle_ids,
    sorted_customer_ids,
    distance_matrix,
    vehicle_depot_ids,
    num_vehicles,
    work_day_start=None,
    work_day_end=None,
    tw_start=None,
    tw_end=None,
    service_time=None,
):
    """Distance + (optional) time-window lateness for all routes at once.

    Inputs: stop list stably sorted by vehicle id (`sort_stops_by_vehicle`).
    Returns (sum_distance, sum_time_penalty) f64 scalars. Semantics follow
    the reference's fused all-in-one constraint
    (`vrp/score/incremental_score_calculator.rs:95-137`): arrival clamped up
    to the window start, late when `arrival + service > window_end` by
    `arrival + service - window_end`, overtime past work_day_end at route
    end. Empty vehicles contribute zero.
    """
    v = sorted_vehicle_ids
    s = sorted_customer_ids
    n = s.shape[0]
    dm = distance_matrix

    is_first = jnp.concatenate([jnp.array([True]), v[1:] != v[:-1]])
    is_last = jnp.concatenate([v[:-1] != v[1:], jnp.array([True])])

    oob = jnp.asarray(num_vehicles, v.dtype)
    first_customer = (
        jnp.zeros((num_vehicles,), s.dtype)
        .at[jnp.where(is_first, v, oob)]
        .set(s, mode="drop")
    )
    last_customer = (
        jnp.zeros((num_vehicles,), s.dtype)
        .at[jnp.where(is_last, v, oob)]
        .set(s, mode="drop")
    )
    has_stops = (
        jnp.zeros((num_vehicles,), bool)
        .at[v]
        .set(True, mode="drop")
    )

    # chain legs within a vehicle; 0 at each vehicle's first stop
    chain_leg = jnp.concatenate(
        [jnp.zeros((1,), dm.dtype), jnp.where(is_first[1:], 0.0, dm[s[:-1], s[1:]])]
    )

    if tw_start is not None:
        c_start = tw_start[s].astype(jnp.int64)
        c_end = tw_end[s].astype(jnp.int64)
        c_service = service_time[s].astype(jnp.int64)
        wds = work_day_start[v].astype(jnp.int64)
        wde = work_day_end[v].astype(jnp.int64)
    else:
        z = jnp.zeros((n,), dtype=jnp.int64)
        c_start = c_end = c_service = wds = wde = z

    def body(carry, x):
        chain_acc, arrival = carry
        first, last, leg, cs, ce, ct, w0, w1 = x
        chain_acc = jnp.where(first, leg * 0.0, chain_acc + leg)
        arrival = jnp.where(first, w0, arrival)
        arrival = jnp.maximum(arrival, cs)
        late = jnp.maximum(arrival + ct - ce, 0)
        arrival = arrival + ct
        overtime = jnp.where(last, jnp.maximum(arrival - w1, 0), 0)
        return (chain_acc, arrival), (chain_acc, late + overtime)

    xs = (is_first, is_last, chain_leg, c_start, c_end, c_service, wds, wde)
    init = (jnp.zeros((), dm.dtype), jnp.zeros((), jnp.int64))
    _, (chain_at, penalty_at) = jax.lax.scan(body, init, xs)

    chain_sum_v = (
        jnp.zeros((num_vehicles,), dm.dtype)
        .at[jnp.where(is_last, v, oob)]
        .set(chain_at, mode="drop")
    )
    ends_v = (
        dm[vehicle_depot_ids, first_customer]
        + dm[last_customer, vehicle_depot_ids]
    )
    vehicle_dist = jnp.where(has_stops, ends_v + chain_sum_v, 0.0)

    # vehicles folded in ascending id order from 0.0 (parity order,
    # `incremental_score_calculator.rs:132`)
    sum_distance = _seq_sum(vehicle_dist)
    sum_time_penalty = jnp.sum(penalty_at).astype(jnp.float64)
    return sum_distance, sum_time_penalty


def distance_matrix_to_milli(distance_matrix, precision=3):
    """Distance matrix as exact scaled integers.

    The matrices are truncated to `precision` decimals at build time
    (`tsp/persistence/domain_builder.rs:40-44`), so `d * 10^p` is an exact
    integer and integer summation is order-free — the fast route kernels sum
    in i32/i64 and divide once at the end instead of running the reference's
    sequential f64 fold.
    """
    scale = float(10 ** precision)
    return jnp.round(distance_matrix * scale).astype(jnp.int32)


def tour_distance_fast(stops, dm_milli, depot=0, precision=3, dm_at=None,
                       n_locations=None):
    """Order-free closed-tour distance over the exact integer-milli matrix.

    `dm_at` (optional): flat-index accessor `i32[...] -> i32[...]` replacing
    direct indexing — the partitioned-facts mode passes an owner-computes
    gather over a row-sharded matrix (`ops/partitioned.py`); requires
    `n_locations`. Results are bit-identical either way (integer sums)."""
    if dm_at is None:
        legs = dm_milli[stops[:-1], stops[1:]]
        ends = dm_milli[depot, stops[0]] + dm_milli[stops[-1], depot]
    else:
        l = n_locations
        legs = dm_at(stops[:-1] * l + stops[1:])
        ends = (dm_at(jnp.asarray(depot * l, stops.dtype) + stops[0])
                + dm_at(stops[-1] * l + depot))
    total = jnp.sum(legs.astype(jnp.int64)) + ends
    return total.astype(jnp.float64) / float(10 ** precision)


def _maxplus_scan(adds, floors):
    """Prefix composition of affine max-plus maps f(x) = max(x + a, u),
    log-depth. Returns the post-arrival value per position (reset maps make
    the result independent of the initial value).

    Hand-rolled Hillis–Steele doubling (log2(N) uniform full-width steps)
    instead of `lax.associative_scan`, whose recursive odd-shape slicing
    compiled very slowly for N ~ 1000 (ROADMAP Speed item 6 re-tests it).

    Runs in i32 (half the bytes of i64): the -2^30 "minus infinity" add is
    re-clamped each round so repeated reset maps cannot underflow, and
    2*neg = INT32_MIN is still representable."""
    neg = jnp.asarray(-(1 << 30), adds.dtype)
    a, u = adds, floors
    n = a.shape[-1]
    d = 1
    while d < n:
        la = jnp.concatenate([jnp.zeros_like(a[..., :d]), a[..., :-d]], axis=-1)
        lu = jnp.concatenate(
            [jnp.full_like(u[..., :d], neg), u[..., :-d]], axis=-1
        )
        a, u = jnp.maximum(la + a, neg), jnp.maximum(lu + a, u)
        d *= 2
    return jnp.maximum(a, u)


def vrp_routes_packed(
    sorted_vehicle_ids,
    sorted_customer_ids,
    dm_flat_milli,
    n_locations,
    num_vehicles,
    vehicle_depot_ids,
    work_day_start,
    work_day_end,
    cust_rows,
    time_windowed,
    precision=3,
    dm_at=None,
):
    """Scatter-free route walk.

    cust_rows: i32[N, 4] per sorted stop — [demand, tw_start, tw_end,
    service], prefetched via `join.sort_merge_lookup`. All per-vehicle
    quantities live on the stop axis: boundary stops (is_first / is_last)
    carry their vehicle's depot legs and work-day bounds via masked [N]
    gathers — no `.at[]` scatters anywhere (this function is the plain-path
    hot loop, and elementwise work fuses where scatters do not). Semantics
    identical to `vrp_routes_fast`.

    `dm_at` (optional): flat-index accessor replacing direct
    `dm_flat_milli[...]` indexing — the partitioned-facts mode passes an
    owner-computes gather over a row-sharded matrix (`ops/partitioned.py`);
    bit-identical results (integer gathers + psum of one-hot contributions).
    """
    v = sorted_vehicle_ids
    s = sorted_customer_ids
    l = n_locations
    n = s.shape[0]

    is_first = jnp.concatenate([jnp.array([True]), v[1:] != v[:-1]])
    is_last = jnp.concatenate([v[:-1] != v[1:], jnp.array([True])])

    # scatter-free formulation (the 7 per-vehicle `.at[]` scatters this
    # replaced were most of the plain-walk cost under vmap). All
    # per-vehicle quantities are re-expressed on the stop axis: the
    # boundary stop itself carries its vehicle's depot leg / work-day
    # bound via masked [N] gathers; integer sums keep bit-identical totals
    # (order-free exact milli arithmetic).
    ga = dm_at if dm_at is not None else (lambda idx: dm_flat_milli[idx])
    depot_of_stop = vehicle_depot_ids[v].astype(s.dtype)
    # ONE consolidated dm gather for chain + depot legs. Measured neutral
    # vs three separate [N] gathers at [1024, 1000] (gathers here are
    # element-throughput-bound at ~10ns/element, not fixed-cost-bound);
    # kept because one op also caps the fixed cost for SMALL populations,
    # where the per-gather overhead does dominate (scripts/bench_gather.py)
    idx3 = jnp.concatenate([
        s[:-1] * l + s[1:],                 # chain legs      [N-1]
        depot_of_stop * l + s,              # depot->first    [N]
        s * l + depot_of_stop,              # last->depot     [N]
    ])
    vals3 = ga(idx3)
    chain_vals = vals3[: n - 1]
    start_vals = vals3[n - 1: 2 * n - 1]
    return_vals = vals3[2 * n - 1:]
    chain_leg = jnp.concatenate(
        [jnp.zeros((1,), chain_vals.dtype),
         jnp.where(is_first[1:], 0, chain_vals)]
    )
    start_leg = jnp.where(is_first, start_vals, 0)
    return_leg = jnp.where(is_last, return_vals, 0)
    total_milli = (
        jnp.sum(chain_leg.astype(jnp.int64))
        + jnp.sum((start_leg + return_leg).astype(jnp.int64))
    )
    sum_distance = total_milli.astype(jnp.float64) / float(10 ** precision)

    if not time_windowed:
        return sum_distance, jnp.zeros((), jnp.float64)

    big = jnp.asarray(1 << 30, jnp.int32)
    cs = cust_rows[:, 1]
    ce = cust_rows[:, 2]
    ct = cust_rows[:, 3]
    w0_at = jnp.where(is_first, work_day_start[v].astype(jnp.int32), 0)
    w1_at = jnp.where(is_last, work_day_end[v].astype(jnp.int32), 0)

    adds = jnp.where(is_first, -big, ct)
    floors = jnp.where(is_first, jnp.maximum(w0_at, cs) + ct, cs + ct)
    post = _maxplus_scan(adds, floors)

    late = jnp.maximum(post - ce, 0)
    overtime = jnp.where(is_last, jnp.maximum(post - w1_at, 0), 0)
    sum_time_penalty = jnp.sum(
        (late + overtime).astype(jnp.int64)
    ).astype(jnp.float64)
    return sum_distance, sum_time_penalty


def vrp_routes_fast(
    sorted_vehicle_ids,
    sorted_customer_ids,
    dm_milli,
    vehicle_depot_ids,
    num_vehicles,
    precision=3,
    work_day_start=None,
    work_day_end=None,
    tw_start=None,
    tw_end=None,
    service_time=None,
):
    """Parallel equivalent of `vrp_routes`: no sequential loop.

    Distance: exact integer-milli sums (order-free; equal to the reference's
    sequential f64 fold after the standard `score_precision` truncating
    round — raw f64 may differ in the last ~couple ulps, golden-parity tests
    use the exact kernel). Lateness: the arrival recurrence
    `a = max(a, tw_start) + service` is a max-plus affine map; per-vehicle
    resets are folded in as floor-only maps and the whole walk becomes one
    log-depth `associative_scan` — integer math, bit-identical to the
    sequential walk.
    """
    v = sorted_vehicle_ids
    s = sorted_customer_ids
    oob = jnp.asarray(num_vehicles, v.dtype)

    is_first = jnp.concatenate([jnp.array([True]), v[1:] != v[:-1]])
    is_last = jnp.concatenate([v[:-1] != v[1:], jnp.array([True])])

    depot_of_stop = vehicle_depot_ids[v]
    start_leg = jnp.where(is_first, dm_milli[depot_of_stop, s], 0)
    return_leg = jnp.where(is_last, dm_milli[s, depot_of_stop], 0)
    chain_leg = jnp.concatenate(
        [jnp.zeros((1,), dm_milli.dtype),
         jnp.where(is_first[1:], 0, dm_milli[s[:-1], s[1:]])]
    )
    total_milli = jnp.sum(
        start_leg.astype(jnp.int64)
        + return_leg.astype(jnp.int64)
        + chain_leg.astype(jnp.int64)
    )
    sum_distance = total_milli.astype(jnp.float64) / float(10 ** precision)

    if tw_start is None:
        return sum_distance, jnp.zeros((), jnp.float64)

    # i32 walk (time values are far below 2^31); the penalty reduction
    # widens to i64 because 1000 stops x ~2^22 lateness can overflow i32
    big = jnp.asarray(1 << 30, jnp.int32)
    cs = tw_start[s].astype(jnp.int32)
    ce = tw_end[s].astype(jnp.int32)
    ct = service_time[s].astype(jnp.int32)
    w0 = work_day_start[v].astype(jnp.int32)
    w1 = work_day_end[v].astype(jnp.int32)

    adds = jnp.where(is_first, -big, ct)
    floors = jnp.where(is_first, jnp.maximum(w0, cs) + ct, cs + ct)
    post = _maxplus_scan(adds, floors)

    late = jnp.maximum(post - ce, 0)
    overtime = jnp.where(is_last, jnp.maximum(post - w1, 0), 0)
    sum_time_penalty = jnp.sum(
        (late + overtime).astype(jnp.int64)
    ).astype(jnp.float64)
    return sum_distance, sum_time_penalty
