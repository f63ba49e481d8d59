// cpu_baseline — measured CPU reference point for BASELINE.md's
// ">=100x a 64-thread CPU run" target.
//
// The reference publishes no throughput numbers (README.md:49), so this
// binary measures a faithful C++ re-implementation of the hot loop the
// target refers to: the fused incremental VRP rescore
// (`examples/vrp/src/score/incremental_score_calculator.rs:55-139`)
// driven the way TabuSearch drives it (`tabu_search_base.rs:107-188`):
// per scored move, the reference
//   * clones the full candidate vehicle/customer id vectors,
//   * patches the delta rows in,
//   * rebuilds a fresh HashSet for the duplicate-stop count,
//   * re-accumulates per-vehicle demands,
//   * rebuilds fresh per-vehicle stop lists (Vec<Vec<usize>>),
//   * re-walks every route for distance + time-window lateness.
// This measurement is GENEROUS to the reference: it strips all Polars
// DataFrame construction, partition_by and channel overhead that the real
// solver pays around this loop, and it counts pure rescore throughput.
//
// Output: one JSON line
//   {"threads": T, "n": N, "k": K, "moves_per_s": X, "moves_per_s_per_thread": Y}
// The 64-thread baseline = Y * 64 (the README claims "nearly linear
// horizontal scaling", README.md:22; taking it at its word is again
// generous to the reference).
//
// Build: g++ -O3 -march=native -std=c++17 -pthread native/cpu_baseline.cpp
//        -o native/cpu_baseline

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

struct Instance {
  int n_stops, k_vehicles, n_locations, n_depots;
  std::vector<double> dm;  // [L*L]
  std::vector<uint64_t> demand, tw_start, tw_end, service;  // [L]
  std::vector<uint64_t> capacity, work_start, work_end;     // [K]
  std::vector<int> depot_of;                                // [K]
};

Instance make_instance(int n_stops, int n_depots, int k) {
  Instance ins;
  ins.n_stops = n_stops;
  ins.n_depots = n_depots;
  ins.k_vehicles = k;
  ins.n_locations = n_stops + n_depots;
  int L = ins.n_locations;
  std::mt19937_64 rng(37);
  std::uniform_real_distribution<double> coord(0.0, 100.0);
  std::vector<double> xs(L), ys(L);
  for (int i = 0; i < L; i++) { xs[i] = coord(rng); ys[i] = coord(rng); }
  ins.dm.resize((size_t)L * L);
  for (int i = 0; i < L; i++)
    for (int j = 0; j < L; j++) {
      double dx = xs[i] - xs[j], dy = ys[i] - ys[j];
      // 3-decimal truncation like the reference's domain builder
      ins.dm[(size_t)i * L + j] =
          std::floor(std::sqrt(dx * dx + dy * dy) * 1000.0) / 1000.0;
    }
  ins.demand.assign(L, 0);
  ins.tw_start.assign(L, 0);
  ins.tw_end.assign(L, 0);
  ins.service.assign(L, 0);
  std::uniform_int_distribution<uint64_t> dem(1, 10), st(0, 10000),
      wid(100, 2000), srv(5, 30);
  for (int i = n_depots; i < L; i++) {
    ins.demand[i] = dem(rng);
    ins.tw_start[i] = st(rng);
    ins.tw_end[i] = ins.tw_start[i] + wid(rng);
    ins.service[i] = srv(rng);
  }
  ins.capacity.assign(k, (uint64_t)(n_stops / k * 6 + 10));
  ins.work_start.assign(k, 0);
  ins.work_end.assign(k, 12000);
  ins.depot_of.resize(k);
  for (int v = 0; v < k; v++) ins.depot_of[v] = v % n_depots;
  return ins;
}

// One full rescore, mirroring all_in_one_constraint line for line.
double rescore(const Instance& ins, const std::vector<int>& veh,
               const std::vector<int>& cust) {
  int k = ins.k_vehicles, n = ins.n_stops, L = ins.n_locations;
  // no_duplicating_stops_constraint (fresh HashSet per move, rs:75-76)
  std::unordered_set<int> uniq(cust.begin(), cust.end());
  double hard = 1000.0 * (double)(n - (int)uniq.size());
  // capacity_constraint (rs:79-85)
  std::vector<uint64_t> loads(k, 0);
  for (int i = 0; i < n; i++) loads[veh[i]] += ins.demand[cust[i]];
  int64_t cap_pen = 0;
  for (int v = 0; v < k; v++) {
    int64_t diff = (int64_t)ins.capacity[v] - (int64_t)loads[v];
    if (diff < 0) cap_pen += -diff;
  }
  hard += (double)cap_pen;
  // fresh per-vehicle stop lists (rs:88-93)
  std::vector<std::vector<int>> stops(k);
  for (int i = 0; i < n; i++) stops[veh[i]].push_back(cust[i]);
  // distance + lateness walks (rs:95-130)
  double dist = 0.0, late = 0.0;
  for (int v = 0; v < k; v++) {
    const auto& s = stops[v];
    if (s.empty()) continue;
    int depot = ins.depot_of[v];
    double d = ins.dm[(size_t)depot * L + s[0]] +
               ins.dm[(size_t)s.back() * L + depot];
    for (size_t i = 1; i < s.size(); i++)
      d += ins.dm[(size_t)s[i - 1] * L + s[i]];
    dist += d;
    uint64_t arrival = ins.work_start[v];
    for (size_t i = 0; i < s.size(); i++) {
      arrival = std::max(arrival, ins.tw_start[s[i]]);
      uint64_t done = arrival + ins.service[s[i]];
      if (done > ins.tw_end[s[i]]) late += (double)(done - ins.tw_end[s[i]]);
      arrival = done;
    }
    if (arrival > ins.work_end[v]) late += (double)(arrival - ins.work_end[v]);
  }
  return hard + late + dist;  // fold so nothing is optimized away
}

}  // namespace

int main(int argc, char** argv) {
  int n_stops = argc > 1 ? atoi(argv[1]) : 1000;
  int k = argc > 2 ? atoi(argv[2]) : 40;
  int n_depots = 8;
  double seconds = argc > 3 ? atof(argv[3]) : 5.0;
  unsigned T = std::thread::hardware_concurrency();

  Instance ins = make_instance(n_stops, n_depots, k);

  std::vector<uint64_t> counts((size_t)T, 0);
  std::vector<double> sinks((size_t)T, 0.0);
  auto t0 = std::chrono::steady_clock::now();
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < T; t++) {
    threads.emplace_back([&, t]() {
      std::mt19937_64 rng(1234 + t);
      std::uniform_int_distribution<int> pos(0, n_stops - 1);
      std::uniform_int_distribution<int> vdraw(0, k - 1);
      std::uniform_int_distribution<int> cdraw(n_depots,
                                               ins.n_locations - 1);
      // base candidate
      std::vector<int> bveh(n_stops), bcust(n_stops);
      for (int i = 0; i < n_stops; i++) {
        bveh[i] = vdraw(rng);
        bcust[i] = cdraw(rng);
      }
      double sink = 0.0;
      uint64_t done = 0;
      for (;;) {
        // one TabuSearch incremental neighbour: clone + 2-var delta patch
        // (tabu_search_base.rs:107-137: every neighbour is base + deltas)
        std::vector<int> veh(bveh), cust(bcust);
        int p1 = pos(rng), p2 = pos(rng);
        veh[p1] = vdraw(rng);
        cust[p2] = cdraw(rng);
        sink += rescore(ins, veh, cust);
        done++;
        if ((done & 1023) == 0) {
          auto el = std::chrono::duration<double>(
                        std::chrono::steady_clock::now() - t0)
                        .count();
          if (el > seconds) break;
        }
      }
      counts[t] = done;
      sinks[t] = sink;
    });
  }
  for (auto& th : threads) th.join();
  double elapsed =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
          .count();
  uint64_t total = 0;
  double sink = 0;
  for (unsigned t = 0; t < T; t++) { total += counts[t]; sink += sinks[t]; }
  double mps = (double)total / elapsed;
  printf(
      "{\"threads\": %u, \"n\": %d, \"k\": %d, \"moves_per_s\": %.1f, "
      "\"moves_per_s_per_thread\": %.1f, \"sink\": %.3g}\n",
      T, n_stops, k, mps, mps / T, sink);
  return 0;
}
