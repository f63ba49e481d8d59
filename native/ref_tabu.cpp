// ref_tabu — a faithful C++ re-implementation of the reference solver's
// TabuSearch agent loop, for head-to-head QUALITY races against the JAX
// solver on identical instances (VERDICT r3 item 3).
//
// Semantics mirrored from the reference (greyjack-solver-rust):
//   * agent loop: population 1, sample `neighbours_count` independent
//     moves off the current best, accept the best neighbour iff <= current
//     (`agents/metaheuristic_bases/tabu_search_base.rs:80-199`);
//   * moves: change / swap chosen by cumulative probabilities over a
//     uniformly-drawn semantic group (vehicle_assignment /
//     customer_assignment / common), values clamped to the target
//     variable's own bounds (`mover.rs:36-62,98-177,179-216`;
//     `variables_manager.rs:187-220`);
//   * entity tabu: per-group FIFO of recently-touched ids, size
//     ceil(rate*len), ids pushed during SAMPLING (`mover.rs:75-96`);
//   * incremental scoring: clone base, patch deltas, full fused rescore
//     (duplicates hash-set + demand re-accumulation + fresh per-vehicle
//     stop lists + distance / time-window walks) — the reference's own
//     "pseudo-incremental" path
//     (`examples/vrp/src/score/incremental_score_calculator.rs:55-139`);
//   * islands: n_jobs agents; every migration_frequency steps an agent
//     offers its best over a ring and adopts an incoming migrant iff <=
//     current (`agent_base.rs:161-183,429-434`); a mutex-guarded global
//     best is adopted when strictly better (`agent_base.rs:446-490`).
// Divergences (documented): ring handshakes are non-blocking mailboxes
// (no deadlock-parity needed for a quality race); RNG is mt19937 instead
// of OS entropy (the reference is non-reproducible by design, SURVEY §5).
//
// Scores are exact integers — hard = 1000*dups + capacity overflow,
// medium = lateness, soft = distance in milli units — the same integer
// semantics as the JAX solver, so trajectories are directly comparable.
//
// Input: flat binary instance written by scripts/quality_race.py:
//   i32 header[8] = {0x47524a54, n_stops, n_depots, k, L, tw, 0, 0}
//   then i32 arrays: dm_milli[L*L], demand[L], tws[L], twe[L], service[L],
//   cap[K], ws[K], we[K], depot[K], init_veh[N], init_cust[N]
// Output: one JSON trajectory sample per line {"t": s, "hard": h,
//   "late": m, "dist_milli": d}, then a final {"final": ...} record.
//
// Build: g++ -O3 -march=native -std=c++17 -pthread native/ref_tabu.cpp
//        -o native/ref_tabu

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

struct Instance {
  int n, nd, k, L, tw;
  std::vector<int32_t> dm;                      // [L*L] milli
  std::vector<int32_t> demand, tws, twe, srv;   // [L]
  std::vector<int32_t> cap, ws, we, depot;      // [K]
  std::vector<int32_t> iv, ic;                  // [N]
};

bool load(const char* path, Instance& I) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  int32_t h[8];
  if (fread(h, 4, 8, f) != 8 || h[0] != 0x47524a54) { fclose(f); return false; }
  I.n = h[1]; I.nd = h[2]; I.k = h[3]; I.L = h[4]; I.tw = h[5];
  auto rd = [&](std::vector<int32_t>& v, size_t c) {
    v.resize(c);
    return fread(v.data(), 4, c, f) == c;
  };
  size_t L = I.L;
  bool ok = rd(I.dm, L * L) && rd(I.demand, L) && rd(I.tws, L) &&
            rd(I.twe, L) && rd(I.srv, L) && rd(I.cap, I.k) && rd(I.ws, I.k) &&
            rd(I.we, I.k) && rd(I.depot, I.k) && rd(I.iv, I.n) &&
            rd(I.ic, I.n);
  fclose(f);
  return ok;
}

struct Score {
  int64_t hard, late, dist;
  bool leq(const Score& o) const {
    if (hard != o.hard) return hard < o.hard;
    if (late != o.late) return late < o.late;
    return dist <= o.dist;
  }
  bool less(const Score& o) const {
    if (hard != o.hard) return hard < o.hard;
    if (late != o.late) return late < o.late;
    return dist < o.dist;
  }
};

// the reference's fused incremental rescore, integer form
Score rescore(const Instance& I, const std::vector<int>& veh,
              const std::vector<int>& cust) {
  int k = I.k, n = I.n, L = I.L;
  std::unordered_set<int> uniq(cust.begin(), cust.end());
  int64_t hard = 1000ll * (n - (int64_t)uniq.size());
  std::vector<int64_t> loads(k, 0);
  for (int i = 0; i < n; i++) loads[veh[i]] += I.demand[cust[i]];
  for (int v = 0; v < k; v++)
    if (loads[v] > I.cap[v]) hard += loads[v] - I.cap[v];
  static thread_local std::vector<std::vector<int>> stops;
  stops.assign(k, {});
  for (int i = 0; i < n; i++) stops[veh[i]].push_back(cust[i]);
  int64_t dist = 0, late = 0;
  for (int v = 0; v < k; v++) {
    const auto& s = stops[v];
    if (s.empty()) continue;
    int dep = I.depot[v];
    int64_t d = I.dm[(size_t)dep * L + s[0]] + I.dm[(size_t)s.back() * L + dep];
    for (size_t i = 1; i < s.size(); i++)
      d += I.dm[(size_t)s[i - 1] * L + s[i]];
    dist += d;
    if (I.tw) {
      int64_t arr = I.ws[v];
      for (size_t i = 0; i < s.size(); i++) {
        arr = std::max<int64_t>(arr, I.tws[s[i]]);
        int64_t done = arr + I.srv[s[i]];
        if (done > I.twe[s[i]]) late += done - I.twe[s[i]];
        arr = done;
      }
      if (arr > I.we[v]) late += arr - I.we[v];
    }
  }
  return {hard, late, dist};
}

// per-group FIFO entity tabu (`mover.rs:75-96`)
struct Tabu {
  std::vector<int> ring;
  size_t cursor = 0, size = 0, cap = 0;
  std::unordered_set<int> set;
  void init(size_t c) { cap = std::max<size_t>(c, 1); ring.assign(cap, -1); }
  bool contains(int id) const { return set.count(id) != 0; }
  void push(int id) {
    if (cap == 0) return;
    int old = ring[cursor];
    if (old >= 0) set.erase(old);
    ring[cursor] = id;
    set.insert(id);
    cursor = (cursor + 1) % cap;
  }
};

struct Shared {
  std::mutex mu;
  Score best{INT64_MAX, INT64_MAX, INT64_MAX};
  std::vector<int> bveh, bcust;
  std::vector<std::mutex> box_mu;
  std::vector<Score> box_score;
  std::vector<std::vector<int>> box_veh, box_cust;
  std::vector<char> box_full;
  std::atomic<bool> stop{false};
  Shared(int j) : box_mu(j), box_score(j), box_veh(j), box_cust(j),
                  box_full(j, 0) {}
};

void agent(const Instance& I, Shared& S, int id, int jobs, int neighbours,
           int mig_freq, double tabu_rate, uint64_t seed,
           std::atomic<uint64_t>& moves) {
  std::mt19937_64 rng(seed);
  int n = I.n;
  // semantic groups over flat var ids: [0,n) = vehicle vars, [n,2n) =
  // customer vars, common = both (`persistence/cotwin_builder.rs:123-137`)
  // group pick is uniform over the map (`variables_manager.rs:108-113`)
  std::uniform_int_distribution<int> gdraw(0, 2);
  std::uniform_real_distribution<double> u01(0.0, 1.0);
  std::uniform_int_distribution<int> vdraw(0, I.k - 1);
  std::uniform_int_distribution<int> cdraw(I.nd, I.L - 1);

  Tabu tabu[3];
  double rate = tabu_rate;
  tabu[0].init((size_t)std::ceil(rate * n));
  tabu[1].init((size_t)std::ceil(rate * n));
  tabu[2].init((size_t)std::ceil(rate * 2 * n));

  std::vector<int> veh(I.iv.begin(), I.iv.end());
  std::vector<int> cust(I.ic.begin(), I.ic.end());
  Score cur = rescore(I, veh, cust);
  {
    std::lock_guard<std::mutex> g(S.mu);
    if (cur.less(S.best)) { S.best = cur; S.bveh = veh; S.bcust = cust; }
  }

  auto pick_var = [&](int group) {
    // select_non_tabu_ids: retry until non-tabu, then push (`mover.rs:75-96`)
    int glen = group == 2 ? 2 * n : n;
    std::uniform_int_distribution<int> d(0, glen - 1);
    int v = d(rng);
    for (int tries = 0; tries < glen && tabu[group].contains(v); tries++)
      v = d(rng);
    tabu[group].push(v);
    if (group == 1) return n + v;  // customer group -> flat id offset
    return v;                       // vehicle group / common are flat
  };
  auto resample = [&](int flat) {
    return flat < n ? vdraw(rng) : cdraw(rng);
  };
  auto clampv = [&](int flat, int value) {
    if (flat < n) return std::min(std::max(value, 0), I.k - 1);
    return std::min(std::max(value, I.nd), I.L - 1);
  };
  auto get = [&](const std::vector<int>& v, const std::vector<int>& c,
                 int flat) { return flat < n ? v[flat] : c[flat - n]; };
  auto set = [&](std::vector<int>& v, std::vector<int>& c, int flat,
                 int value) {
    if (flat < n) v[flat] = value; else c[flat - n] = value;
  };

  uint64_t done = 0;
  std::vector<int> nv, nc, bestv, bestc;
  for (int step = 1; !S.stop.load(std::memory_order_relaxed); step++) {
    Score best_s{INT64_MAX, INT64_MAX, INT64_MAX};
    for (int s = 0; s < neighbours; s++) {
      nv = veh; nc = cust;
      int g = gdraw(rng);
      bool swap = u01(rng) >= 0.5;  // move_probas [0.5, 0.5, 0, 0, 0, 0]
      if (!swap) {
        int p = pick_var(g);
        set(nv, nc, p, clampv(p, resample(p)));
      } else {
        int p1 = pick_var(g), p2 = pick_var(g);
        int a = get(nv, nc, p1), b = get(nv, nc, p2);
        set(nv, nc, p1, clampv(p1, b));
        set(nv, nc, p2, clampv(p2, a));
      }
      Score sc = rescore(I, nv, nc);
      done++;
      if (sc.less(best_s)) { best_s = sc; bestv = nv; bestc = nc; }
    }
    if (best_s.leq(cur)) { cur = best_s; veh = bestv; cust = bestc; }

    if (step % mig_freq == 0) {
      // ring send to (id+1) % jobs, receive own mailbox
      int to = (id + 1) % jobs;
      {
        std::lock_guard<std::mutex> g(S.box_mu[to]);
        S.box_score[to] = cur; S.box_veh[to] = veh; S.box_cust[to] = cust;
        S.box_full[to] = 1;
      }
      {
        std::lock_guard<std::mutex> g(S.box_mu[id]);
        if (S.box_full[id] && S.box_score[id].leq(cur)) {
          cur = S.box_score[id]; veh = S.box_veh[id]; cust = S.box_cust[id];
        }
        S.box_full[id] = 0;
      }
      std::lock_guard<std::mutex> g(S.mu);
      if (cur.less(S.best)) { S.best = cur; S.bveh = veh; S.bcust = cust; }
      else if (S.best.less(cur)) {  // compare_to_global adoption
        cur = S.best; veh = S.bveh; cust = S.bcust;
      }
      moves.fetch_add(done, std::memory_order_relaxed);
      done = 0;
    }
  }
  moves.fetch_add(done, std::memory_order_relaxed);
}

}  // namespace

int main(int argc, char** argv) {
  const char* path = argc > 1 ? argv[1] : "instance.bin";
  double seconds = argc > 2 ? atof(argv[2]) : 60.0;
  int jobs = argc > 3 ? atoi(argv[3])
                      : (int)std::thread::hardware_concurrency();
  int neighbours = argc > 4 ? atoi(argv[4]) : 20;
  int mig_freq = argc > 5 ? atoi(argv[5]) : 10;
  double sample_dt = argc > 6 ? atof(argv[6]) : 1.0;

  Instance I;
  if (!load(path, I)) { fprintf(stderr, "bad instance %s\n", path); return 1; }

  Shared S(jobs);
  std::atomic<uint64_t> moves{0};
  std::vector<std::thread> threads;
  auto t0 = std::chrono::steady_clock::now();
  for (int j = 0; j < jobs; j++)
    threads.emplace_back(agent, std::cref(I), std::ref(S), j, jobs,
                         neighbours, mig_freq, 0.2, 1234 + 7 * j,
                         std::ref(moves));
  double next = sample_dt;
  for (;;) {
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    double el = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0).count();
    if (el >= next) {
      Score b;
      { std::lock_guard<std::mutex> g(S.mu); b = S.best; }
      printf("{\"t\": %.2f, \"hard\": %lld, \"late\": %lld, "
             "\"dist_milli\": %lld}\n", el, (long long)b.hard,
             (long long)b.late, (long long)b.dist);
      fflush(stdout);
      next += sample_dt;
    }
    if (el >= seconds) break;
  }
  S.stop.store(true);
  for (auto& th : threads) th.join();
  double el = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0).count();
  Score b;
  { std::lock_guard<std::mutex> g(S.mu); b = S.best; }
  printf("{\"final\": true, \"t\": %.2f, \"hard\": %lld, \"late\": %lld, "
         "\"dist_milli\": %lld, \"scored_moves\": %llu, \"jobs\": %d, "
         "\"neighbours\": %d}\n", el, (long long)b.hard, (long long)b.late,
         (long long)b.dist, (unsigned long long)moves.load(), jobs,
         neighbours);
  return 0;
}
