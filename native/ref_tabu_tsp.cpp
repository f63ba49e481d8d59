// ref_tabu_tsp — faithful C++ re-implementation of the reference solver's
// TSP TabuSearch configuration, for head-to-head quality races (the TSP
// analog of ref_tabu.cpp; see that file's header for shared semantics).
//
// Mirrors the reference TSP example (`examples/tsp/src/main.rs:47`):
// TabuSearch(neighbours=1024, tabu_rate=0.5, move probas
// [0, .2, .2, .2, .2, .2]) over one semantic group (tour positions), each
// neighbour scored by the fused incremental rescore (fresh HashSet
// duplicate count + full tour walk,
// `examples/tsp/src/score/incremental_score_calculator.rs:31-86`).
// Moves ported from `agents/metaheuristic_bases/mover.rs`:
//   swap (179-216), swap_edges (218-278; with zero mutation rates the
//   change count clamps to 2, which the reference's rotate+swap sequence
//   makes a no-op — ported as-is), scramble (280-316: shuffle a window of
//   U{3..6}), insertion (318-375: rotate a subrange), inverse (377-421:
//   reverse a subrange). Entity tabu: FIFO of ceil(rate*n) recently
//   touched ids pushed during sampling (75-96).
//
// Input: binary instance from scripts/quality_race.py (TSP variant):
//   i32 header[8] = {0x47525453, n_stops, 0, 0, L, 0, 0, 0}
//   then i32: dm_milli[L*L], init_tour[n_stops]
// Output: JSON trajectory lines {"t", "hard", "late": 0, "dist_milli"}
// then a final record — the same score space as the JAX side.
//
// Build: g++ -O3 -march=native -std=c++17 -pthread native/ref_tabu_tsp.cpp
//        -o native/ref_tabu_tsp

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <random>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

struct Instance {
  int n, L;
  std::vector<int32_t> dm;   // [L*L] milli
  std::vector<int32_t> init; // [n]
};

bool load(const char* path, Instance& I) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  int32_t h[8];
  if (fread(h, 4, 8, f) != 8 || h[0] != 0x47525453) { fclose(f); return false; }
  I.n = h[1]; I.L = h[4];
  I.dm.resize((size_t)I.L * I.L);
  I.init.resize(I.n);
  bool ok = fread(I.dm.data(), 4, I.dm.size(), f) == I.dm.size() &&
            fread(I.init.data(), 4, I.n, f) == (size_t)I.n;
  fclose(f);
  return ok;
}

struct Score {
  int64_t hard, dist;
  bool leq(const Score& o) const {
    return hard != o.hard ? hard < o.hard : dist <= o.dist;
  }
  bool less(const Score& o) const {
    return hard != o.hard ? hard < o.hard : dist < o.dist;
  }
};

Score rescore(const Instance& I, const std::vector<int>& tour) {
  std::unordered_set<int> uniq(tour.begin(), tour.end());
  int64_t hard = (int64_t)I.n - (int64_t)uniq.size();
  int64_t d = 0;
  int L = I.L, prev = 0;
  for (int i = 0; i < I.n; i++) {
    d += I.dm[(size_t)prev * L + tour[i]];
    prev = tour[i];
  }
  d += I.dm[(size_t)prev * L + 0];
  return {hard, d};
}

struct Tabu {
  std::vector<int> ring;
  size_t cursor = 0, cap = 0;
  std::unordered_set<int> set;
  void init(size_t c) { cap = std::max<size_t>(c, 1); ring.assign(cap, -1); }
  bool contains(int id) const { return set.count(id) != 0; }
  void push(int id) {
    int old = ring[cursor];
    if (old >= 0) set.erase(old);
    ring[cursor] = id;
    set.insert(id);
    cursor = (cursor + 1) % cap;
  }
};

struct Shared {
  std::mutex mu;
  Score best{INT64_MAX, INT64_MAX};
  std::vector<int> btour;
  std::atomic<bool> stop{false};
};

void agent(const Instance& I, Shared& S, int id, int neighbours, int mig,
           uint64_t seed, std::atomic<uint64_t>& moves) {
  std::mt19937_64 rng(seed);
  int n = I.n;
  std::uniform_real_distribution<double> u01(0.0, 1.0);
  Tabu tabu;
  tabu.init((size_t)std::ceil(0.5 * n));
  auto pick = [&](int limit) {
    std::uniform_int_distribution<int> d(0, limit - 1);
    int v = d(rng);
    for (int tries = 0; tries < limit && tabu.contains(v); tries++) v = d(rng);
    tabu.push(v);
    return v;
  };

  std::vector<int> tour(I.init.begin(), I.init.end());
  Score cur = rescore(I, tour);
  { std::lock_guard<std::mutex> g(S.mu);
    if (cur.less(S.best)) { S.best = cur; S.btour = tour; } }

  uint64_t done = 0;
  std::vector<int> nt, bestt;
  for (int step = 1; !S.stop.load(std::memory_order_relaxed); step++) {
    Score best_s{INT64_MAX, INT64_MAX};
    for (int s = 0; s < neighbours; s++) {
      nt = tour;
      // move probas [0, .2, .2, .2, .2, .2] (`tsp/src/main.rs:47`)
      double u = u01(rng);
      if (u < 0.2) {                       // swap
        int a = pick(n), b = pick(n);
        std::swap(nt[a], nt[b]);
      } else if (u < 0.4) {
        // swap_edges with change count clamped to 2: the reference's
        // rotate+swap sequence cancels — a no-op neighbour (ported as-is;
        // it still consumes tabu pushes, `mover.rs:218-278`)
        (void)pick(n - 1); (void)pick(n - 1);
      } else if (u < 0.6) {                // scramble window of U{3..6}
        int cc = 3 + (int)(u01(rng) * 4.0);
        if (cc > n) cc = n;
        int start = pick(n - cc + 1);
        for (int i = cc - 1; i > 0; i--) {
          int j = (int)(u01(rng) * (i + 1));
          std::swap(nt[start + i], nt[start + j]);
        }
      } else if (u < 0.8) {                // insertion: rotate subrange
        int a = pick(n), b = pick(n);
        if (a < b) std::rotate(nt.begin() + a, nt.begin() + a + 1,
                               nt.begin() + b + 1);
        else if (a > b) std::rotate(nt.begin() + b, nt.begin() + a,
                                    nt.begin() + a + 1);
      } else {                             // inverse: reverse subrange
        int a = pick(n), b = pick(n);
        if (a > b) std::swap(a, b);
        std::reverse(nt.begin() + a, nt.begin() + b + 1);
      }
      Score sc = rescore(I, nt);
      done++;
      if (sc.less(best_s)) { best_s = sc; bestt = nt; }
    }
    if (best_s.leq(cur)) { cur = best_s; tour = bestt; }
    if (step % mig == 0) {
      std::lock_guard<std::mutex> g(S.mu);
      if (cur.less(S.best)) { S.best = cur; S.btour = tour; }
      else if (S.best.less(cur)) { cur = S.best; tour = S.btour; }
      moves.fetch_add(done, std::memory_order_relaxed);
      done = 0;
    }
  }
  moves.fetch_add(done, std::memory_order_relaxed);
}

}  // namespace

int main(int argc, char** argv) {
  const char* path = argc > 1 ? argv[1] : "instance_tsp.bin";
  double seconds = argc > 2 ? atof(argv[2]) : 60.0;
  int jobs = argc > 3 ? atoi(argv[3])
                      : (int)std::thread::hardware_concurrency();
  int neighbours = argc > 4 ? atoi(argv[4]) : 1024;
  double dt = argc > 5 ? atof(argv[5]) : 2.0;

  Instance I;
  if (!load(path, I)) { fprintf(stderr, "bad instance %s\n", path); return 1; }

  Shared S;
  std::atomic<uint64_t> moves{0};
  std::vector<std::thread> th;
  auto t0 = std::chrono::steady_clock::now();
  for (int j = 0; j < jobs; j++)
    th.emplace_back(agent, std::cref(I), std::ref(S), j, neighbours, 10,
                    777 + 13 * j, std::ref(moves));
  double next = dt;
  for (;;) {
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    double el = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0).count();
    if (el >= next) {
      Score b; { std::lock_guard<std::mutex> g(S.mu); b = S.best; }
      printf("{\"t\": %.2f, \"hard\": %lld, \"late\": 0, \"dist_milli\": "
             "%lld}\n", el, (long long)b.hard, (long long)b.dist);
      fflush(stdout);
      next += dt;
    }
    if (el >= seconds) break;
  }
  S.stop.store(true);
  for (auto& t : th) t.join();
  Score b; { std::lock_guard<std::mutex> g(S.mu); b = S.best; }
  double el = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0).count();
  printf("{\"final\": true, \"t\": %.2f, \"hard\": %lld, \"late\": 0, "
         "\"dist_milli\": %lld, \"scored_moves\": %llu, \"jobs\": %d, "
         "\"neighbours\": %d}\n", el, (long long)b.hard, (long long)b.dist,
         (unsigned long long)moves.load(), jobs, neighbours);
  return 0;
}
