"""Measure the reference-equivalent CPU rescore throughput on this machine
and persist it as BASELINE_CPU.json for bench.py's `vs_baseline`.

Builds native/cpu_baseline.cpp (a faithful C++ port of the reference's fused
incremental VRP rescore driven TabuSearch-style — see the .cpp header for
the per-move work list and the generosity caveats), runs it on all local
cores, and extrapolates to the 64-thread target of BASELINE.json using the
reference's own "nearly linear horizontal scaling" claim
(`README.md:22`).

Run: python scripts/measure_cpu_baseline.py [seconds]
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "native", "cpu_baseline.cpp")
BIN = os.path.join(ROOT, "native", "cpu_baseline")
OUT = os.path.join(ROOT, "BASELINE_CPU.json")


def main():
    seconds = sys.argv[1] if len(sys.argv) > 1 else "10"
    if (not os.path.exists(BIN)
            or os.path.getmtime(BIN) < os.path.getmtime(SRC)):
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-pthread",
             SRC, "-o", BIN],
            check=True)
    res = subprocess.run([BIN, "1000", "40", seconds],
                         capture_output=True, text=True, check=True)
    m = json.loads(res.stdout)
    per_thread = m["moves_per_s_per_thread"]
    record = {
        "measured": m,
        "moves_per_s_64t": round(per_thread * 64, 1),
        "method": "native/cpu_baseline.cpp — reference fused incremental "
                  "VRP rescore (incremental_score_calculator.rs:55-139), "
                  "TabuSearch neighbour loop, n=1000 k=40; per-thread "
                  "throughput x 64 via the reference's near-linear scaling "
                  "claim (README.md:22). Polars/channel overhead excluded "
                  "(generous to the reference).",
    }
    with open(OUT, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
