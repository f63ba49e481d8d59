"""VRP with sweep neighbourhoods — the flagship configuration.

Instead of `neighbours_count` random moves per step, the sweep mode scores
EVERY candidate value for `sweep_targets` sampled stops (change /
vehicle-reassignment / cross-route-swap families) from per-position route
cumulants — about 2.0G candidate scores per second on one H100 at the
n=1000 flagship geometry, 8 islands x 256 targets (PERF.md). Accept
semantics are the reference's accept-best-iff-<=
(`tabu_search_base.rs:139-155`); the
random-move configuration of `vrp_example.py` remains available for
scramble/insertion/inverse move mixes and rounded-score runs.

Requires `score_precision=None` (unrounded comparisons).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from greyjack_tpu.compile_cache import enable_compile_cache
from greyjack_tpu.models.vrp import (
    DomainBuilder,
    CotwinBuilder,
    generate_instance,
)
from greyjack_tpu.agents import TabuSearch
from greyjack_tpu.agents.termination_strategies import TimeSpentLimit
from greyjack_tpu.solver import Solver, SolverLoggingLevels


def main():
    enable_compile_cache()
    if len(sys.argv) > 1:
        domain_builder = DomainBuilder(sys.argv[1])
    else:
        domain_builder = DomainBuilder.from_generator(
            lambda: generate_instance(500, 5, 20, seed=42,
                                      time_windowed=True)
        )
    cotwin_builder = CotwinBuilder(True, True)

    agent = TabuSearch(
        neighbours_count=128,           # unused in sweep mode
        tabu_entity_rate=0.2,
        compare_to_global=True,
        mutation_rate_multiplier=None,
        move_probas=[0.5, 0.5, 0.0, 0.0, 0.0, 0.0],
        migration_frequency=10,
        termination_strategy=TimeSpentLimit(60_000),
        sweep=True,
        sweep_targets=64,
    )
    solution = Solver.solve(
        domain_builder, cotwin_builder, agent,
        n_jobs=8, score_precision=None,
        logging_level=SolverLoggingLevels.FreshOnly,
    )
    domain = domain_builder.build_from_solution(solution)
    domain.print_metrics()
    print("done")


if __name__ == "__main__":
    main()
