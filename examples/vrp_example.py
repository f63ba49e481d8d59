"""VRP example — mirrors `examples/vrp/src/main.rs`
(single-stage and multi-stage/replanning flavors).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import sys

from greyjack_tpu.compile_cache import enable_compile_cache
from greyjack_tpu.models.vrp import (
    DomainBuilder,
    CotwinBuilder,
    generate_instance,
)
from greyjack_tpu.agents import TabuSearch
from greyjack_tpu.agents.termination_strategies import ScoreNoImprovement
from greyjack_tpu.solver import Solver, SolverLoggingLevels
from greyjack_tpu.solver.initial_solution import InitialSolution


def make_agent(limit_ms=60_000, neighbours=128):
    return TabuSearch(
        neighbours_count=neighbours,
        tabu_entity_rate=0.8,
        compare_to_global=True,
        mutation_rate_multiplier=None,
        move_probas=[0.5, 0.5, 0.0, 0.0, 0.0, 0.0],
        migration_frequency=10,
        termination_strategy=ScoreNoImprovement(limit_ms),
    )


def main():
    enable_compile_cache()
    if len(sys.argv) > 1:
        domain_builder = DomainBuilder(sys.argv[1])
    else:
        domain_builder = DomainBuilder.from_generator(
            lambda: generate_instance(500, 5, 20, seed=42, time_windowed=True)
        )
    cotwin_builder = CotwinBuilder(True, True)

    solution = Solver.solve(
        domain_builder, cotwin_builder, make_agent(),
        n_jobs=8, score_precision=[0, 0, 3],
        logging_level=SolverLoggingLevels.FreshOnly,
    )
    domain = domain_builder.build_from_solution(solution)
    domain.print_metrics()

    # --- multi-stage / replanning: pin vehicle 0's customers, re-solve
    for customer in domain.vehicles[0].customers:
        customer.frozen = True
    solution = Solver.solve(
        domain_builder, cotwin_builder, make_agent(limit_ms=10_000),
        n_jobs=8, score_precision=[0, 0, 3],
        logging_level=SolverLoggingLevels.FreshOnly,
        initial_solution=InitialSolution.from_domain(domain),
    )
    domain = domain_builder.build_from_solution(solution, initial_domain=domain)
    domain.print_metrics()
    domain.print_trip_paths()
    print("done")


if __name__ == "__main__":
    main()
