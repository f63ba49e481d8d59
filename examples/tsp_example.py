"""TSP example — mirrors `examples/tsp/src/main.rs`.

Accepts a TSPLIB file path; without one, generates a synthetic instance
(the reference repo ships no data files).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from greyjack_tpu.compile_cache import enable_compile_cache
from greyjack_tpu.models.tsp import (
    DomainBuilder,
    CotwinBuilder,
    generate_uniform_instance,
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
            lambda: generate_uniform_instance(1000, seed=42)
        )
    cotwin_builder = CotwinBuilder(use_incremental_score_calculation=True,
                                   use_greed_init=True)

    termination_strategy = TimeSpentLimit(60 * 1000)
    agent_builder = TabuSearch(
        neighbours_count=1024,
        tabu_entity_rate=0.5,
        compare_to_global=True,
        mutation_rate_multiplier=None,
        move_probas=[0.0, 0.2, 0.2, 0.2, 0.2, 0.2],
        migration_frequency=10,
        termination_strategy=termination_strategy,
        # sweep neighbourhoods stay live under the reference's shipped
        # score_precision=[3,3] (`tsp/src/main.rs:56`) — rounding happens
        # at the accept boundary over exact integer sums
        sweep=True,
        sweep_targets=64,
    )

    solution = Solver.solve(
        domain_builder, cotwin_builder, agent_builder,
        n_jobs=8, score_precision=[3, 3],
        logging_level=SolverLoggingLevels.FreshOnly,
    )

    domain = domain_builder.build_from_solution(solution)
    domain.print_metrics()
    print("done")


if __name__ == "__main__":
    main()
