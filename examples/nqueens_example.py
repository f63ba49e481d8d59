"""N-Queens example — mirrors `examples/nqueens/src/main.rs`.

Fastest config per the reference: TabuSearch with swap-only moves and
unique-row initialization (`main.rs:33`).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from greyjack_tpu.compile_cache import enable_compile_cache
from greyjack_tpu.models.nqueens import DomainBuilder, CotwinBuilder
from greyjack_tpu.agents import TabuSearch
from greyjack_tpu.agents.termination_strategies import ScoreLimit
from greyjack_tpu.score_calculation.scores import SimpleScore
from greyjack_tpu.solver import Observer, Solver, SolverLoggingLevels


class NQueensObserver(Observer):
    """Example observer (mirrors the reference's
    `observers_examples/nqueens_observer.rs`): called with every new global
    best solution JSON."""

    def __init__(self, domain_builder):
        self.domain_builder = domain_builder

    def update(self, solution):
        domain = self.domain_builder.build_from_solution(solution)
        print(f"[observer] conflicts now: {domain.conflict_count()}")


def main():
    enable_compile_cache()
    domain_builder = DomainBuilder(256, 45)
    cotwin_builder = CotwinBuilder(use_incremental_score_calculation=True)

    termination_strategy = ScoreLimit(SimpleScore(0.0))
    agent_builder = TabuSearch(
        neighbours_count=20,
        tabu_entity_rate=0.0,
        compare_to_global=True,
        mutation_rate_multiplier=None,
        move_probas=[0.0, 1.0, 0.0, 0.0, 0.0, 0.0],
        migration_frequency=10,
        termination_strategy=termination_strategy,
    )

    # optional observers, as in the reference main (`nqueens/src/main.rs:37-39`)
    observers = [NQueensObserver(domain_builder)]

    solution = Solver.solve(
        domain_builder, cotwin_builder, agent_builder,
        n_jobs=8, score_precision=None,
        logging_level=SolverLoggingLevels.FreshOnly,
        observers=observers,
    )

    domain = domain_builder.build_from_solution(solution)
    print(f"conflicts: {domain.conflict_count()}")
    print("done")


if __name__ == "__main__":
    main()
