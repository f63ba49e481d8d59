"""greyjack_tpu — a metaheuristic constraint-solver framework on JAX/XLA.

A from-scratch JAX/XLA re-design with the capabilities of GreyJack Solver
(Rust edition, CameleoGrey/greyjack-solver-rust): cotwin problem modeling,
multi-level lexicographic scores, a shared batched move library, five
metaheuristics (GeneticAlgorithm, TabuSearch, LateAcceptance,
SimulatedAnnealing, LSHADE), pluggable termination strategies, observers,
multi-stage solving with frozen-variable pinning, and an island model mapped
onto a `jax.sharding.Mesh` (migration = `lax.ppermute` ring, global best =
lexicographic all-reduce).

Reference layer map: SURVEY.md §1; component inventory: SURVEY.md §2.

The whole score path runs in float64 (required for score parity with the
reference's f64 scoring, reference `greyjack/src/utils/math_utils.rs:9-12`),
so x64 mode is enabled at import.
"""

import jax

jax.config.update("jax_enable_x64", True)

from greyjack_tpu import config  # noqa: E402
from greyjack_tpu.score_calculation.scores import (  # noqa: E402
    SimpleScore,
    HardSoftScore,
    HardMediumSoftScore,
)
from greyjack_tpu.variables import GJFloat, GJInteger  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "config",
    "SimpleScore",
    "HardSoftScore",
    "HardMediumSoftScore",
    "GJFloat",
    "GJInteger",
]
