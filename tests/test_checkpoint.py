"""Device-state checkpoint / resume (greyjack_tpu.solver.checkpoint).

The reference has no checkpointing (SURVEY.md §5 — only the solution-JSON
round-trip, `initial_solution_variants.rs:3-8`); these tests cover the
This build's addition: a killed solve resumes from the full island-state
pytree + RNG key with a bit-identical continuation.
"""

import numpy as np

from greyjack_tpu.models.nqueens import DomainBuilder, CotwinBuilder
from greyjack_tpu.agents import TabuSearch
from greyjack_tpu.agents.termination_strategies import StepsLimit
from greyjack_tpu.solver import Solver, SolverLoggingLevels, load_checkpoint


def _agent(steps):
    return TabuSearch(16, 0.0, True, None, [0.0, 1.0, 0.0, 0.0, 0.0, 0.0],
                      10, StepsLimit(steps))


def test_save_restore_roundtrip(tmp_path):
    ckpt = str(tmp_path / "solve.ckpt")
    db = DomainBuilder(12, 45)
    Solver.solve(db, CotwinBuilder(True), _agent(20), n_jobs=2,
                 logging_level=SolverLoggingLevels.Silent, seed=11,
                 checkpoint_path=ckpt, checkpoint_frequency=1)
    loaded = load_checkpoint(ckpt)
    # final checkpoint: both agents dead, chunk counter advanced, meta kept
    assert not loaded["alive"].any()
    assert loaded["chunk_id"] >= 2
    assert loaded["meta"]["n_jobs"] == 2
    assert all(s.is_accomplish() for s in loaded["strategies"])
    assert "global_values" in loaded["state"]


def test_resume_is_deterministic(tmp_path):
    """Two resumes from the same checkpoint (fresh step budget) must produce
    bit-identical solutions — proves the RNG key, populations, tabu state and
    chunk counter all live in the checkpoint."""
    ckpt = str(tmp_path / "mid.ckpt")
    db = DomainBuilder(12, 45)
    cb = CotwinBuilder(True)
    Solver.solve(db, cb, _agent(20), n_jobs=2,
                 logging_level=SolverLoggingLevels.Silent, seed=23,
                 checkpoint_path=ckpt, checkpoint_frequency=1)

    def resume():
        loaded = load_checkpoint(ckpt)
        # "kill-and-extend": reuse device state/key but give the agents a
        # fresh step budget, as a restarted driver would
        loaded["strategies"] = [StepsLimit(20) for _ in range(2)]
        loaded["alive"] = np.ones(2, dtype=bool)
        return Solver.solve(db, cb, _agent(20), n_jobs=2,
                            logging_level=SolverLoggingLevels.Silent,
                            resume_from=loaded)

    sol_a = resume()
    sol_b = resume()
    assert sol_a == sol_b


def test_resume_never_regresses(tmp_path):
    ckpt = str(tmp_path / "mid.ckpt")
    db = DomainBuilder(14, 45)
    cb = CotwinBuilder(True)
    Solver.solve(db, cb, _agent(20), n_jobs=2,
                 logging_level=SolverLoggingLevels.Silent, seed=5,
                 checkpoint_path=ckpt, checkpoint_frequency=1)
    loaded = load_checkpoint(ckpt)
    ckpt_score = float(np.asarray(loaded["state"]["global_score"])[0])
    loaded["strategies"] = [StepsLimit(40) for _ in range(2)]
    loaded["alive"] = np.ones(2, dtype=bool)
    sol = Solver.solve(db, cb, _agent(40), n_jobs=2,
                       logging_level=SolverLoggingLevels.Silent,
                       resume_from=loaded)
    assert sol[1]["simple_value"] <= ckpt_score
