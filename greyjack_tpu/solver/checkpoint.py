"""Device-state checkpoint / resume.

The reference's only resume mechanism is the solution-JSON round-trip
(`initial_solution_variants.rs:3-8`) — restarting loses the populations, the
tabu state, the LA deques and the RNG streams of every island. SURVEY.md §5
asks for real device-state checkpointing on top of that contract; this module
provides it: the FULL island-state pytree + the solver's RNG key + the host
side (termination strategies, alive mask, chunk counter) are serialized so a
killed solve resumes exactly where it stopped.

Determinism: with a fixed `seed` and step-based termination, a resumed solve
reproduces the exact trajectory of an uninterrupted one from the checkpoint
onward (the chunk key sequence is `jax.random.split` of the saved key —
tests/test_checkpoint.py asserts bit-equality of two resumes). Time-based
strategies are rebased on load: their elapsed milliseconds are preserved,
downtime between kill and resume does not count against the limit.

Format: a single pickle file written atomically (tmp + rename), holding
numpy-ified pytrees — no live JAX objects, so a checkpoint written on a GPU
loads on CPU and vice versa (shapes/dtypes must match, i.e. same solver
config; `Solver.solve(resume_from=...)` rebuilds the program from the same
builders and swaps the state in).
"""

from __future__ import annotations

import os
import pickle
import time

import jax
import numpy as np

FORMAT_VERSION = 1


def _rebase_strategy_times(strategies, to_relative):
    """Convert time-based strategies' absolute `start_time` (ms epoch) to a
    negative offset from now (save) or back to absolute (load), so wall time
    spent *down* is excluded from TimeSpentLimit/ScoreNoImprovement."""
    now = time.time() * 1000.0
    for s in strategies:
        st = getattr(s, "start_time", None)
        if st is not None:
            s.start_time = (st - now) if to_relative else (st + now)
    return strategies


def save_checkpoint(path, *, state, key, strategies, alive, chunk_id,
                    meta=None):
    """Atomically write the full solve state.

    state: the IslandRunner state pytree (device or host arrays).
    key: the solver's *next* jax.random key (saved AFTER the chunk's split,
         so the resumed run continues the same key sequence).
    """
    payload = {
        "format_version": FORMAT_VERSION,
        "state": jax.tree.map(np.asarray, jax.device_get(state)),
        "key_data": np.asarray(jax.random.key_data(key)),
        "strategies": _rebase_strategy_times(
            [s.clone() for s in strategies], to_relative=True),
        "alive": np.asarray(alive, dtype=bool),
        "chunk_id": int(chunk_id),
        "meta": meta or {},
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path):
    """Load a checkpoint written by save_checkpoint. Returns a dict with
    keys state / key / strategies / alive / chunk_id / meta; the state stays
    as host numpy (the first run_chunk devices it under the right sharding)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path}: unsupported format "
            f"{payload.get('format_version')!r} (expected {FORMAT_VERSION})")
    import jax.numpy as jnp
    return {
        "state": payload["state"],
        "key": jax.random.wrap_key_data(jnp.asarray(payload["key_data"])),
        "strategies": _rebase_strategy_times(payload["strategies"],
                                             to_relative=False),
        "alive": payload["alive"],
        "chunk_id": payload["chunk_id"],
        "meta": payload["meta"],
    }
