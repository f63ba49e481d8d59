"""Mesh construction helpers for the island axis.

The reference scales by spawning `n_jobs` OS threads over a crossbeam ring
(`solver/solver.rs:85-143`). The device equivalent is a 1-D mesh whose
`islands` axis carries island shards; migration rides `lax.ppermute` between
devices and the global best is a lexicographic all-reduce (SURVEY.md §2.3).
"""

import jax
from jax.sharding import Mesh


def make_island_mesh(devices=None):
    """1-D mesh over all (or given) devices with axis name 'islands'."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), ("islands",))


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Multi-host bring-up: `jax.distributed.initialize` + a global island
    mesh over every device of every process.

    Replaces the reference's single-process rayon fan-out
    (`solver/solver.rs:94-143`) for multi-host runs: migration then rides
    the same `ppermute` ring within a host and across hosts. Pass
    `coordinator_address`, `num_processes` and `process_id` where nothing
    in the environment describes the cluster.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
    return make_island_mesh()
