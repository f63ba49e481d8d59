"""Multi-process (DCN-analog) distributed test.

Two `jax.distributed` CPU processes, each exposing 2 virtual devices, form a
4-device global mesh; a sharded island chunk (shard_map + ppermute ring +
all_gather global best, `parallel/islands.py`) runs across the process
boundary, proving `parallel/mesh.py:init_distributed` and the sharded chunk
path work beyond a single process. The reference has no
multi-host story at all (crossbeam channels in one process,
`solver/solver.rs:85-143`); this is the DCN leg of SURVEY.md §2.3's plan.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_island_chunk():
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    n_proc = 2
    procs = []
    for pid in range(n_proc):
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
            "PYTHONPATH": REPO,
        })
        # each process must NOT inherit the parent's test-wide device count
        env.pop("JAX_NUM_CPU_DEVICES", None)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, "--coordinator", coordinator,
             "--num-processes", str(n_proc), "--process-id", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"process {pid} output:\n{out}"
