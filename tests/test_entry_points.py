"""Entry points: the compile-cache helper, and the scripts that must refuse
to report a result without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(cmd, cwd, platforms, **extra_env):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS",
                        "JAX_COMPILATION_CACHE_DIR")}
    if platforms is not None:
        env["JAX_PLATFORMS"] = platforms
    env.update(extra_env)
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


# the helper runs in a fresh process, so this one's JAX config is untouched
_CACHE_DIR_OF = ("import sys; sys.path.insert(0, sys.argv[1]); "
                 "import jax; "
                 "from greyjack_tpu.compile_cache import enable_compile_cache; "
                 "got = enable_compile_cache(); "
                 "assert got == jax.config.jax_compilation_cache_dir; "
                 "print(got)")


def test_cache_helper_uses_checkout_path(tmp_path):
    out = _run([sys.executable, "-c", _CACHE_DIR_OF, str(REPO)], tmp_path,
               "cpu")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(REPO / ".jax_cache")


def test_cache_helper_respects_env(tmp_path):
    out = _run([sys.executable, "-c", _CACHE_DIR_OF, str(REPO)], tmp_path,
               "cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path / "cache")


@pytest.mark.parametrize("isolated", [False, True],
                         ids=["in-repo", "script-alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, isolated):
    script = REPO / "chip_smoke.py"
    if isolated:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = _run([sys.executable, str(script)], script.parent, "cpu")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_refuses_unrequested_cpu_backend():
    # JAX falls back to the CPU when it finds no accelerator; the bench
    # must not report that as a device number unless asked to rehearse
    out = _run([sys.executable, str(REPO / "bench.py")], REPO, None)
    assert out.returncode != 0
    assert "metric" not in out.stdout
