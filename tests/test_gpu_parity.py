"""On-card parity at the flagship geometry: VRP with time windows, n=1000,
40 vehicles, 4096 random change/swap neighbours on each of 8 islands. The
integer delta rows and the f64 delta rows must equal full plain re-scores
of the same candidates exactly. Runs on the card only (`-m gpu`)."""

import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


@pytest.mark.gpu
def test_delta_rows_match_plain_at_bench_geometry(gpu):
    import chip_smoke
    from greyjack_tpu.models.vrp import CotwinBuilder, generate_instance
    from greyjack_tpu.score_calculation.score_requesters import ScoreRequester

    domain = generate_instance(1000, 8, 40, seed=37, time_windowed=True)
    req = ScoreRequester(CotwinBuilder(True, True).build_cotwin(domain,
                                                                False))
    base = req.variables_manager.sample_variables(jax.random.key(3), 1)[0]
    stubs = chip_smoke.neighbourhood_parity(req, base, jax.random.key(4),
                                            n_islands=8, p=4096)
    # the static route cap leaves over-cap growth rare at this size
    assert stubs < 8 * 4096 // 100
