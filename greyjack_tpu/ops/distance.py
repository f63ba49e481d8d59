"""Distance-matrix construction on device.

The reference builds full O(L^2) distance matrices on the host at domain
parse time, rounding each entry to 3 decimals
(`examples/tsp/src/persistence/domain_builder.rs:92-213`). Here the matrix
is computed as one batched pairwise op on device — for L ~ 10k a 100M-entry
elementwise computation instead of seconds of host loops.
"""

from functools import partial

import jax
import jax.numpy as jnp

from greyjack_tpu.utils.math_utils import round_decimal_jnp


@partial(jax.jit, static_argnames=("precision",))
def euclidean_matrix(xs, ys, precision=None):
    """Pairwise Euclidean distances; optional truncating decimal rounding.

    xs, ys: f64[L] coordinates -> f64[L, L].
    `precision=3` mirrors the reference's pre-rounded matrices
    (`tsp/persistence/domain_builder.rs:40-44` semantics).
    """
    dx = xs[:, None] - xs[None, :]
    dy = ys[:, None] - ys[None, :]
    d = jnp.sqrt(dx * dx + dy * dy)
    if precision is not None:
        d = round_decimal_jnp(d, precision)
    return d
