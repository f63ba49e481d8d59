"""Global dtype / size configuration for greyjack_tpu.

The reference solver does all chromosome and score math in f64
(`greyjack/src/agents/base/individual.rs:7-12`). Score parity with the
reference requires it, so f64 is the default for the score path.
Chromosomes default to f32, which represents discrete values (integers up
to 2^24) exactly.
"""

import jax.numpy as jnp

# dtype of chromosomes / move arithmetic. f32 by default: discrete variable
# values are small integers (exact below 2^24), and f32 halves the bytes
# every move and population op moves. Score rows and distance totals are
# always f64. Call `use_float64()` before building models for continuous
# problems with huge ranges or when bit-level f64 chromosome arithmetic is
# required (golden-parity tests feed f64 populations directly, which
# promotes automatically).
FLOAT_DTYPE = jnp.float32


def use_float64():
    global FLOAT_DTYPE
    FLOAT_DTYPE = jnp.float64


def use_float32():
    global FLOAT_DTYPE
    FLOAT_DTYPE = jnp.float32
# dtype of integer columns handed to constraint kernels. int32: every id /
# count / time value in cotwin problems is far below 2^31, and i32 halves
# the bytes. Reductions that can overflow i32 (penalty sums) widen locally.
INT_DTYPE = jnp.int32
# dtype used for indices inside kernels
INDEX_DTYPE = jnp.int32

# Maximum number of variables a single move may touch (`change`/`swap`/
# `swap_edges` moves). The reference draws a Binomial(n_vars, group_rate)
# change count (`mover.rs:130-143`); with the default mutation_rate_multiplier
# of 0.0/1.0 the count is almost always <= 2-3, so a static cap of 8 loses
# ~nothing while keeping device shapes static.
MAX_MOVE_SIZE = 8

# scramble windows are U{3..6} in the reference (`mover.rs:287`)
SCRAMBLE_MIN = 3
SCRAMBLE_MAX = 6

# Static width of a move in DELTA form: every move emits at most this many
# (variable, new value) pairs. swap_edges touches 2*MAX_MOVE_SIZE vars;
# insertion/inverse windows are capped at this length on the delta path
# (documented divergence — the plain path keeps unbounded subranges).
DELTA_MOVE_SIZE = 2 * MAX_MOVE_SIZE

# Static cap on the per-group tabu ring buffer length.
MAX_TABU_SIZE = 128
