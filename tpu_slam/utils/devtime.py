"""Device-side timing helpers.

Per-call host timing of one jitted call mixes dispatch, host scheduling and
device work, and a busy host inflates the gaps. The measurement used here
is the SLOPE of total wall-clock against iteration count of ONE jitted
fori_loop whose body is data-dependent (each iteration's inputs derive from
the previous result), timed at two different K:

    t_per_op = (t(K2) - t(K1)) / (K2 - K1)

Fixed costs (dispatch, launch, the final sync) cancel in the difference;
the data dependence keeps XLA from hoisting the work out of the loop.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp


def slope_time(loop_fn: Callable[[jax.Array], jax.Array],
               k1: int = 5, k2: int = 45) -> float:
    """Seconds per iteration of ``loop_fn(K)`` (a jitted K-iteration loop).

    ``loop_fn`` must return something small that depends on every
    iteration (an accumulated scalar), and its loop body must be
    data-dependent across iterations.  Both K values are warmed first so
    compile time never enters the measurement.
    """
    jax.block_until_ready(loop_fn(jnp.int32(k1)))
    jax.block_until_ready(loop_fn(jnp.int32(k2)))
    t0 = time.perf_counter()
    jax.block_until_ready(loop_fn(jnp.int32(k1)))
    ta = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(loop_fn(jnp.int32(k2)))
    tb = time.perf_counter() - t0
    return max((tb - ta) / (k2 - k1), 1e-9)
