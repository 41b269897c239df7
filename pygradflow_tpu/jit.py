"""``jax.jit`` for the solver's programs, with f32 products at full precision.

On a GPU an f32 matrix product may run in TF32, which keeps about 10
mantissa bits, unless the trace asks for more.  The f32 paths of this
package (``Precision.Single`` solves, the mixed-precision KKT tier and the
f32 Schur assembly) are tuned for real f32 arithmetic: their tolerances and
fixed refinement counts assume it.  Every program the package compiles is
therefore traced under ``jax.default_matmul_precision("highest")``, which
sets the precision of each dot in that trace without touching the
process-wide default.  f64 products are unaffected.
"""

import functools

import jax


def full_f32(fn):
    """Wrap ``fn`` so every matrix product it traces asks for full f32
    precision (``HIGHEST``)."""

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return traced


def jit(fn, **kwargs):
    """``jax.jit(fn, **kwargs)`` with ``fn`` traced under :func:`full_f32`."""
    return jax.jit(full_f32(fn), **kwargs)
