"""pygradflow_tpu: a sequential-homotopy NLP solver in JAX.

A from-scratch reimplementation of the capabilities of PyGradFlow
(sequential homotopy method of Potschka & Bock, Math. Prog. 187, 2021) with
an accelerator-first architecture: autodiff derivatives, dense masked
active-set algebra with static shapes, the homotopy loop under
``lax.while_loop``, instance batching via ``vmap`` and multi-device
sharding via ``shard_map``.

Double precision is the numerical default of the algorithm (matching the
reference); importing this package enables JAX x64 unless the environment
variable ``PYGRADFLOW_TPU_NO_X64`` is set.  Single precision runs are
selected per-solve via ``Params(precision=Precision.Single)``.
"""

import os

import jax

if not os.environ.get("PYGRADFLOW_TPU_NO_X64"):
    jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the homotopy loop is one large compiled
# program per (shape, params) configuration; caching it across processes
# turns repeated runs/tests from minutes of XLA work into milliseconds.
# JAX reads JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise the
# cache lives at one fixed path inside the checkout, so every process run
# from it finds what the others compiled.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from .params import (  # noqa: E402,F401
    ActiveSetType,
    DerivCheck,
    IntegrationMethod,
    LinearSolverType,
    NewtonType,
    Params,
    PenaltyUpdate,
    Precision,
    ScalingType,
    StepControlType,
    StepSolverType,
)
from .problem import FuncProblem, Problem, QuadraticProblem  # noqa: E402,F401
from .result import SolverResult  # noqa: E402,F401
from .scale import Scaling  # noqa: E402,F401
from .solver import Solver  # noqa: E402,F401
from .status import SolverStatus  # noqa: E402,F401

__version__ = "0.1.0"
