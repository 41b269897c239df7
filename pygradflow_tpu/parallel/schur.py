"""Distributed Schur-complement KKT solve over a device mesh.

The multi-device form of ``step/schur.py`` (psum reductions for the
Schur complement): the block-diagonal primal blocks and
the matching Jacobian column slices are sharded over a 1-D mesh axis, each
device factors its blocks and computes its local contribution
``J_k A_k^{-1} J_k^T``; one ``psum`` assembles the dense dual Schur
complement on every device, the (small) dual solve is replicated, and the
primal back-substitution is local again — the only cross-device traffic is
the two m×m / m-vector reductions.

For KKT systems whose primal dimension exceeds one device's memory this is
the scaling path; it is validated against the single-device solver on the
CPU simulation mesh.
"""

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..jit import jit
from ..linalg.ldlt import ldlt_factor, ldlt_solve

AXIS = "blocks"


def distributed_schur_solve(
    h_blocks,  # (nb, b, b) primal diagonal blocks (already shifted/masked)
    jac,  # (m, n) dual coupling, n = nb * b
    m22,  # (m, m) dual block (e.g. -lambda/(1+lambda rho) I)
    rhs_x,  # (n,)
    rhs_y,  # (m,)
    mesh: Optional[Mesh] = None,
):
    """Solve [[A, J^T], [J, M22]] [sx, sy] = [rhs_x, rhs_y] with A block
    diagonal, sharding the block axis over ``mesh``."""
    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), (AXIS,))

    (nb, b, _) = h_blocks.shape
    n = nb * b
    D = mesh.devices.size
    assert nb % D == 0, f"number of blocks {nb} must divide over {D} devices"

    # reshape J and rhs_x into per-block form so the same axis shards
    jac_b = jac.reshape(-1, nb, b).transpose(1, 0, 2)  # (nb, m, b)
    rhs_xb = rhs_x.reshape(nb, b)

    def solve_kernel(h_blocks, jac_b, rhs_xb, m22, rhs_y):
        # explicit local block inverses: applications become batched
        # GEMMs instead of b-wide substitution sweeps
        from ..step.schur import _block_inverses

        inv = _block_inverses(h_blocks)

        # A^{-1} J^T for the local blocks: rhs rows are (m, b) per block
        ainv_jt = jnp.einsum("kij,kmj->kmi", inv, jac_b)  # (nb/D, m, b)
        az = jnp.einsum("kij,kj->ki", inv, rhs_xb)  # (nb/D, b)

        # local contributions to the Schur complement and condensed rhs
        s_local = jnp.einsum("kmb,knb->mn", jac_b, ainv_jt)
        jaz_local = jnp.einsum("kmb,kb->m", jac_b, az)

        # collective: assemble S and J A^{-1} rhs_x on every device
        s_sum = jax.lax.psum(s_local, AXIS)
        jaz = jax.lax.psum(jaz_local, AXIS)

        S = m22 - s_sum
        sy = ldlt_solve(ldlt_factor(S), rhs_y - jaz)  # replicated dual solve

        # local primal back-substitution
        corr = jnp.einsum("kmb,m->kb", ainv_jt, sy)
        sx_local = az - corr
        return sx_local, sy

    spec_blocks = P(AXIS)
    spec_rep = P()

    out = jit(
        jax.shard_map(
            solve_kernel,
            mesh=mesh,
            in_specs=(spec_blocks, spec_blocks, spec_blocks, spec_rep, spec_rep),
            out_specs=(spec_blocks, spec_rep),
            check_vma=False,
        )
    )(h_blocks, jac_b, rhs_xb, m22, rhs_y)

    sx_b, sy = out
    return sx_b.reshape(n), sy
