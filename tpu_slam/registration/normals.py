"""Per-point surface normals from k-NN covariance — one batched dispatch.

Loop-closure verification needs a sampling-robust alignment error: two
VLP-16 scans of the SAME surface from poses a meter apart sample different
ring arcs, so point-to-POINT nearest-neighbor residuals are dominated by the
ring spacing (~0.3-0.9 m on far walls) even at perfect alignment — measured
on the r4 config-4 bench as every true lap-revisit pair scoring mse
0.15-0.25 against a 0.15 gate (benchmarks/diag_config4.py).
Point-to-PLANE residuals collapse that mismatch: distance along the surface
normal is noise + flatness only (~cm). The reference's CPU graph backend
verified candidates with PCL's plane-aware matchers for the same reason
(SURVEY.md §2.2 [inferred]).

Estimation is the standard PCA normal: each point's k nearest neighbors
(brute-force distance matrix — one (P, P) matmul-shaped op, cheap at
keyframe sizes), covariance, smallest eigenvector. Runs ONCE per keyframe
at store time; orientation is left arbitrary (point-to-plane residuals and
Jacobians are sign-invariant).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu_slam.core.pointcloud import PAD_COORD


@functools.partial(jax.jit, static_argnames=("k",))
def estimate_normals(points: jax.Array, mask: jax.Array,
                     k: int = 16) -> jax.Array:
    """(P, 3) unit normals from each point's k-NN covariance.

    Invalid points (mask False) sit at PAD_COORD and never enter a valid
    point's neighborhood; their own normals are arbitrary unit vectors
    (consumers weight them out via the correspondence mask).
    """
    pts = jnp.where(mask[:, None], points, PAD_COORD)
    # ||a-b||^2 via the matmul form: the (P, P) Gram product avoids
    # materializing a (P, P, 3) difference tensor
    sq = jnp.sum(pts * pts, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (pts @ pts.T)
    _, idx = jax.lax.top_k(-d2, k)                  # (P, k) nearest (incl self)
    nbr = jnp.take(pts, idx, axis=0)                # (P, k, 3)
    mu = jnp.mean(nbr, axis=1, keepdims=True)
    c = nbr - mu
    cov = jnp.einsum("pki,pkj->pij", c, c) / k      # (P, 3, 3)
    # guard: padded/degenerate neighborhoods get an identity-ish covariance
    # so eigh stays finite
    cov = cov + 1e-12 * jnp.eye(3, dtype=cov.dtype)
    cov = jnp.where(jnp.isfinite(cov), cov, jnp.eye(3, dtype=cov.dtype))
    _, vecs = jnp.linalg.eigh(cov)                  # ascending eigenvalues
    nrm = vecs[:, :, 0]                             # smallest -> normal
    nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=1, keepdims=True),
                            1e-12)
    return jnp.where(mask[:, None], nrm,
                     jnp.array([0.0, 0.0, 1.0], nrm.dtype))
