"""Closed-form spectral utilities for batched symmetric 3x3 matrices.

``jnp.linalg.eigh`` on a (M, 3, 3) batch lowers to an iterative solver.
Every use in the SLAM engine only needs eigenVALUES (planarity tests,
conditioning floors), for which the exact trigonometric (Cardano) solution
is a handful of element-wise ops.

The NDT information matrix is computed here without eigenvectors at all:
instead of flooring the eigenvalues of Sigma at ``ratio * lambda_max`` and
inverting (Magnusson 2009 conditioning, reference SLAM core behavior per
SURVEY.md §2.2), we invert ``Sigma + ratio * lambda_max * I`` in closed form
(adjugate / det). The spectra match at the extremes — a zero eigenvalue maps
to ``1 / (ratio * lambda_max)`` either way, the largest changes by a factor
``1 / (1 + ratio)`` — and intermediate eigenvalues are smoothly damped
instead of hard-floored, which is an equally standard NDT regularization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


TRI6 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))  # upper-tri layout


def _tri6_of(a: jax.Array):
    """Upper-tri components (a00, a01, a02, a11, a12, a22) of (..., 3, 3)."""
    return (a[..., 0, 0], a[..., 0, 1], a[..., 0, 2],
            a[..., 1, 1], a[..., 1, 2], a[..., 2, 2])


def eigvals_sym3(a: jax.Array) -> jax.Array:
    """Eigenvalues of symmetric (..., 3, 3) matrices, ascending (..., 3).

    Exact trigonometric solution (Smith 1961 / Cardano): branch-free,
    element-wise, float32-stable for the near-PSD covariances this engine
    produces (entries O(leaf^2)).
    """
    return eigvals_sym3_tri(*_tri6_of(a))


def eigvals_sym3_tri(a00, a01, a02, a11, a12, a22) -> jax.Array:
    """eigvals_sym3 on upper-tri components (lane-wise, no (...,3,3) churn)."""
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    # Floor p2 so p^3 stays a float32 normal (p2 = 1e-30 would underflow
    # p^3 to zero and poison acos with nan on isotropic matrices).
    p2 = jnp.maximum(p2, 1e-20)
    p = jnp.sqrt(p2)
    # det(B) / (2 p^3), clamped into acos domain
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = jnp.clip(detb / (2.0 * p * p2), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lmax = q + 2.0 * p * jnp.cos(phi)
    lmin = q + 2.0 * p * jnp.cos(phi + _TWO_PI_3)
    lmid = 3.0 * q - lmax - lmin
    return jnp.stack([lmin, lmid, lmax], axis=-1)


def inv_sym3(a: jax.Array) -> jax.Array:
    """Closed-form (adjugate/det) inverse of symmetric (..., 3, 3) matrices."""
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    row0 = jnp.stack([c00, c01, c02], axis=-1)
    row1 = jnp.stack([c01, c11, c12], axis=-1)
    row2 = jnp.stack([c02, c12, c22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]


def floored_info_sym3(cov: jax.Array, floor_ratio: float) -> jax.Array:
    """NDT information matrix: eigenvalues floored at ratio*lambda_max, then
    inverted — WITHOUT eigenvectors.

    Exactly matches the eigh-based chain (Magnusson 2009 conditioning):
    with g(l) = 1 / max(l, f), g(A) is evaluated as the degree-2 Lagrange
    spectral polynomial

        g(A) = sum_i g(l_i) * (A - l_j I)(A - l_k I) / ((l_i-l_j)(l_i-l_k))

    which needs only the (closed-form) eigenvalues and one A@A. Repeated
    eigenvalues make the bare formula 0/0, so the l_i are first spread to a
    minimum gap of eps*scale — equivalent to evaluating g on a matrix with
    the same eigenvectors and eps-perturbed eigenvalues, an O(eps) relative
    error (g is smooth at scale f >> eps*scale).
    """
    tri = floored_info_sym3_tri(_tri6_of(cov), floor_ratio)
    i00, i01, i02, i11, i12, i22 = tri
    row0 = jnp.stack([i00, i01, i02], axis=-1)
    row1 = jnp.stack([i01, i11, i12], axis=-1)
    row2 = jnp.stack([i02, i12, i22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def floored_info_sym3_tri(tri, floor_ratio: float):
    """floored_info_sym3 on upper-tri lanes; returns the 6 info lanes.

    Lane-wise form (no (..., 3, 3) arrays, no batched matmul): the Newton
    (divided-difference) evaluation of g(A) = 1/max(lambda, f), which stays
    stable under clustered eigenvalues, unlike the Lagrange-projector form
    whose per-projector cancellations blow up as 1/gap^2.
    """
    a00, a01, a02, a11, a12, a22 = tri
    lam = eigvals_sym3_tri(a00, a01, a02, a11, a12, a22)
    scale = jnp.maximum(lam[..., 2], 1e-9)
    eps = 1e-3 * scale
    l0 = lam[..., 0]
    l1 = jnp.maximum(lam[..., 1], l0 + eps)
    l2 = jnp.maximum(lam[..., 2], l1 + eps)
    f = floor_ratio * scale
    g0 = 1.0 / jnp.maximum(l0, f)
    g1 = 1.0 / jnp.maximum(l1, f)
    g2 = 1.0 / jnp.maximum(l2, f)
    dd1 = (g1 - g0) / (l1 - l0)
    dd2 = ((g2 - g1) / (l2 - l1) - dd1) / (l2 - l0)

    # p(A) = g0 I + dd1 (A - l0 I) + dd2 (A - l0 I)(A - l1 I); the product
    # of the two shifted symmetric matrices written out lane-wise (they
    # commute, so it is symmetric).
    b00, b11, b22 = a00 - l0, a11 - l0, a22 - l0
    c00, c11, c22 = a00 - l1, a11 - l1, a22 - l1
    p00 = b00 * c00 + a01 * a01 + a02 * a02
    p11 = a01 * a01 + b11 * c11 + a12 * a12
    p22 = a02 * a02 + a12 * a12 + b22 * c22
    p01 = b00 * a01 + a01 * c11 + a02 * a12
    p02 = b00 * a02 + a01 * a12 + a02 * c22
    p12 = a01 * a02 + b11 * a12 + a12 * c22
    i00 = g0 + dd1 * b00 + dd2 * p00
    i11 = g0 + dd1 * b11 + dd2 * p11
    i22 = g0 + dd1 * b22 + dd2 * p22
    i01 = dd1 * a01 + dd2 * p01
    i02 = dd1 * a02 + dd2 * p02
    i12 = dd1 * a12 + dd2 * p12
    return i00, i01, i02, i11, i12, i22
