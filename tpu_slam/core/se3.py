"""SE(3) / SO(3) Lie-group operations, vectorization-friendly and jit-safe.

All functions are pure, operate on float32/float64 jnp arrays, and are written
so that `jax.vmap` lifts them to batches. Poses are represented as 4x4
homogeneous matrices; tangent vectors are 6-vectors ``xi = [v, w]`` with
translational part first (matching the common robotics convention).

The quaternion helpers reproduce the conventions used by the reference stack's
TF pipeline (tf::Quaternion xyzw order, see
m3d/m3dunit_base/scripts/transformBroadcaster.py:126-141 and
m3d/m3d_aggregator/src/m3d_aggregator.cpp:75-87 which integrates quaternion
angular distance between consecutive rotation-axis orientations).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8

# Matmul precision: a reduced-precision f32 matmul (TF32 on NVIDIA tensor
# cores keeps ~3 decimal digits) is catastrophic for pose composition
# (errors compound over thousands of chained transforms) and
# centimeter-level for point transforms at room scale. Every product here
# is tiny (3x3, 4x4, or (N,3)x(3,3)), so full-f32 precision costs nothing
# measurable.
def _mm(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of a 3-vector: hat(w) @ x == cross(w, x)."""
    wx, wy, wz = w[0], w[1], w[2]
    z = jnp.zeros((), dtype=w.dtype)
    return jnp.array([
        [z, -wz, wy],
        [wz, z, -wx],
        [-wy, wx, z],
    ])


def vee(W: jax.Array) -> jax.Array:
    """Inverse of :func:`hat`."""
    return jnp.array([W[2, 1], W[0, 2], W[1, 0]])


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues formula, numerically safe at ||w|| -> 0."""
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallback via the eps-regularised
    # theta (error O(eps) which is below float32 resolution for eps=1e-8).
    a = jnp.sin(theta) / theta
    b = (1.0 - jnp.cos(theta)) / (theta * theta)
    small = theta2 < 1e-12
    a = jnp.where(small, 1.0 - theta2 / 6.0, a)
    b = jnp.where(small, 0.5 - theta2 / 24.0, b)
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a * W + b * _mm(W, W)


def so3_log(R: jax.Array) -> jax.Array:
    """Log map of a rotation matrix -> rotation vector (axis * angle)."""
    trace = jnp.clip(jnp.trace(R), -1.0, 3.0)
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    w_raw = vee(R - R.T)  # = 2 sin(theta) * axis
    sin_t = jnp.sin(theta)

    # Generic case: w = theta / (2 sin t) * vee(R - R^T)
    generic = 0.5 * theta / jnp.where(jnp.abs(sin_t) < _EPS, 1.0, sin_t) * w_raw
    # Small angle: w ~ 0.5 * vee(R - R^T)
    small = 0.5 * (1.0 + theta * theta / 6.0) * w_raw
    # Near pi: extract axis from diagonal of (R + I)/2
    diag = jnp.clip((jnp.diagonal(R) + 1.0) * 0.5, 0.0, 1.0)
    axis_abs = jnp.sqrt(diag)
    # Fix signs using off-diagonals relative to the largest axis component.
    k = jnp.argmax(axis_abs)
    signs_by_k = jnp.stack([
        jnp.array([1.0, jnp.sign(R[0, 1] + R[1, 0]), jnp.sign(R[0, 2] + R[2, 0])]),
        jnp.array([jnp.sign(R[0, 1] + R[1, 0]), 1.0, jnp.sign(R[1, 2] + R[2, 1])]),
        jnp.array([jnp.sign(R[0, 2] + R[2, 0]), jnp.sign(R[1, 2] + R[2, 1]), 1.0]),
    ])
    signs = signs_by_k[k]
    signs = jnp.where(signs == 0.0, 1.0, signs)
    near_pi = theta * signs * axis_abs / jnp.maximum(
        jnp.linalg.norm(axis_abs), _EPS)

    w = jnp.where(theta < 1e-4, small, generic)
    w = jnp.where(theta > jnp.pi - 1e-3, near_pi, w)
    return w.astype(R.dtype)


def so3_left_jacobian(w: jax.Array) -> jax.Array:
    """Left Jacobian J_l of SO(3); V matrix used in the SE(3) exp map."""
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    b = (1.0 - jnp.cos(theta)) / (theta * theta)
    c = (theta - jnp.sin(theta)) / (theta * theta * theta)
    small = theta2 < 1e-12
    b = jnp.where(small, 0.5 - theta2 / 24.0, b)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, c)
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + b * W + c * _mm(W, W)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def exp(xi: jax.Array) -> jax.Array:
    """SE(3) exponential map. xi = [v(3), w(3)] -> 4x4 homogeneous matrix."""
    v, w = xi[:3], xi[3:]
    R = so3_exp(w)
    V = so3_left_jacobian(w)
    T = jnp.eye(4, dtype=xi.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(_mm(V, v))
    return T


def log(T: jax.Array) -> jax.Array:
    """SE(3) log map. 4x4 matrix -> xi = [v, w]."""
    w = so3_log(T[:3, :3])
    V = so3_left_jacobian(w)
    v = jnp.linalg.solve(V, T[:3, 3])
    return jnp.concatenate([v, w])


def inverse(T: jax.Array) -> jax.Array:
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = jnp.eye(4, dtype=T.dtype)
    Ti = Ti.at[:3, :3].set(R.T)
    Ti = Ti.at[:3, 3].set(_mm(-R.T, t))
    return Ti


def compose(A: jax.Array, B: jax.Array) -> jax.Array:
    return _mm(A, B)


def orthonormalize(T: jax.Array) -> jax.Array:
    """Project the rotation block back onto SO(3) (one polar-Newton step).

    R <- R (3 I - R^T R) / 2 removes first-order scale/skew accumulated by
    repeated float32 compositions. One step per scan keeps the rotation
    orthonormal to ~1e-7 over arbitrarily long trajectories without an SVD.
    """
    R = T[:3, :3]
    R = 0.5 * _mm(R, 3.0 * jnp.eye(3, dtype=T.dtype) - _mm(R.T, R))
    return T.at[:3, :3].set(R)


def from_rt(R: jax.Array, t: jax.Array) -> jax.Array:
    T = jnp.eye(4, dtype=R.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    return T


def apply(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply a 4x4 transform to an (N, 3) point array.

    Expressed as a single (N,3)x(3,3) matmul plus broadcast add (the
    reference uses pcl::transformPointCloud,
    m3d_calibration_twiddle.cpp:229-230; this is its batched-matmul analog).
    """
    return _mm(pts, T[:3, :3].T) + T[:3, 3]


def retract(T: jax.Array, xi: jax.Array) -> jax.Array:
    """Left-multiplicative retraction: exp(xi) @ T (the GN update rule)."""
    return _mm(exp(xi), T)


# ---------------------------------------------------------------------------
# Quaternions (xyzw order, matching tf::Quaternion in the reference)
# ---------------------------------------------------------------------------

def quat_from_matrix(R: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion [x, y, z, w] (Shepperd's method)."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def case_w():
        s = jnp.sqrt(jnp.maximum(tr + 1.0, _EPS)) * 2.0
        return jnp.array([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s])

    def case_x():
        s = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) * 2.0
        return jnp.array([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s])

    def case_y():
        s = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, _EPS)) * 2.0
        return jnp.array([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s])

    def case_z():
        s = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, _EPS)) * 2.0
        return jnp.array([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s])

    idx = jnp.argmax(jnp.array([tr, m00, m11, m22]))
    q = jax.lax.switch(idx, [case_w, case_x, case_y, case_z])
    return q / jnp.linalg.norm(q)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion [x, y, z, w] -> rotation matrix."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / jnp.maximum(n, _EPS)
    return jnp.array([
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
    ])


def quat_angle_between(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Angular distance between two unit quaternions in radians.

    Reproduces tf::Quaternion::angle semantics used by the aggregator's
    rotation-progress integral (m3d_aggregator.cpp:84-87): the angle of the
    relative rotation, in [0, pi].
    """
    d = jnp.abs(jnp.dot(q1, q2))
    return 2.0 * jnp.arccos(jnp.clip(d, -1.0, 1.0))


def quat_from_euler(roll: jax.Array, pitch: jax.Array, yaw: jax.Array) -> jax.Array:
    """ZYX (yaw-pitch-roll) Euler angles -> quaternion [x, y, z, w].

    Matches tf.transformations.quaternion_from_euler's default axes as used by
    transformBroadcaster.py:132-137.
    """
    cr, sr = jnp.cos(roll * 0.5), jnp.sin(roll * 0.5)
    cp, sp = jnp.cos(pitch * 0.5), jnp.sin(pitch * 0.5)
    cy, sy = jnp.cos(yaw * 0.5), jnp.sin(yaw * 0.5)
    return jnp.array([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ])


# Batched variants --------------------------------------------------------

exp_batch = jax.vmap(exp)
log_batch = jax.vmap(log)
inverse_batch = jax.vmap(inverse)
apply_batch = jax.vmap(apply, in_axes=(0, 0))


# ---------------------------------------------------------------------------
# Adjoints (pose-graph Jacobian machinery)
# ---------------------------------------------------------------------------

def adjoint(T: jax.Array) -> jax.Array:
    """SE(3) adjoint, 6x6, for xi = [v, w] ordering:

        Ad(T) = [[R, hat(t) R], [0, R]]   with   Ad(T) xi = log(T exp(xi) T^-1)
    """
    R = T[:3, :3]
    t = T[:3, 3]
    top = jnp.concatenate([R, _mm(hat(t), R)], axis=1)
    bot = jnp.concatenate([jnp.zeros((3, 3), T.dtype), R], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def ad(xi: jax.Array) -> jax.Array:
    """se(3) small adjoint: ad(xi) = [[hat(w), hat(v)], [0, hat(w)]]."""
    v, w = xi[:3], xi[3:]
    W = hat(w)
    top = jnp.concatenate([W, hat(v)], axis=1)
    bot = jnp.concatenate([jnp.zeros((3, 3), xi.dtype), W], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def left_jacobian_inv_approx(xi: jax.Array) -> jax.Array:
    """Second-order approximation of the inverse SE(3) left Jacobian.

    J_l^{-1}(xi) ~= I - ad(xi)/2 + ad(xi)^2/12 — exact enough for the
    pose-graph residual magnitudes GN operates at (the series truncation
    error is O(|xi|^4)).
    """
    A = ad(xi)
    eye = jnp.eye(6, dtype=xi.dtype)
    return eye - 0.5 * A + (1.0 / 12.0) * _mm(A, A)
