"""SE(2) pose algebra on [..., 3] (x, y, theta) arrays.

The reference composes poses with ad-hoc trig inside its Python loops
(SURVEY.md §4.1, §4.4); here the ops are closed-form, broadcastable, and
jit/vmap-safe so they can live inside `lax.scan` bodies and vmapped
code. theta is always wrapped to (-pi, pi].
"""

from __future__ import annotations

import jax.numpy as jnp


def wrap_angle(theta):
    """Wrap to (-pi, pi]."""
    return jnp.mod(theta + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def compose(a, b):
    """a ⊕ b: apply pose b expressed in a's frame. Shapes broadcast."""
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bth = b[..., 0], b[..., 1], b[..., 2]
    c, s = jnp.cos(ath), jnp.sin(ath)
    return jnp.stack(
        [
            ax + c * bx - s * by,
            ay + s * bx + c * by,
            wrap_angle(ath + bth),
        ],
        axis=-1,
    )


def inverse(a):
    """a⁻¹ such that compose(a, inverse(a)) = identity."""
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    c, s = jnp.cos(ath), jnp.sin(ath)
    return jnp.stack(
        [
            -(c * ax + s * ay),
            -(-s * ax + c * ay),
            wrap_angle(-ath),
        ],
        axis=-1,
    )


def between(a, b):
    """a⁻¹ ⊕ b: pose of b expressed in a's frame (odometry delta)."""
    return compose(inverse(a), b)


def transform_points(pose, pts):
    """Apply pose ([..., 3]) to points ([..., N, 2]) in the pose frame."""
    x, y, th = pose[..., 0:1], pose[..., 1:2], pose[..., 2:3]
    c, s = jnp.cos(th), jnp.sin(th)
    px, py = pts[..., 0], pts[..., 1]
    return jnp.stack(
        [x + c * px - s * py, y + s * px + c * py],
        axis=-1,
    )


def rotate_points(theta, pts):
    """Rotate points ([..., N, 2]) by theta ([...])."""
    c = jnp.cos(theta)[..., None]
    s = jnp.sin(theta)[..., None]
    px, py = pts[..., 0], pts[..., 1]
    return jnp.stack([c * px - s * py, s * px + c * py], axis=-1)


def error_se2(xi, xj, zij):
    """Pose-graph edge error t2v(Z⁻¹ · (Xi⁻¹ · Xj)) (SURVEY.md §4.4)."""
    return between(zij, between(xi, xj))
