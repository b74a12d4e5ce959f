"""Camera math: look/look_at bases, spherical eyes, projections.

Functional equivalents of the reference's camera layer:
* ``look_at``      — gendr/functional/look_at.py:11-68
* ``look``         — gendr/functional/look.py:11-56
* ``get_points_from_angles`` — gendr/functional/get_points_from_angles.py:11-29
* ``perspective`` / ``orthogonal`` — gendr/transform.py:14-45
* ``Projection`` / ``LookAt`` / ``Look`` — gendr/transform.py:48-168

All functions are pure jnp (vmappable, jittable); the classes are thin
stateful wrappers mirroring the reference's nn.Module API so the experiment
scripts port 1:1.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def _as_array(v, like_batch=None):
    v = jnp.asarray(v, jnp.float32)
    if v.ndim == 1 and like_batch is not None:
        v = jnp.broadcast_to(v[None, :], (like_batch, v.shape[0]))
    return v


def _normalize(v, eps=1e-5):
    # torch.nn.functional.normalize semantics: v / max(||v||, eps)
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(n, eps)


def get_points_from_angles(distance, elevation, azimuth, degrees=True):
    """Spherical -> cartesian eye positions (get_points_from_angles.py:11-29).

    Scalar inputs produce a length-3 tuple-like array; batched tensors produce
    [B, 3].
    """
    distance = jnp.asarray(distance, jnp.float32)
    elevation = jnp.asarray(elevation, jnp.float32)
    azimuth = jnp.asarray(azimuth, jnp.float32)
    if degrees:
        elevation = elevation * (math.pi / 180.0)
        azimuth = azimuth * (math.pi / 180.0)
    pts = jnp.stack([
        distance * jnp.cos(elevation) * jnp.sin(azimuth),
        distance * jnp.sin(elevation),
        -distance * jnp.cos(elevation) * jnp.cos(azimuth),
    ], axis=-1)
    return pts


def look_at(vertices, eye, at=(0, 0, 0), up=(0, 1, 0), only_rotate=False):
    """Right-handed look-at basis; rotates (and translates) vertices into
    camera space (look_at.py:51-66). vertices: [B, nv, 3]."""
    if vertices.ndim != 3:
        raise ValueError('vertices Tensor should have 3 dimensions')
    b = vertices.shape[0]
    eye = _as_array(eye, b)
    at = _as_array(at, b)
    up = _as_array(up, b)

    z_axis = _normalize(at - eye)
    x_axis = _normalize(jnp.cross(up, z_axis))
    y_axis = _normalize(jnp.cross(z_axis, x_axis))
    r = jnp.stack([x_axis, y_axis, z_axis], axis=1)  # [B, 3, 3]

    if not only_rotate:
        vertices = vertices - eye[:, None, :]
    # HIGHEST: a reduced-precision matmul (TF32 on a GPU) would quantize
    # vertex coordinates (~1e-3 relative) and poison every geometry
    # gradient downstream
    return jnp.einsum('bnk,bjk->bnj', vertices, r,
                      precision=jax.lax.Precision.HIGHEST)


def look(vertices, eye, direction=(0, 1, 0), up=(0, 1, 0)):
    """Camera basis from a viewing direction (look.py:11-56).

    The reference's ``up`` default is None and crashes if omitted (quirk,
    look.py:38); we default to (0, 1, 0).
    """
    if vertices.ndim != 3:
        raise ValueError('vertices Tensor should have 3 dimensions')
    b = vertices.shape[0]
    eye = _as_array(eye, b)
    direction = _as_array(direction, b)
    up = _as_array(up, b)

    z_axis = _normalize(direction)
    x_axis = _normalize(jnp.cross(up, z_axis))
    y_axis = _normalize(jnp.cross(z_axis, x_axis))
    r = jnp.stack([x_axis, y_axis, z_axis], axis=1)

    vertices = vertices - eye[:, None, :]
    # HIGHEST: see look_at
    return jnp.einsum('bnk,bjk->bnj', vertices, r,
                      precision=jax.lax.Precision.HIGHEST)


def perspective(vertices, angle=30.0):
    """Divide x,y by z*tan(angle) (transform.py:14-29). ``angle`` in degrees;
    may be a scalar or a per-batch [B] array (opt_camera.py:29-43)."""
    if vertices.ndim != 3:
        raise ValueError('vertices Tensor should have 3 dimensions')
    angle = jnp.asarray(angle, jnp.float32) * (math.pi / 180.0)
    width = jnp.tan(angle)
    width = jnp.reshape(width, (-1, 1))  # [1 or B, 1]
    z = vertices[:, :, 2]
    x = vertices[:, :, 0] / z / width
    y = vertices[:, :, 1] / z / width
    return jnp.stack((x, y, z), axis=2)


def orthogonal(vertices, scale=1.0):
    """Orthogonal projection (transform.py:32-45)."""
    if vertices.ndim != 3:
        raise ValueError('vertices Tensor should have 3 dimensions')
    scale = jnp.asarray(scale, jnp.float32)
    z = vertices[:, :, 2]
    x = vertices[:, :, 0] * scale
    y = vertices[:, :, 1] * scale
    return jnp.stack((x, y, z), axis=2)


def projection(vertices, P, dist_coeffs=None, orig_size=512):
    """3x4 projection matrix with OpenCV-style lens distortion
    (transform.py:85-106). P: [B, 3, 4]."""
    P = jnp.asarray(P, jnp.float32)
    b = vertices.shape[0]
    if dist_coeffs is None:
        dist_coeffs = jnp.zeros((P.shape[0], 5), jnp.float32)
    dist_coeffs = jnp.asarray(dist_coeffs, jnp.float32)

    ones = jnp.ones_like(vertices[:, :, :1])
    vh = jnp.concatenate([vertices, ones], axis=-1)  # [B, nv, 4]
    v = jnp.einsum('bnk,bjk->bnj', vh, P,
                   precision=jax.lax.Precision.HIGHEST)  # [B, nv, 3]
    x, y, z = v[:, :, 0], v[:, :, 1], v[:, :, 2]
    x_ = x / (z + 1e-5)
    y_ = y / (z + 1e-5)
    k1, k2, p1, p2, k3 = [dist_coeffs[:, None, i] for i in range(5)]
    r = jnp.sqrt(x_ ** 2 + y_ ** 2)
    radial = 1 + k1 * r ** 2 + k2 * r ** 4 + k3 * r ** 6
    x__ = x_ * radial + 2 * p1 * x_ * y_ + p2 * (r ** 2 + 2 * x_ ** 2)
    y__ = y_ * radial + p1 * (r ** 2 + 2 * y_ ** 2) + 2 * p2 * x_ * y_
    x__ = 2 * (x__ - orig_size / 2.0) / orig_size
    y__ = 2 * (y__ - orig_size / 2.0) / orig_size
    return jnp.stack([x__, y__, z], axis=-1)


# ---------------------------------------------------------------------------
# Stateful wrappers (API parity with gendr.Transform subclasses)
# ---------------------------------------------------------------------------

class Transform:
    """Base: transforms a Mesh's vertices, returns a new Mesh
    (transform.py:48-61)."""

    def transform(self, vertices):
        raise NotImplementedError

    def __call__(self, mesh):
        return mesh.with_vertices(self.transform(mesh.vertices))

    forward = __call__


class LookAt(Transform):
    """transform.py:109-138."""

    def __init__(self, perspective=True, viewing_angle=30, viewing_scale=1.0,
                 eye=None):
        self.perspective = perspective
        self.viewing_angle = viewing_angle
        self.viewing_scale = viewing_scale
        if eye is None:
            eye = [0, 0, -(1.0 / math.tan(math.radians(viewing_angle)) + 1)]
        self._eye = eye

    def set_eyes_from_angles(self, distances, elevations, azimuths):
        self._eye = get_points_from_angles(distances, elevations, azimuths)

    def set_eyes(self, eyes):
        self._eye = eyes

    @property
    def eyes(self):
        return self._eye

    def transform(self, vertices):
        vertices = look_at(vertices, self._eye)
        if self.perspective:
            return perspective(vertices, angle=self.viewing_angle)
        return orthogonal(vertices, scale=self.viewing_scale)


class Look(Transform):
    """transform.py:141-168."""

    def __init__(self, camera_direction=(0, 0, 1), perspective=True,
                 viewing_angle=30, viewing_scale=1.0, eye=None):
        self.perspective = perspective
        self.viewing_angle = viewing_angle
        self.viewing_scale = viewing_scale
        self.camera_direction = camera_direction
        if eye is None:
            eye = [0, 0, -(1.0 / math.tan(math.radians(viewing_angle)) + 1)]
        self._eye = eye

    def set_eyes(self, eyes):
        self._eye = eyes

    def transform(self, vertices):
        vertices = look(vertices, self._eye, self.camera_direction)
        if self.perspective:
            return perspective(vertices, angle=self.viewing_angle)
        return orthogonal(vertices, scale=self.viewing_scale)


class Projection(Transform):
    """transform.py:64-106."""

    def __init__(self, P, dist_coeffs=None, orig_size=512):
        self.P = np.asarray(P, np.float32)
        if self.P.ndim != 3 or self.P.shape[1:] != (3, 4):
            raise ValueError(
                'You need to provide a valid (batch_size)x3x4 projection '
                'matrix')
        self.dist_coeffs = dist_coeffs
        self.orig_size = orig_size

    def transform(self, vertices):
        return projection(vertices, self.P, self.dist_coeffs, self.orig_size)
