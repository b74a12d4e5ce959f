"""Core mesh tensor ops: gathers and normals.

JAX equivalents of the reference's functional layer:
* ``face_vertices`` — gendr/functional/face_vertices.py:9-27 (there a
  flattened batch-offset gather; here a vmapped take, which XLA lowers to a
  single batched gather).
* ``vertex_normals`` — gendr/functional/vertex_normals.py:10-46 (there three
  ``index_add_`` scatters; here one ``segment_sum``, a scatter-add that
  XLA:GPU, like the reference, sums with atomics).
* ``surface_normals`` — gendr/mesh.py:105-109.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def face_vertices(vertices: jnp.ndarray, faces: jnp.ndarray) -> jnp.ndarray:
    """Gather per-face vertex attributes.

    vertices: [B, nv, D] float; faces: [B, nf, 3] int -> [B, nf, 3, D].
    """
    assert vertices.ndim == 3 and faces.ndim == 3 and faces.shape[2] == 3
    return jax.vmap(lambda v, f: v[f])(vertices, faces)


def _face_cross_products(vertices, faces):
    """Per-face, per-corner cross products (area-weighted normals), matching
    the reference's corner convention (vertex_normals.py:33-44):
    corner k gets cross(v_{k+2}-v_k, v_{k+1}-v_k)... specifically
      at faces[:,1]: cross(v2-v1, v0-v1)
      at faces[:,2]: cross(v0-v2, v1-v2)
      at faces[:,0]: cross(v1-v0, v2-v0)
    """
    fv = face_vertices(vertices, faces)  # [B, nf, 3, 3]
    v0, v1, v2 = fv[:, :, 0], fv[:, :, 1], fv[:, :, 2]
    n0 = jnp.cross(v1 - v0, v2 - v0)
    n1 = jnp.cross(v2 - v1, v0 - v1)
    n2 = jnp.cross(v0 - v2, v1 - v2)
    return n0, n1, n2


def vertex_normals(vertices: jnp.ndarray, faces: jnp.ndarray) -> jnp.ndarray:
    """Area-weighted vertex normals. [B,nv,3] x [B,nf,3] -> [B,nv,3]."""
    assert vertices.ndim == 3 and faces.ndim == 3
    nv = vertices.shape[1]
    n0, n1, n2 = _face_cross_products(vertices, faces)

    def accum(f, a0, a1, a2):
        idx = jnp.concatenate([f[:, 0], f[:, 1], f[:, 2]])
        val = jnp.concatenate([a0, a1, a2], axis=0)
        return jax.ops.segment_sum(val, idx, num_segments=nv)

    normals = jax.vmap(accum)(faces, n0, n1, n2)
    norm = jnp.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / jnp.maximum(norm, 1e-6)


def surface_normals(vertices: jnp.ndarray, faces: jnp.ndarray) -> jnp.ndarray:
    """Unit face normals, reference convention cross(v2-v1, v0-v1)
    (mesh.py:105-109). [B,nf,3]."""
    fv = face_vertices(vertices, faces)
    v10 = fv[:, :, 0] - fv[:, :, 1]
    v12 = fv[:, :, 2] - fv[:, :, 1]
    n = jnp.cross(v12, v10)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.maximum(norm, 1e-6)
