"""Mesh regularization losses: uniform Laplacian and dihedral flatness.

API/semantics parity with gendr/losses.py:11-120, but in JAX:
* ``LaplacianLoss`` — the reference materializes a dense nv x nv matrix and
  does a dense matmul (losses.py:17-36, O(nv^2) memory).  Here the uniform
  Laplacian is applied as a sparse gather + segment_sum (O(E)); numerically
  identical: L x = x - mean of neighbor vertices.
* ``FlattenLoss`` — the reference builds the edge -> opposite-vertex tables
  with an O(E*F) Python loop (losses.py:52-71); here a dict pass, same
  tables, identical forward math (losses.py:78-120).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


class LaplacianLoss:
    """||L x||^2 with the row-normalized uniform graph Laplacian."""

    def __init__(self, vertex, faces, average=False):
        faces = np.asarray(faces)
        self.nv = int(np.asarray(vertex).shape[0])
        self.nf = int(faces.shape[0])
        self.average = average

        # undirected unique edges from the triangle list
        edges = set()
        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            edges.add((min(a, b), max(a, b)))
            edges.add((min(b, c), max(b, c)))
            edges.add((min(a, c), max(a, c)))
        e = np.array(sorted(edges), np.int32)
        # both directions: row i gathers neighbor j
        self.rows = jnp.asarray(np.concatenate([e[:, 0], e[:, 1]]))
        self.cols = jnp.asarray(np.concatenate([e[:, 1], e[:, 0]]))
        deg = np.zeros(self.nv, np.float32)
        np.add.at(deg, e[:, 0], 1)
        np.add.at(deg, e[:, 1], 1)
        self.deg = jnp.asarray(np.maximum(deg, 1.0))

    def __call__(self, x):
        """x: [B, nv, 3] -> per-batch loss [B] (losses.py:34-42)."""
        import jax
        neighbor_sum = jax.vmap(
            lambda xv: jax.ops.segment_sum(xv[self.cols], self.rows,
                                           num_segments=self.nv))(x)
        lap = x - neighbor_sum / self.deg[None, :, None]
        loss = jnp.sum(lap ** 2, axis=(1, 2))
        if self.average:
            return jnp.sum(loss) / x.shape[0]
        return loss

    forward = __call__


class FlattenLoss:
    """Penalize (cos(dihedral) + 1)^2 across interior edges."""

    def __init__(self, faces, average=False):
        faces = np.asarray(faces)
        self.nf = int(faces.shape[0])
        self.average = average

        # Edge set exactly as the reference builds it (losses.py:52): sorted
        # tuples of the (f0,f1) and (f1,f2) vertex pairs of every face.
        edge_set = set()
        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            edge_set.add((min(a, b), max(a, b)))
            edge_set.add((min(b, c), max(b, c)))

        # Opposite vertices come from *all* faces containing both endpoints,
        # in face order (losses.py:58-69) — built here with a dict pass
        # instead of the reference's O(E*F) scan.
        opposite = {e: [] for e in edge_set}
        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            for (e, opp) in (((min(a, b), max(a, b)), c),
                             ((min(b, c), max(b, c)), a),
                             ((min(a, c), max(a, c)), b)):
                if e in opposite:
                    opposite[e].append(opp)

        # The reference assumes a closed manifold (exactly 2 incident faces
        # per edge); for open meshes we drop boundary edges from the loss.
        v0s, v1s, v2s, v3s = [], [], [], []
        for (u, v) in sorted(edge_set):
            opps = opposite[(u, v)]
            if len(opps) < 2:
                continue
            v0s.append(u)
            v1s.append(v)
            v2s.append(opps[0])
            v3s.append(opps[1])
        self.v0s = jnp.asarray(np.array(v0s, np.int32))
        self.v1s = jnp.asarray(np.array(v1s, np.int32))
        self.v2s = jnp.asarray(np.array(v2s, np.int32))
        self.v3s = jnp.asarray(np.array(v3s, np.int32))

    def __call__(self, vertices, eps=1e-6):
        """vertices: [B, nv, 3] -> [B].

        The dihedral angle across each interior edge is measured between the
        two wing vertices' rejections from the shared edge (numerics per
        reference losses.py:78-120: every norm/divide is eps-regularized and
        the rejection length is taken as |wing| sin(angle) rather than the
        norm of the rejection vector itself).
        """
        edge_a = vertices[:, self.v1s, :] - vertices[:, self.v0s, :]
        edge_sq = jnp.sum(edge_a ** 2, -1)
        edge_len = jnp.sqrt(edge_sq + eps)

        def edge_rejection(wing_idx):
            """Component of (wing - v0) perpendicular to the shared edge,
            and its regularized length."""
            wing = vertices[:, wing_idx, :] - vertices[:, self.v0s, :]
            wing_sq = jnp.sum(wing ** 2, -1)
            wing_len = jnp.sqrt(wing_sq + eps)
            proj = jnp.sum(edge_a * wing, -1)
            cos_w = proj / (edge_len * wing_len + eps)
            sin_w = jnp.sqrt(1 - cos_w ** 2 + eps)
            rej = wing - edge_a * (proj / (edge_sq + eps))[:, :, None]
            return rej, wing_len * sin_w

        rej2, len2 = edge_rejection(self.v2s)
        rej3, len3 = edge_rejection(self.v3s)
        cos_dihedral = jnp.sum(rej2 * rej3, -1) / (len2 * len3 + eps)
        loss = jnp.sum((cos_dihedral + 1) ** 2, axis=1)
        if self.average:
            return jnp.sum(loss) / vertices.shape[0]
        return loss

    forward = __call__
