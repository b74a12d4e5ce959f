"""Per-face preprocessing: barycentric inverse, Gram matrix, obtuse flags.

Vectorized equivalent of ``forward_render_inv_cuda_kernel``
(generalized_renderer_cuda_kernel.cu:620-676).  One fused elementwise pass
over [B, F]; output layout matches the reference's 27-float faces_info
``[inv*9, sym*9, obt*3]`` (functional/renderer.py:139) so the same tensor can
be saved as a backward residual.
"""

from __future__ import annotations

import jax.numpy as jnp

from gendr_jax import config as C


def faces_info(face_vertices: jnp.ndarray) -> jnp.ndarray:
    """face_vertices: [B, F, 9] (xyz per vertex) -> faces_info [B, F, 27]."""
    f = face_vertices
    x0, y0 = f[..., 0], f[..., 1]
    x1, y1 = f[..., 3], f[..., 4]
    x2, y2 = f[..., 6], f[..., 7]

    # adjugate rows (cu:645-648)
    inv_star = jnp.stack([
        y1 - y2, x2 - x1, x1 * y2 - x2 * y1,
        y2 - y0, x0 - x2, x2 * y0 - x0 * y2,
        y0 - y1, x1 - x0, x0 * y1 - x1 * y0,
    ], axis=-1)
    det = (x2 * (y0 - y1) + x0 * (y1 - y2) + x1 * (y2 - y0))
    det = jnp.where(det > 0, jnp.maximum(det, C.DET_EPS),
                    jnp.minimum(det, -C.DET_EPS))  # cu:653
    inv = inv_star / det[..., None]

    # Gram matrix F F^T + 1 on the xy coords (cu:659-665)
    xs = jnp.stack([x0, x1, x2], axis=-1)
    ys = jnp.stack([y0, y1, y2], axis=-1)
    sym = (xs[..., :, None] * xs[..., None, :]
           + ys[..., :, None] * ys[..., None, :] + 1.0)
    sym = sym.reshape(sym.shape[:-2] + (9,))

    # obtuse-corner flags (cu:667-675); at most one corner can be obtuse so
    # the reference's `break` is redundant
    def obt(ax, ay, bx, by, cx, cy):
        return (((bx - ax) * (cx - ax) + (by - ay) * (cy - ay)) < 0)
    o0 = obt(x0, y0, x1, y1, x2, y2)
    o1 = obt(x1, y1, x2, y2, x0, y0)
    o2 = obt(x2, y2, x0, y0, x1, y1)
    obt_flags = jnp.stack([o0, o1, o2], axis=-1).astype(f.dtype)

    return jnp.concatenate([inv, sym, obt_flags], axis=-1)
