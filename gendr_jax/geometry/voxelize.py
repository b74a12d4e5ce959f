"""Solid voxelization: mesh -> occupancy grid, fully on device.

JAX equivalent of the reference's 4-kernel CUDA pipeline + host
fixpoint loop (gendr/cuda/voxelization_cuda_kernel.cu:36-194,
gendr/functional/voxelization.py:10-62):

* surface rasterization along the 3 axes (``voxelize_sub1``) — here a
  vectorized [B, vs^2, F] barycentric test + deterministic max-scatter;
* vertex-cell marking (``voxelize_sub2``) — a scatter;
* outside-seeding (``voxelize_sub3``) and the 6-neighbor flood fill
  (``voxelize_sub4``) — here a ``lax.while_loop`` whose body is a 3D
  dilation (three 1-step shifts), removing the reference's per-iteration
  device->host sync on ``visible.sum()`` (functional/voxelization.py:37-43).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _rasterize_axis(faces, vs):
    """One axis pass of voxelize_sub1 (cu:36-91).

    faces: [B, F, 3, 3] with coords already permuted so that the kernel's
    (c0, c1, c2) mapping holds: grid 'y' tests coord 0, 'x' coord 1, depth
    coord 2.  Returns [B, vs, vs, vs] int32 occupancy in (c0, c1, c2) order.
    """
    B, F = faces.shape[:2]
    g = jnp.arange(vs, dtype=jnp.float32)
    yy, xx = jnp.meshgrid(g, g, indexing='ij')  # [vs, vs]
    yy = yy.reshape(-1)
    xx = xx.reshape(-1)
    P = vs * vs

    f0 = faces[:, :, 0, :]  # [B, F, 3]
    y1d = faces[:, :, 1, 0] - f0[:, :, 0]
    x1d = faces[:, :, 1, 1] - f0[:, :, 1]
    z1d = faces[:, :, 1, 2] - f0[:, :, 2]
    y2d = faces[:, :, 2, 0] - f0[:, :, 0]
    x2d = faces[:, :, 2, 1] - f0[:, :, 1]
    z2d = faces[:, :, 2, 2] - f0[:, :, 2]

    ypd = yy[None, :, None] - f0[:, None, :, 0]  # [B, P, F]
    xpd = xx[None, :, None] - f0[:, None, :, 1]
    det = (x1d * y2d - x2d * y1d)[:, None, :]
    det_ok = det != 0
    det_safe = jnp.where(det_ok, det, 1.0)
    t1 = (y2d[:, None, :] * xpd - x2d[:, None, :] * ypd) / det_safe
    t2 = (-y1d[:, None, :] * xpd + x1d[:, None, :] * ypd) / det_safe
    hit = det_ok & (t1 >= 0) & (t2 >= 0) & (t1 + t2 <= 1)
    zi = jnp.floor(t1 * z1d[:, None, :] + t2 * z2d[:, None, :]
                   + f0[:, None, :, 2]).astype(jnp.int32)

    yi = jnp.broadcast_to(yy.astype(jnp.int32)[None, :, None], hit.shape)
    xi = jnp.broadcast_to(xx.astype(jnp.int32)[None, :, None], hit.shape)

    vox = jnp.zeros((B, vs, vs, vs), jnp.int32)

    def scatter(vox, dy, dx):
        y = yi + dy
        x = xi + dx
        ok = hit & (y >= 0) & (y < vs) & (x >= 0) & (x < vs) \
            & (zi >= 0) & (zi < vs)
        # route invalid entries to a dropped index
        y_ = jnp.where(ok, y, 0)
        x_ = jnp.where(ok, x, 0)
        z_ = jnp.where(ok, zi, 0)
        upd = ok.astype(jnp.int32)
        return jax.vmap(
            lambda v, a, b, c, u: v.at[a, b, c].max(u))(
                vox, y_.reshape(B, -1), x_.reshape(B, -1),
                z_.reshape(B, -1), upd.reshape(B, -1))

    # the CUDA kernel also marks the (y-1, x), (y, x-1), (y-1, x-1)
    # neighbors (cu:78-90)
    vox = scatter(vox, 0, 0)
    vox = scatter(vox, -1, 0)
    vox = scatter(vox, 0, -1)
    vox = scatter(vox, -1, -1)
    return vox


def voxelize_surface(faces, vs):
    """sub1 over the 3 axis permutations + sub2 vertex marking, OR-combined
    (functional/voxelization.py:53-59)."""
    B, F = faces.shape[:2]
    # dim=2 (identity), dim=0 ([2,1,0]), dim=1 ([0,2,1]); each result is then
    # transposed back (functional/voxelization.py:19)
    v2 = _rasterize_axis(faces, vs)                       # (c0,c1,c2)
    v0 = _rasterize_axis(faces[..., [2, 1, 0]], vs)
    v0 = jnp.swapaxes(v0, 1, 3)                           # undo permutation
    v1 = _rasterize_axis(faces[..., [0, 2, 1]], vs)
    v1 = jnp.swapaxes(v1, 2, 3)

    # sub2: vertex cells (cu:95-121)
    verts = faces.reshape(B, F * 3, 3)
    vi = jnp.floor(verts).astype(jnp.int32)
    ok = jnp.all((vi >= 0) & (vi < vs), axis=-1)
    vi = jnp.where(ok[..., None], vi, 0)
    v3 = jax.vmap(lambda v, idx, u: v.at[idx[:, 0], idx[:, 1],
                                         idx[:, 2]].max(u))(
        jnp.zeros((B, vs, vs, vs), jnp.int32), vi, ok.astype(jnp.int32))

    return ((v0 + v1 + v2 + v3) > 0).astype(jnp.int32)


def _dilate6(visible):
    """One 6-neighborhood dilation step on int32 [B, vs, vs, vs]."""
    v = visible
    out = v
    zero = jnp.zeros((), v.dtype)
    for axis in (1, 2, 3):
        out = out | jnp.roll(v, 1, axis).at[
            (slice(None),) + (slice(None),) * (axis - 1) + (0,)].set(zero)
        out = out | jnp.roll(v, -1, axis).at[
            (slice(None),) + (slice(None),) * (axis - 1) + (-1,)].set(zero)
    return out


def fill_interior(voxels):
    """sub3 + sub4 fixpoint: flood 'visible' (outside air) inward from the
    boundary through empty cells; solid = 1 - visible
    (cu:124-194, functional/voxelization.py:29-43)."""
    vs = voxels.shape[1]
    empty = voxels == 0

    idx = jnp.arange(vs)
    boundary = ((idx == 0) | (idx == vs - 1))
    bmask = (boundary[:, None, None] | boundary[None, :, None]
             | boundary[None, None, :])
    empty_i = empty.astype(jnp.int32)
    visible = (empty & bmask[None]).astype(jnp.int32)

    def cond(state):
        visible, prev_count = state
        return jnp.sum(visible) != prev_count

    def body(state):
        visible, _ = state
        count = jnp.sum(visible)
        # interior empty cells adjacent to a visible cell become visible;
        # sub4 only updates interior cells, but dilating into boundary cells
        # is harmless because boundary empties are already seeded
        visible = visible | (_dilate6(visible) & empty_i)
        return visible, count

    visible, _ = jax.lax.while_loop(
        cond, body, (visible, jnp.asarray(-1, jnp.int64 if
                                          jax.config.jax_enable_x64 else
                                          jnp.int32)))
    return 1 - visible


def voxelization(faces, size, normalize=False):
    """Full pipeline (functional/voxelization.py:46-62).

    faces: [B, F, 3, 3] face vertices in [0, 1]^3 (scaled by ``size`` unless
    ``normalize``); returns [B, size, size, size] int32 solid occupancy.
    """
    faces = jnp.asarray(faces, jnp.float32)
    if not normalize:
        faces = faces * size
    surface = voxelize_surface(faces, size)
    return fill_interior(surface)
