"""Solid voxelization tests (surface rasterize + flood-fill interior)."""

import numpy as np
import jax.numpy as jnp

from gendr_jax import data
from gendr_jax.geometry import core, voxelize
from gendr_jax.geometry.mesh import Mesh


def test_sphere_is_solid():
    v, f = data.icosphere(3)
    mesh = Mesh.create(v * 0.4, f)  # reference convention: verts in [-0.5, 0.5]
    vox = np.asarray(mesh.voxelize(32))
    assert vox.shape == (1, 32, 32, 32)
    vol = vox.sum()
    # solid ball of radius ~0.45*32: volume ~ 4/3 pi r^3
    r = 0.4 * 31  # radius in voxels (the vs/(vs-1)+0.5 mapping of mesh.py:125)
    expect = 4 / 3 * np.pi * (0.4 * 32) ** 3
    assert 0.7 * expect < vol < 1.3 * expect, (vol, expect)
    # center is filled (only a solid fill can do that)
    assert vox[0, 16, 16, 16] == 1
    # corners are empty
    assert vox[0, 0, 0, 0] == 0 and vox[0, -1, -1, -1] == 0


def test_cube_is_solid_box():
    v, f = data.test_meshes('cube')
    v = v * (0.45 / 0.6)  # keep inside the [-0.5, 0.5] convention
    fv = core.face_vertices(jnp.asarray(v)[None], jnp.asarray(f)[None])
    vs = 32
    fv_n = fv * vs / (vs - 1) + 0.5
    vox = np.asarray(voxelize.voxelization(fv_n, vs, False))
    vol = vox.sum()
    side = 0.9 * vs * vs / (vs - 1)
    expect = side ** 3
    assert 0.75 * expect < vol < 1.35 * expect, (vol, expect)
    assert vox[0, 16, 16, 16] == 1


def test_open_surface_stays_hollow_free():
    # a single large triangle: no interior, only surface cells
    tri = np.array([[[0.2, 0.2, 0.5], [0.8, 0.2, 0.5],
                     [0.2, 0.8, 0.5]]], np.float32)[None]
    vox = np.asarray(voxelize.voxelization(jnp.asarray(tri), 16, False))
    assert vox.sum() > 0
    # thin sheet: much less than any solid
    assert vox.sum() < 16 ** 3 * 0.2
