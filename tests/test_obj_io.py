"""OBJ/MTL I/O roundtrips and texture (un)baking."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from gendr_jax import data
from gendr_jax.geometry import obj_io
from gendr_jax.geometry.mesh import Mesh


def test_save_load_roundtrip(tmp_path):
    v, f = data.icosphere(1)
    path = str(tmp_path / 'mesh.obj')
    obj_io.save_obj(path, v, f)
    v2, f2 = obj_io.load_obj(path)
    np.testing.assert_allclose(np.asarray(v2), v, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(f2), f)


def test_mesh_class_roundtrip(tmp_path):
    v, f = data.test_meshes('cube')
    mesh = Mesh.create(v, f)
    path = str(tmp_path / 'cube.obj')
    mesh.save_obj(path)
    mesh2 = Mesh.from_obj(path)
    np.testing.assert_allclose(np.asarray(mesh2.vertices),
                               np.asarray(mesh.vertices), atol=1e-6)


def test_normalization(tmp_path):
    v, f = data.test_meshes('cube')
    v = v * 3.0 + 5.0
    path = str(tmp_path / 'c.obj')
    obj_io.save_obj(path, v, f)
    v2, _ = obj_io.load_obj(path, normalization=True)
    v2 = np.asarray(v2)
    assert np.abs(v2).max() <= 1.0 + 1e-5


def test_quad_triangulation(tmp_path):
    path = str(tmp_path / 'quad.obj')
    with open(path, 'w') as fh:
        fh.write('v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n')
        fh.write('f 1 2 3 4\n')  # quad -> 2 triangles (fan)
    v, f = obj_io.load_obj(path)
    assert np.asarray(f).shape == (2, 3)
    np.testing.assert_array_equal(np.asarray(f), [[0, 1, 2], [0, 2, 3]])


def test_textured_pipeline(tmp_path):
    """mtl Kd colors + map_Kd texture image sampling
    (load_obj.py:33-106 / load_textures CUDA kernel)."""
    import imageio.v2 as imageio
    # 8x8 texture: left half red, right half green
    img = np.zeros((8, 8, 3), np.uint8)
    img[:, :4] = [255, 0, 0]
    img[:, 4:] = [0, 255, 0]
    imageio.imsave(str(tmp_path / 'tex.png'), img)
    with open(tmp_path / 'm.mtl', 'w') as fh:
        fh.write('newmtl mat_tex\nmap_Kd tex.png\n')
        fh.write('newmtl mat_blue\nKd 0.0 0.0 1.0\n')
    with open(tmp_path / 'mesh.obj', 'w') as fh:
        fh.write('mtllib m.mtl\n')
        fh.write('v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n')
        fh.write('vt 0.1 0.5\nvt 0.2 0.5\nvt 0.15 0.6\n')
        fh.write('vt 0.9 0.5\nvt 0.95 0.5\nvt 0.9 0.6\n')
        fh.write('usemtl mat_tex\n')
        fh.write('f 1/1 2/2 3/3\n')   # left of texture -> red
        fh.write('f 2/4 4/5 3/6\n')   # right of texture -> green
        fh.write('usemtl mat_blue\n')
        fh.write('f 1 2 4\n')          # constant blue
    v, f, tex = obj_io.load_obj(str(tmp_path / 'mesh.obj'),
                                load_texture=True, texture_res=2)
    tex = np.asarray(tex)
    assert tex.shape == (3, 4, 3)
    # face 0 red-dominant, face 1 green-dominant, face 2 exactly blue
    assert tex[0, :, 0].mean() > 0.8 and tex[0, :, 1].mean() < 0.2
    assert tex[1, :, 1].mean() > 0.8 and tex[1, :, 0].mean() < 0.2
    np.testing.assert_allclose(tex[2], np.broadcast_to([0, 0, 1], (4, 3)),
                               atol=1e-6)


def test_save_textured_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    v, f = data.test_meshes('cube')
    tex = rng.rand(f.shape[0], 4, 3).astype(np.float32)  # R=2
    path = str(tmp_path / 'textured.obj')
    obj_io.save_obj(path, v, f, textures=tex, texture_res=8)
    assert os.path.exists(str(tmp_path / 'textured.png'))
    assert os.path.exists(str(tmp_path / 'textured.mtl'))
    v2, f2, tex2 = obj_io.load_obj(path, load_texture=True, texture_res=2)
    # colors survive the bake -> sample roundtrip approximately
    err = np.abs(np.asarray(tex2).mean(axis=1) - tex.mean(axis=1)).max()
    assert err < 0.25, err


def test_vertex_color_obj(tmp_path):
    path = str(tmp_path / 'vc.obj')
    with open(path, 'w') as fh:
        fh.write('v 0 0 0 1 0 0\nv 1 0 0 0 1 0\nv 0 1 0 0 0 1\n')
        fh.write('f 1 2 3\n')
    v, f, tex = obj_io.load_obj(path, load_texture=True,
                                texture_type='vertex')
    np.testing.assert_allclose(np.asarray(tex), np.eye(3), atol=1e-6)


def test_save_voxel(tmp_path):
    vox = np.zeros((4, 4, 4), np.int32)
    vox[1, 2, 3] = 1
    path = str(tmp_path / 'vox.obj')
    obj_io.save_voxel(path, vox)
    v, f = obj_io.load_obj(path)
    assert np.asarray(v).shape == (1, 3)


def test_wrapped_uv_texture_load(tmp_path):
    """UV coordinates > 1 wrap modulo 1 exactly like the reference
    (load_obj.py:76) — real assets (e.g. the panda OBJ) tile textures this
    way.  A face with vt = base + 1 must sample the identical texels as the
    in-range face."""
    import imageio.v2 as imageio
    rng = np.random.RandomState(3)
    img = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
    imageio.imsave(str(tmp_path / 'tex.png'), img)
    with open(str(tmp_path / 'mat.mtl'), 'w') as fh:
        fh.write('newmtl m0\nmap_Kd tex.png\n')

    def write_obj(name, uv_offset):
        path = str(tmp_path / name)
        with open(path, 'w') as fh:
            fh.write('mtllib mat.mtl\n')
            fh.write('v 0 0 0\nv 1 0 0\nv 0 1 0\n')
            for (u, vv) in [(0.1, 0.2), (0.6, 0.25), (0.3, 0.7)]:
                fh.write(f'vt {u + uv_offset} {vv + uv_offset}\n')
            fh.write('usemtl m0\nf 1/1 2/2 3/3\n')
        return path

    _, _, tex_base = obj_io.load_obj(write_obj('a.obj', 0.0),
                                     load_texture=True, texture_res=3)
    _, _, tex_wrap = obj_io.load_obj(write_obj('b.obj', 1.0),
                                     load_texture=True, texture_res=3)
    np.testing.assert_allclose(np.asarray(tex_wrap), np.asarray(tex_base),
                               atol=1e-6)
    # and the samples really came from the image, not the default white
    assert np.asarray(tex_base).std() > 0.01
