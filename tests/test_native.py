"""Native C++ OBJ tokenizer vs the pure-Python parser."""

import numpy as np
import pytest

from gendr_jax.geometry import obj_io
from gendr_jax.native import objparse


OBJ_TEXT = """# comment
mtllib scene.mtl
v 0.0 0.0 0.0
v 1.0 0.0 0.5
v 1.0 1.0 -0.25
v 0.0 1.0 0.125
vt 0.1 0.2
vt 0.9 0.2
vt 0.9 0.8
vt 0.1 0.8
usemtl red
f 1/1 2/2 3/3
usemtl blue
f 1/1 3/3 4/4
f 1 2 3 4
f 1//2 2//3 3//1
"""


def test_native_matches_python():
    native = objparse.parse_obj_native(OBJ_TEXT)
    if native is None:
        pytest.skip('native toolchain unavailable')
    py = obj_io._parse_obj_python(OBJ_TEXT.splitlines(True))
    np.testing.assert_allclose(native['vertices'], py['vertices'])
    np.testing.assert_array_equal(native['faces'], py['faces'])
    np.testing.assert_array_equal(native['tex_faces'], py['tex_faces'])
    np.testing.assert_allclose(native['vt'], py['vt'])
    assert native['mtllib'] == py['mtllib'] == 'scene.mtl'
    assert native['face_materials'] == py['face_materials']


def test_native_vertex_colors():
    text = 'v 0 0 0 1 0 0\nv 1 0 0 0 1 0\nv 0 1 0 0 0 1\nf 1 2 3\n'
    native = objparse.parse_obj_native(text)
    if native is None:
        pytest.skip('native toolchain unavailable')
    np.testing.assert_allclose(native['vertex_colors'], np.eye(3))


def test_native_speed_sanity():
    """The native path should beat the Python splitter comfortably."""
    import time
    native_ok = objparse.parse_obj_native('v 0 0 0\n') is not None
    if not native_ok:
        pytest.skip('native toolchain unavailable')
    lines = []
    rng = np.random.RandomState(0)
    for i in range(20000):
        x, y, z = rng.rand(3)
        lines.append(f'v {x:.6f} {y:.6f} {z:.6f}\n')
    for i in range(0, 19998, 3):
        lines.append(f'f {i+1} {i+2} {i+3}\n')
    text = ''.join(lines)
    t0 = time.perf_counter()
    objparse.parse_obj_native(text)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    obj_io._parse_obj_python(lines)
    t_python = time.perf_counter() - t0
    assert t_native < t_python, (t_native, t_python)
