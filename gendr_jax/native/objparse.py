"""ctypes bindings for the native OBJ tokenizer (objparse.cpp).

Builds the shared library on first use (g++ -O3); every entry point returns
None when the toolchain or library is unavailable so callers fall back to
the pure-Python parser.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, 'libobjparse.so')
_SRC = os.path.join(_HERE, 'objparse.cpp')
_lock = threading.Lock()
_lib = None
_failed = False


class _ObjResult(ctypes.Structure):
    _fields_ = [
        ('vertices', ctypes.POINTER(ctypes.c_float)),
        ('num_vertices', ctypes.c_int64),
        ('colors', ctypes.POINTER(ctypes.c_float)),
        ('vt', ctypes.POINTER(ctypes.c_float)),
        ('num_vt', ctypes.c_int64),
        ('faces', ctypes.POINTER(ctypes.c_int32)),
        ('tex_faces', ctypes.POINTER(ctypes.c_int32)),
        ('face_material', ctypes.POINTER(ctypes.c_int32)),
        ('num_faces', ctypes.c_int64),
        ('mtllib', ctypes.c_char_p),
        ('materials', ctypes.c_char_p),
        ('handle', ctypes.c_void_p),
    ]


def _build():
    subprocess.run(
        ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', _SRC, '-o', _SO],
        check=True, capture_output=True)


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if not os.path.exists(_SO) or (
                    os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_SO)
            lib.obj_parse.restype = ctypes.POINTER(_ObjResult)
            lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.obj_free.restype = None
            lib.obj_free.argtypes = [ctypes.POINTER(_ObjResult)]
            _lib = lib
        except Exception as e:  # toolchain missing etc. -> python fallback
            print(f'[gendr_jax.native] objparse unavailable: {e}',
                  file=sys.stderr)
            _failed = True
    return _lib


def parse_obj_native(text: str):
    """Parse OBJ text; returns the same dict as obj_io._parse_obj_python or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode('utf-8')
    res_p = lib.obj_parse(raw, len(raw))
    try:
        res = res_p.contents
        nv = res.num_vertices
        nf = res.num_faces
        nvt = res.num_vt
        vertices = np.ctypeslib.as_array(
            res.vertices, shape=(nv, 3)).copy() if nv else \
            np.zeros((0, 3), np.float32)
        colors = None
        if res.colors and nv:
            colors = np.ctypeslib.as_array(res.colors,
                                           shape=(nv, 3)).copy()
        vt = np.ctypeslib.as_array(
            res.vt, shape=(nvt, 2)).copy() if nvt else \
            np.zeros((0, 2), np.float32)
        faces = np.ctypeslib.as_array(
            res.faces, shape=(nf, 3)).copy() if nf else \
            np.zeros((0, 3), np.int32)
        tex_faces = np.ctypeslib.as_array(
            res.tex_faces, shape=(nf, 3)).copy() if nf else \
            np.zeros((0, 3), np.int32)
        fmat = np.ctypeslib.as_array(
            res.face_material, shape=(nf,)).copy() if nf else \
            np.zeros((0,), np.int32)
        mtllib = res.mtllib.decode('utf-8') or None
        mat_table = res.materials.decode('utf-8').split('\n') \
            if res.materials else []
        face_materials = [mat_table[i] if 0 <= i < len(mat_table) else ''
                          for i in fmat]
        return dict(vertices=vertices, faces=faces, tex_faces=tex_faces,
                    vt=vt, vertex_colors=colors, mtllib=mtllib,
                    face_materials=face_materials)
    finally:
        lib.obj_free(res_p)
