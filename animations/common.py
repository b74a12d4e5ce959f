"""Shared setup for the animation / regression-sweep scripts.

Counterparts of the reference's animations/ directory: render a known scene
across the full distribution x t-conorm x tau x p configuration grid.  These
sweeps are the reference's de-facto visual regression suite (SURVEY.md §4).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax.numpy as jnp

import gendr_jax
from gendr_jax import data

# the reference's canonical distribution sweep (panda_dist.py:50-61)
SIGMOID_FUNCTIONS = [
    ('uniform', 0),
    ('gaussian', 0),
    ('logistic', 0),
    ('laplace', 0),
    ('cubic_hermite', 0),
    ('cauchy', 0),
    ('gamma', 2.),
    ('gamma', .5),
    ('gamma_rev', 2.),
    ('gamma_rev', .5),
]

# the canonical t-conorm sweep (panda_tcn.py:63-76)
T_CONORMS = [
    ('max', 0.),
    ('probabilistic', 0.),
    ('einstein', 0.),
    ('yager', .5), ('yager', 1.), ('yager', 2.), ('yager', 4.),
    ('aczel_alsina', .5), ('aczel_alsina', 1.), ('aczel_alsina', 2.),
    ('aczel_alsina', 4.),
]


def triangle_scene():
    """A single triangle in view (triangles_dist.py's subject)."""
    verts = np.array([[-0.6, -0.5, 2.0], [0.7, -0.4, 2.5],
                      [0.0, 0.7, 3.0]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    return gendr_jax.Mesh.create(verts, faces)


def textured_scene(texture_res=5):
    """Stand-in for the textured panda: a textured icosphere with a
    procedural color pattern (the reference's panda OBJ is a binary asset;
    pass GENDR_PANDA_OBJ to use a real mesh)."""
    path = os.environ.get('GENDR_PANDA_OBJ')
    if path and os.path.exists(path):
        mesh = gendr_jax.Mesh.from_obj(path, load_texture=True,
                                       texture_res=texture_res,
                                       texture_type='surface')
        v = np.asarray(mesh.vertices)
        v = v - v[0].min(0)[None, None]
        v = v / np.abs(v).max()
        v = v * 2 - v[0].max(0)[None, None]
        return gendr_jax.Mesh.create(v[0], mesh.faces[0], mesh.textures,
                                     texture_res, 'surface')
    v, f = data.icosphere(3)
    nf = f.shape[0]
    tex = np.zeros((nf, texture_res ** 2, 3), np.float32)
    centers = v[f].mean(1)
    tex[:, :, 0] = 0.5 + 0.5 * np.sin(6 * centers[:, 0])[:, None]
    tex[:, :, 1] = 0.5 + 0.5 * np.cos(6 * centers[:, 1])[:, None]
    tex[:, :, 2] = 0.6
    return gendr_jax.Mesh.create(v * 0.8, f, tex[None], texture_res,
                                 'surface')


def composite_on_background(images, bg=(66 / 255, 145 / 255, 0.0)):
    """Alpha-composite RGBA renders onto the reference's green background
    (panda_dist.py:110)."""
    img = np.asarray(images)[0].transpose(1, 2, 0)
    rgb, a = img[..., :3], img[..., 3:]
    out = a * rgb + (1 - a) * np.asarray(bg).reshape(1, 1, 3)
    return (255 * np.clip(out, 0, 1)).astype(np.uint8)


def save_png(path, arr):
    import imageio.v2 as imageio
    os.makedirs(os.path.dirname(path), exist_ok=True)
    imageio.imsave(path, arr)
