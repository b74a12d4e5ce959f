"""Shared experiment utilities (losses, image grids, GIF writing).

Counterparts of the helpers at the top of the reference experiment scripts
(experiments/opt_shape.py:20-47, opt_camera.py:18-96,
train_reconstruction.py:30-67).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_compile_cache():
    """Keep compiled programs where $JAX_COMPILATION_CACHE_DIR says (JAX
    reads it itself), else in the checkout's .jax_cache/."""
    if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        import jax
        jax.config.update('jax_compilation_cache_dir', os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            '.jax_cache'))


def iou_loss(predict, target, reduce='mean'):
    """1 - IoU per batch element (opt_shape.py:20-24 / opt_camera.py:18-22:
    the two scripts differ only in the final reduction)."""
    dims = tuple(range(1, predict.ndim))
    intersect = jnp.sum(predict * target, dims)
    union = jnp.sum(predict + target - predict * target, dims) + 1e-6
    per = 1.0 - intersect / union
    return jnp.mean(per) if reduce == 'mean' else jnp.sum(per)


def mse_loss(predict, target):
    return jnp.mean((predict - target) ** 2)


def make_grid(pred, target, grid_x, grid_y):
    """Tile predicted/target silhouettes side by side into a uint8 image
    (opt_shape.py:31-47)."""
    pred = np.asarray(pred)
    target = np.asarray(target)
    rows = []
    j = 0
    for _ in range(grid_y):
        row = []
        for _ in range(grid_x):
            row.append(pred[j])
            row.append(target[j])
            j += 1
        rows.append(np.concatenate(row, 1))
    img = np.concatenate(rows, 0)
    return (255 * np.clip(img, 0, 1)).astype(np.uint8)


class GifWriter:
    def __init__(self, path):
        import imageio.v2 as imageio
        self.writer = imageio.get_writer(path, mode='I')

    def append(self, frame):
        self.writer.append_data(frame)

    def close(self):
        self.writer.close()


def load_or_make_mesh(model_obj, data_dir=None):
    """Load an OBJ by path; fall back to procedural stand-ins for the
    reference's binary assets (sphere_642/1352 regenerate exactly by
    tessellation class; airplane/teapot fall back to a cube)."""
    from gendr_jax import data
    from gendr_jax.geometry import obj_io

    name = os.path.basename(model_obj)
    candidates = [model_obj]
    if data_dir:
        candidates.append(os.path.join(data_dir, name))
    for path in candidates:
        if os.path.exists(path):
            return obj_io.load_obj(path)
    if name.startswith('sphere_'):
        n = int(name.split('_')[1].split('.')[0])
        v, f = data.sphere(n)
        return jnp.asarray(v), jnp.asarray(f)
    v, f = data.test_meshes('cube')
    print(f'[gendr_jax] asset {model_obj} not found; using procedural cube',
          file=sys.stderr)
    return jnp.asarray(v), jnp.asarray(f)
