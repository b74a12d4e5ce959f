"""Textured-mesh render sweep over distributions x tau (softmax RGB).

Counterpart of animations/panda_dist.py: anti-aliased softmax-RGB renders of
a textured mesh across the canonical distribution zoo with
gamma = 10^-2.5, eps = 10^-3, dist_eps = 10 (panda_dist.py:98-107).

    python animations/panda_dist.py --resolution 256 --quick
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import gendr_jax
from animations.common import (SIGMOID_FUNCTIONS, textured_scene,
                               composite_on_background, save_png)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--resolution', type=int, default=768)
    ap.add_argument('--texture-res', type=int, default=5)
    ap.add_argument('--out-dir', type=str, default='./results/panda')
    ap.add_argument('--quick', action='store_true')
    ap.add_argument('--backend', type=str, default=None)
    args = ap.parse_args()

    backend = args.backend  # None: the platform's own raster backend

    mesh = textured_scene(args.texture_res)
    transform = gendr_jax.LookAt()
    lighting = gendr_jax.Lighting()
    transform.set_eyes_from_angles(3.0, 20.0, 180.0)
    mesh = transform(lighting(mesh))
    fv = mesh.face_vertices
    tex = mesh.face_textures

    log_taus = np.arange(-6, 1, 1.0 if args.quick else 0.025)
    gamma, eps, dist_eps = 10 ** -2.5, 10 ** -3, 10 ** 10

    dists = SIGMOID_FUNCTIONS[:2] if args.quick else SIGMOID_FUNCTIONS
    for dist_id, (dist_func, dist_shape) in enumerate(dists):
        renderer = gendr_jax.GenDR(
            image_size=args.resolution, anti_aliasing=True,
            dist_func=dist_func, dist_shape=dist_shape, dist_shift=0.,
            dist_eps=dist_eps, aggr_alpha_func='probabilistic',
            aggr_alpha_t_conorm_p=0., aggr_rgb_func='softmax',
            aggr_rgb_gamma=gamma, aggr_rgb_eps=eps, backend=backend)

        @jax.jit
        def render_tau(fv, tex, tau):
            renderer.dist_scale = tau
            return renderer.forward_tensors(fv, tex)

        import time
        t0 = time.time()
        for tau_idx, log_tau in enumerate(log_taus):
            images = jax.block_until_ready(
                render_tau(fv, tex, jnp.float32(10 ** log_tau)))
            if tau_idx == 0:
                print(f'  compile+first frame: {time.time()-t0:.1f}s')
                t0 = time.time()
            save_png(os.path.join(
                args.out_dir,
                f'panda_dist_{dist_id}_0_t{tau_idx:03d}.png'),
                composite_on_background(images))
        nsteady = max(len(log_taus) - 1, 1)
        print(f'dist {dist_func} (shape={dist_shape}): '
              f'{len(log_taus)} frames, '
              f'{(time.time()-t0)/nsteady*1e3:.0f} ms/frame steady-state '
              f'(render+fetch+png)')


if __name__ == '__main__':
    main()
