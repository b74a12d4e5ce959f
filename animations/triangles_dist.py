"""Single-triangle render sweep over the 10 canonical distributions x tau.

Counterpart of animations/triangles_dist.py: the qualitative "zoo"
regression.  tau is a traced argument, so the whole sweep reuses one
compiled render per distribution.

    python animations/triangles_dist.py --resolution 256 --quick
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

import gendr_jax
from animations.common import (SIGMOID_FUNCTIONS, triangle_scene,
                               composite_on_background, save_png)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--resolution', type=int, default=768)
    ap.add_argument('--out-dir', type=str, default='./results/triangles')
    ap.add_argument('--quick', action='store_true')
    ap.add_argument('--dists', type=int, default=0,
                    help='limit to the first N distributions (0 = all)')
    ap.add_argument('--backend', type=str, default=None)
    args = ap.parse_args()

    backend = args.backend  # None: the platform's own raster backend
    mesh = triangle_scene()

    # tau sweep: 10^[-5, 2) step .025 (triangles_dist.py:48-74); --quick
    # coarsens the grid
    log_taus = np.arange(-5, 2, 0.5 if args.quick else 0.025)

    fv = mesh.face_vertices
    tex = mesh.face_textures
    import jax.numpy as jnp

    sweep = SIGMOID_FUNCTIONS[:args.dists] if args.dists \
        else SIGMOID_FUNCTIONS
    for dist_id, (dist_func, dist_shape) in enumerate(sweep):
        renderer = gendr_jax.GenDR(
            image_size=args.resolution, anti_aliasing=True,
            dist_func=dist_func, dist_shape=dist_shape, dist_shift=0.,
            aggr_alpha_func='probabilistic', aggr_alpha_t_conorm_p=0.,
            backend=backend)

        @jax.jit
        def render_tau(fv, tex, tau):
            renderer.dist_scale = tau  # traced: one compile per dist
            return renderer.forward_tensors(fv, tex)

        for tau_idx, log_tau in enumerate(log_taus):
            images = render_tau(fv, tex, jnp.float32(10 ** log_tau))
            frame = composite_on_background(images)
            save_png(os.path.join(
                args.out_dir,
                f'triangle_dist_{dist_id}_t{tau_idx:03d}.png'), frame)
        print(f'dist {dist_func} (shape={dist_shape}): '
              f'{len(log_taus)} frames')


if __name__ == '__main__':
    main()
