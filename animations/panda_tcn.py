"""Textured-mesh sweep over the 11 t-conorm configs x tau.

Counterpart of animations/panda_tcn.py (and triangles_tcn.py via
--triangle): max / probabilistic / einstein / yager p in {.5,1,2,4} /
aczel_alsina p in {.5,1,2,4} at a fixed uniform distribution.
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
from animations.common import (T_CONORMS, textured_scene, triangle_scene,
                               composite_on_background, save_png)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--resolution', type=int, default=768)
    ap.add_argument('--out-dir', type=str, default='./results/tcn')
    ap.add_argument('--quick', action='store_true')
    ap.add_argument('--triangle', action='store_true')
    ap.add_argument('--sweep-p', action='store_true',
                    help='sweep the t-conorm parameter p instead of tau '
                         '(panda_tcn_p.py: p in 2^[-4,4] at fixed tau)')
    ap.add_argument('--backend', type=str, default=None)
    args = ap.parse_args()

    backend = args.backend  # None: the platform's own raster backend

    if args.triangle:
        mesh = triangle_scene()
    else:
        mesh = textured_scene(5)
        transform = gendr_jax.LookAt()
        transform.set_eyes_from_angles(3.0, 20.0, 180.0)
        mesh = transform(gendr_jax.Lighting()(mesh))
    fv = mesh.face_vertices
    tex = mesh.face_textures

    if args.sweep_p:
        # p sweep for the parametric t-conorms (panda_tcn_p.py:63-67)
        tcns = [('hamacher', None), ('yager', None),
                ('aczel_alsina', None)]
        log2_ps = np.arange(-4, 4, 1.0 if args.quick else 0.025)
        for tcn_id, (tcn, _) in enumerate(tcns):
            renderer = gendr_jax.GenDR(
                image_size=args.resolution, anti_aliasing=True,
                dist_func='uniform', dist_shape=0., dist_shift=0.,
                aggr_alpha_func=tcn, aggr_alpha_t_conorm_p=1.0,
                dist_scale=10 ** -1.5, backend=backend)

            @jax.jit
            def render_p(fv, tex, p):
                renderer.aggr_alpha_t_conorm_p = p
                return renderer.forward_tensors(fv, tex)

            for p_idx, lp in enumerate(log2_ps):
                images = render_p(fv, tex, jnp.float32(2.0 ** lp))
                save_png(os.path.join(
                    args.out_dir,
                    f'tcn_p_{tcn}_{p_idx:03d}.png'),
                    composite_on_background(images))
            print(f'tcn {tcn}: {len(log2_ps)} p-frames')
        return

    log_taus = np.arange(-6, 1, 1.0 if args.quick else 0.025)
    tcns = T_CONORMS[:2] if args.quick else T_CONORMS
    for tcn_id, (tcn, p) in enumerate(tcns):
        renderer = gendr_jax.GenDR(
            image_size=args.resolution, anti_aliasing=True,
            dist_func='uniform', dist_shape=0., dist_shift=0.,
            aggr_alpha_func=tcn, aggr_alpha_t_conorm_p=p,
            backend=backend)

        @jax.jit
        def render_tau(fv, tex, tau):
            renderer.dist_scale = tau
            return renderer.forward_tensors(fv, tex)

        for tau_idx, log_tau in enumerate(log_taus):
            images = render_tau(fv, tex, jnp.float32(10 ** log_tau))
            save_png(os.path.join(
                args.out_dir,
                f'tcn_{tcn_id}_t{tau_idx:03d}.png'),
                composite_on_background(images))
        print(f'tcn {tcn} (p={p}): {len(log_taus)} frames')


if __name__ == '__main__':
    main()
