"""Multi-view silhouette shape optimization.

JAX counterpart of the reference experiment
(experiments/opt_shape.py): a sphere template is deformed to match 24
hard-rendered target silhouettes per view set; the whole optimization step
(model -> lighting -> look_at -> differentiable render -> IoU/MSE +
Laplacian + flatten regularizers -> Adam update) is one jitted function, and
tau (dist_scale) is a *traced* argument so the lr x sigma grid search
(opt_shape.py:326-337) never recompiles.

Usage:
    python experiments/opt_shape.py -sq --gif --quick
"""

from __future__ import annotations

import argparse
import functools
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import optax

import gendr_jax
from gendr_jax import data
from experiments.common import (iou_loss, mse_loss, make_grid, GifWriter,
                                load_or_make_mesh, use_compile_cache)


class ShapeModel:
    """Sigmoid-reparametrized displacement + tanh centroid on a sphere
    template (opt_shape.py:50-87)."""

    def __init__(self, num_vertices=642):
        v, f = data.sphere(num_vertices)
        self.base_vertices = jnp.asarray(v) * 0.5
        self.faces = jnp.asarray(f)
        self.laplacian = gendr_jax.LaplacianLoss(np.asarray(
            self.base_vertices), np.asarray(self.faces))
        self.flatten = gendr_jax.FlattenLoss(np.asarray(self.faces))

    def init_params(self):
        return dict(displace=jnp.zeros_like(self.base_vertices)[None],
                    center=jnp.zeros((1, 1, 3), jnp.float32))

    def __call__(self, params, batch_size):
        vb = self.base_vertices[None]
        base = jnp.log(jnp.abs(vb) / (1 - jnp.abs(vb)))
        centroid = jnp.tanh(params['center'])
        vertices = jax.nn.sigmoid(base + params['displace']) * jnp.sign(vb)
        vertices = jax.nn.relu(vertices) * (1 - centroid) \
            - jax.nn.relu(-vertices) * (centroid + 1)
        vertices = vertices + centroid

        lap = jnp.mean(self.laplacian(vertices))
        flat = jnp.mean(self.flatten(vertices))
        verts = jnp.tile(vertices, (batch_size, 1, 1))
        faces = jnp.tile(self.faces[None], (batch_size, 1, 1))
        return verts, faces, lap, flat


def build_renderers(args, backend):
    diff_renderer = gendr_jax.GenDR(
        image_size=args.image_size,
        dist_func=args.dist_func,
        dist_scale=1.0,  # traced at call time via dist_scale kwarg
        dist_squared=args.squared,
        dist_shape=args.dist_shape,
        dist_shift=args.dist_shift,
        dist_eps=args.dist_eps,
        aggr_alpha_func=args.aggr_func,
        aggr_alpha_t_conorm_p=args.t_conorm_p,
        aggr_rgb_func='hard',
        backend=backend,
        channels='alpha',  # silhouette-only fast path
    )
    hard_renderer = gendr_jax.GenDR(
        image_size=args.image_size,
        dist_func=0, dist_scale=1e-4, dist_squared=True, dist_shape=0.,
        dist_shift=0., dist_eps=1, aggr_alpha_func=0,
        aggr_alpha_t_conorm_p=0., aggr_rgb_func='hard', backend=backend,
        channels='alpha',
    )
    return diff_renderer, hard_renderer


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--dist-func', type=str, default='logistic')
    parser.add_argument('--aggr-func', type=str, default='probabilistic')
    parser.add_argument('--dist_shape', type=float, default=0.)
    parser.add_argument('--dist_shift', type=float, default=0.)
    parser.add_argument('--t_conorm_p', type=float, default=0.)
    parser.add_argument('-sq', '--squared', action='store_true')
    parser.add_argument('--model_obj', type=str, default='airplane.obj')
    parser.add_argument('-op', '--optimizer-choice', type=str,
                        default='adam')
    parser.add_argument('-ni', '--num-iterations', type=int, default=100)
    parser.add_argument('-nv', '--num-vertices', type=int, default=642,
                        choices=[642, 1352])
    parser.add_argument('-is', '--image-size', type=int, default=64)
    parser.add_argument('-de', '--dist-eps', type=float, default=100)
    parser.add_argument('-lo', '--loss', type=str, default='iou',
                        choices=['mse', 'iou'])
    parser.add_argument('-lt', '--loss-threshold', type=float, default=.1)
    parser.add_argument('-cr', '--criterion', type=str, default='loss',
                        choices=['loss', 'steps_to_threshold'])
    parser.add_argument('-gif', '--gif', action='store_true')
    parser.add_argument('--chain', type=int, default=10,
                        help='iterations chained on-device per dispatch '
                        '(amortizes the host round trip; 1 = step-by-step; '
                        'forced to 1 with --gif, which needs every frame)')
    parser.add_argument('--backend', type=str, default=None)
    parser.add_argument('--quick', action='store_true',
                        help='tiny grid for smoke testing')
    parser.add_argument('--views', type=str, nargs='+',
                        default=['24@-60', '24@-30', '24@0', '24@30',
                                 '24@60'])
    parser.add_argument('--out-dir', type=str, default='./results')
    args = parser.parse_args()
    use_compile_cache()

    backend = args.backend  # None: the platform's own raster backend
    os.makedirs(args.out_dir, exist_ok=True)

    data_dir = os.environ.get('GENDR_DATA_DIR')
    sil_loss_fn = mse_loss if args.loss == 'mse' else iou_loss

    lighting = gendr_jax.Lighting()
    transform = gendr_jax.LookAt(viewing_angle=15)
    diff_renderer, hard_renderer = build_renderers(args, backend)

    # ---- generate goals: hard-render 120 views of the target mesh
    # (opt_shape.py:162-181)
    all_cameras = data.camera_grid()
    tv, tf = load_or_make_mesh(args.model_obj, data_dir)
    tmesh = gendr_jax.Mesh.create(tv, tf).repeat(len(all_cameras))
    transform.set_eyes_from_angles(all_cameras[:, 0], all_cameras[:, 1],
                                   all_cameras[:, 2])
    print('Generating goals...')
    # one jitted dispatch: eager execution would issue every prepass op
    # separately
    all_images = np.asarray(jax.jit(
        lambda m: hard_renderer(transform(lighting(m)))[:, 3])(tmesh))
    print('done. all_images.shape', all_images.shape)

    model = ShapeModel(args.num_vertices)
    nv_cams = 24

    def render_pred(params, eyes, dist_scale):
        verts, faces, lap, flat = model(params, eyes.shape[0])
        mesh = gendr_jax.Mesh.create(verts, faces)
        mesh = lighting(mesh)
        transform.set_eyes(eyes)
        mesh = transform(mesh)
        diff_renderer.dist_scale = dist_scale
        images = diff_renderer(mesh)[:, 3]
        return images, lap, flat

    def loss_fn(params, eyes, targets, dist_scale):
        images, lap, flat = render_pred(params, eyes, dist_scale)
        sil = sil_loss_fn(images, targets)
        return sil + 0.03 * lap + 0.0003 * flat, images

    opt = optax.adam(1.0, b1=0.5, b2=0.95)  # lr injected via scale below

    def train_step(params, opt_state, eyes, targets, dist_scale, lr):
        (loss, images), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, eyes, targets, dist_scale)
        updates, opt_state = opt.update(grads, opt_state)
        updates = jax.tree_util.tree_map(lambda u: u * lr, updates)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, images

    def hard_eval(params, eyes, targets):
        verts, faces, _, _ = model(params, eyes.shape[0])
        mesh = gendr_jax.Mesh.create(verts, faces)
        transform.set_eyes(eyes)
        mesh = transform(lighting(mesh))
        images = hard_renderer(mesh)[:, 3]
        return sil_loss_fn(images, targets)

    train_step_jit = jax.jit(train_step)
    hard_eval_jit = jax.jit(hard_eval)

    @functools.partial(jax.jit, static_argnames='n')
    def train_block(params, opt_state, eyes, targets, dist_scale, lr, n):
        """n chained (train step + hard eval) pairs in one dispatch; the
        per-step hard losses come back as a vector for the host-side
        steps-to-threshold bookkeeping."""
        def one(carry, _):
            params, opt_state = carry
            params, opt_state, loss, _ = train_step(
                params, opt_state, eyes, targets, dist_scale, lr)
            h = hard_eval(params, eyes, targets)
            return (params, opt_state), h
        (params, opt_state), hs = jax.lax.scan(
            one, (params, opt_state), None, length=n)
        return params, opt_state, hs

    def execute_setting(lr, sigma, eyes, targets, gif_path=None):
        params = model.init_params()
        opt_state = opt.init(params)
        steps_to_threshold = int(1e10)
        hard_loss = 1e10
        writer = GifWriter(gif_path) if gif_path else None
        chain = 1 if writer else max(1, args.chain)
        i = 0
        while i < args.num_iterations:
            n = min(chain, args.num_iterations - i)
            if n > 1:
                params, opt_state, hs = train_block(
                    params, opt_state, eyes, targets,
                    jnp.float32(sigma), jnp.float32(lr), n)
                hs = np.asarray(hs)
            else:
                params, opt_state, loss, images = train_step_jit(
                    params, opt_state, eyes, targets,
                    jnp.float32(sigma), jnp.float32(lr))
                hs = np.asarray(hard_eval_jit(params, eyes, targets))[None]
                if writer:
                    writer.append(make_grid(images, targets, 4, 6))
            for j, h in enumerate(hs):
                hard_loss = min(hard_loss, float(h))
                if hard_loss < args.loss_threshold:
                    steps_to_threshold = min(i + j, steps_to_threshold)
            i += n
        if writer:
            writer.close()
        if args.criterion == 'loss':
            return hard_loss
        return steps_to_threshold

    results = {}
    for views in args.views:
        n, elev = views.split('@')
        j = {'-60': 0, '-30': 1, '0': 2, '30': 3, '60': 4}[elev]
        images = all_images[j * 24:(j + 1) * 24]
        cameras = all_cameras[j * 24:(j + 1) * 24]
        eyes = np.asarray(gendr_jax.functional.get_points_from_angles(
            cameras[:, 0], cameras[:, 1], cameras[:, 2]))
        targets = jnp.asarray(images)
        eyes = jnp.asarray(eyes)

        # lr x sigma grid search, then refine sigma (opt_shape.py:322-337)
        if args.quick:
            lrs = [10 ** -1.5]
            sigmas = np.logspace(-1, -3, 2)
        else:
            lrs = np.logspace(-1.25, -1.75, 3)
            sigmas = np.logspace(-1, -7, 7)

        best = [None, None, 1e10]
        # warm up the jitted steps so compile time stays out of the metric
        saved_ni = args.num_iterations
        args.num_iterations = max(1, args.chain)
        execute_setting(lrs[0], sigmas[0], eyes, targets)
        args.num_iterations = saved_ni
        t0 = time.time()
        n_runs = 0
        for lr in lrs:
            for sigma in sigmas:
                res = execute_setting(lr, sigma, eyes, targets)
                n_runs += 1
                if res < best[2]:
                    best = [lr, sigma, res]
        if best[0] is None:
            # steps_to_threshold and no setting ever crossed the threshold
            # (the reference would crash on log10(None) here): report the
            # miss instead of refining around nothing
            print({f'{args.criterion}_{views}': 'not reached',
                   'loss_threshold': args.loss_threshold})
            results[views] = best
            continue
        if not args.quick:
            rng = np.logspace(math.log10(best[1]) - 1,
                              math.log10(best[1]) + 1, 21)
            for sigma in rng:
                res = execute_setting(best[0], sigma, eyes, targets)
                n_runs += 1
                if res < best[2]:
                    best = [best[0], sigma, res]
        dt = time.time() - t0
        iters_per_sec = n_runs * args.num_iterations / dt
        print({f'learning_rate_{views}': best[0],
               f'sigma_{views}': best[1],
               f'{args.criterion}_{views}': best[2],
               'iters_per_sec': round(iters_per_sec, 1)})
        results[views] = best

        if args.gif:
            execute_setting(
                best[0], best[1], eyes, targets,
                gif_path=os.path.join(
                    args.out_dir, 'shape_{}_{}.gif'.format(
                        views, os.path.basename(
                            args.model_obj).split('.')[0])))
    return results


if __name__ == '__main__':
    main()
