"""Camera-pose recovery from silhouettes.

JAX counterpart of the reference experiment
(experiments/opt_camera.py): a batch of 200 candidate poses
[distance, elevation, azimuth, fov] is optimized to match a hard-rendered
goal silhouette, with tau annealed over np.logspace(-1, -7) across the run
(opt_camera.py:291-293).  The pose batch is pure data parallelism: one
jitted Adam step renders all poses at once, and tau is a traced argument so
annealing never recompiles.

Usage:
    python experiments/opt_camera.py -sq --gif --quick
"""

from __future__ import annotations

import argparse
import functools
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
from gendr_jax.geometry import transforms as T
from experiments.common import iou_loss, mse_loss, make_grid, GifWriter, \
    load_or_make_mesh, use_compile_cache


def transform_cameras(vertices, poses, additional_poses=None):
    """Apply pose batch [N,4] = (distance, elev, azim, fov) to vertices
    (opt_camera.py:46-65): optional extra rotation by the GT poses, then
    look_at from the candidate eyes and per-pose perspective."""
    if additional_poses is not None:
        extra_eyes = T.get_points_from_angles(
            additional_poses[:, 0], additional_poses[:, 1],
            additional_poses[:, 2])
        vertices = T.look_at(vertices, extra_eyes, only_rotate=True)
    eyes = T.get_points_from_angles(poses[:, 0], poses[:, 1], poses[:, 2])
    vertices = T.look_at(vertices, eyes)
    vertices = T.perspective(vertices, poses[:, 3])
    return vertices


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--dist-func', type=str, default='logistic')
    parser.add_argument('--aggr-func', type=str, default='probabilistic')
    parser.add_argument('--dist_shape', type=float, default=0.)
    parser.add_argument('--dist_shift', type=float, default=0.)
    parser.add_argument('--t_conorm_p', type=float, default=0.)
    parser.add_argument('-sq', '--squared', action='store_true')
    parser.add_argument('--model_obj', type=str, default='teapot.obj')
    parser.add_argument('-lr', '--learning-rate', type=float, default=0.3)
    parser.add_argument('-ni', '--num-iterations', type=int, default=1000)
    parser.add_argument('-is', '--image-size', type=int, default=64)
    parser.add_argument('-bs', '--batch-size', type=int, default=200)
    parser.add_argument('-de', '--dist-eps', type=float, default=100)
    parser.add_argument('-lo', '--losses', type=str, nargs='+',
                        default=['iou'])
    parser.add_argument('-gif', '--gif', action='store_true')
    parser.add_argument('--chain', type=int, default=20,
                        help='iterations chained on-device per dispatch '
                        '(amortizes the host round trip; forced to 1 with '
                        '--gif, which samples frames every 20 steps)')
    parser.add_argument('--backend', type=str, default=None)
    parser.add_argument('--quick', action='store_true')
    parser.add_argument('--out-dir', type=str, default='./results')
    args = parser.parse_args()
    use_compile_cache()

    if args.quick:
        # shrink, but never override an explicitly smaller CLI value
        args.num_iterations = min(args.num_iterations, 50)
        args.batch_size = min(args.batch_size, 16)

    backend = args.backend  # None: the platform's own raster backend
    os.makedirs(args.out_dir, exist_ok=True)
    data_dir = os.environ.get('GENDR_DATA_DIR')

    seed = 0
    rng = np.random.RandomState(seed + 1)
    B = args.batch_size

    lighting = gendr_jax.Lighting()
    diff_renderer = gendr_jax.GenDR(
        image_size=args.image_size, dist_func=args.dist_func,
        dist_scale=1.0, dist_squared=args.squared,
        dist_shape=args.dist_shape, dist_shift=args.dist_shift,
        dist_eps=args.dist_eps, aggr_alpha_func=args.aggr_func,
        aggr_alpha_t_conorm_p=args.t_conorm_p, aggr_rgb_func='hard',
        backend=backend, channels='alpha')
    hard_renderer = gendr_jax.GenDR(
        image_size=args.image_size, dist_func=0, dist_scale=1e-4,
        dist_squared=True, dist_shape=0., dist_shift=0., dist_eps=10,
        aggr_alpha_func=0, aggr_alpha_t_conorm_p=0., aggr_rgb_func='hard',
        backend=backend, channels='alpha')

    mv, mf = load_or_make_mesh(args.model_obj, data_dir)
    base_mesh = gendr_jax.Mesh.create(mv, mf).repeat(B)

    # GT poses (opt_camera.py:180-185)
    poses_gt = np.zeros((B, 4), np.float32)
    poses_gt[:, 0] = 2.5 + rng.rand(B) * 1.5
    poses_gt[:, 1] = rng.randn(B) * 60
    poses_gt[:, 2] = rng.randn(B) * 60
    poses_gt[:, 3] = 20.0
    poses_gt = jnp.asarray(poses_gt)

    def render(renderer, poses, dist_scale=None, additional_poses=None):
        mesh = lighting(base_mesh)
        verts = transform_cameras(mesh.vertices, poses, additional_poses)
        mesh = gendr_jax.Mesh.create(verts, mesh.faces, mesh.textures,
                                     mesh.texture_res, mesh.texture_type)
        if dist_scale is not None:
            renderer.dist_scale = dist_scale
        return renderer(mesh)

    print('Generating goals...')
    goal = jax.jit(lambda p: render(hard_renderer, p))(poses_gt)
    goal = jnp.asarray(np.asarray(goal))
    print('done.')

    threshold = 5.0

    def init_poses(rng2, a_min, a_max):
        poses = np.zeros((B, 4), np.float32)
        poses[:, 0] = 2.0 + rng2.rand(B) * 8.0
        poses[:, 1] = rng2.randn(B)
        poses[:, 2] = rng2.randn(B)
        ang = np.sqrt(poses[:, 1] ** 2 + poses[:, 2] ** 2)
        initial = a_min + rng2.rand(B) * (a_max - a_min)
        poses[:, 1] *= initial / ang
        poses[:, 2] *= initial / ang
        poses[:, 3] = 10.0 + rng2.rand(B) * 20.0
        return jnp.asarray(poses)

    opt = optax.adam(1.0, b1=0.5, b2=0.99)

    def make_loss(loss_name):
        def loss_fn(poses, sigma):
            pred = render(diff_renderer, poses, dist_scale=sigma,
                          additional_poses=poses_gt)
            if loss_name == 'mse':
                # opt_camera.py:25-26: sum over batch, mean over pixels
                l = jnp.mean(jnp.sum((pred[:, 3] - goal[:, 3]) ** 2,
                                     axis=0))
            else:
                l = iou_loss(pred[:, 3], goal[:, 3], reduce='sum')
            return l, pred
        return loss_fn

    def execute_setting(a_min, a_max, loss_name, gif_path=None):
        loss_fn = make_loss(loss_name)

        def step_body(poses, opt_state, sigma, lr):
            (l, pred), g = jax.value_and_grad(loss_fn, has_aux=True)(
                poses, sigma)
            updates, opt_state = opt.update(g, opt_state)
            updates = jax.tree_util.tree_map(lambda u: u * lr, updates)
            poses = optax.apply_updates(poses, updates)
            return poses, opt_state, l, pred

        step = jax.jit(step_body)

        @jax.jit
        def step_block(poses, opt_state, sigmas_blk, lr):
            # tau annealing rides the scan xs: one dispatch per block
            def one(carry, sigma):
                poses, opt_state = carry
                poses, opt_state, l, _ = step_body(
                    poses, opt_state, sigma, lr)
                return (poses, opt_state), l
            (poses, opt_state), ls = jax.lax.scan(
                one, (poses, opt_state), sigmas_blk)
            return poses, opt_state, ls

        rng2 = np.random.RandomState(seed)
        poses = init_poses(rng2, a_min, a_max)
        opt_state = opt.init(poses)
        sigmas = np.logspace(-1, -7, args.num_iterations)
        writer = GifWriter(gif_path) if gif_path else None
        chain = 1 if writer else max(1, args.chain)
        # compile warmup on throwaway state (keeps jit time out of the
        # reported iters_per_sec)
        if chain > 1 and args.num_iterations >= chain:
            _w = step_block(poses, opt_state,
                            jnp.asarray(sigmas[:chain], jnp.float32),
                            jnp.float32(args.learning_rate))
            np.asarray(_w[2])
        else:
            _w = step(poses, opt_state, jnp.float32(sigmas[0]),
                      jnp.float32(args.learning_rate))
            np.asarray(_w[2])
        t0 = time.time()
        lr = jnp.float32(args.learning_rate)
        i = 0
        while i < args.num_iterations:
            n_blk = min(chain, args.num_iterations - i)
            if chain > 1:
                # the tail runs as one shorter scan (a second compile beats
                # per-step dispatches)
                poses, opt_state, ls = step_block(
                    poses, opt_state,
                    jnp.asarray(sigmas[i:i + n_blk], jnp.float32), lr)
                ls = np.asarray(ls)
                n_done = n_blk
            else:
                poses, opt_state, l, pred = step(
                    poses, opt_state, jnp.float32(sigmas[i]), lr)
                ls = np.asarray(l)[None]
                n_done = 1
                if writer and i % 20 == 0:
                    gx, gy = (4, B // 4) if B % 4 == 0 else (1, B)
                    writer.append(make_grid(np.asarray(pred)[:, 3],
                                            np.asarray(goal)[:, 3], gx, gy))
            stop = False
            for j in range(n_done):
                if (i + j) % 100 == 0:
                    lv = float(ls[j])
                    print(f'  iter {i + j}: loss {lv:.4f} '
                          f'sigma {sigmas[i + j]:.2e}')
            if not np.all(np.isfinite(ls)):
                print('Stopping the loop because loss is NaN.')
                stop = True
            i += n_done
            if stop:
                break
        if writer:
            writer.close()
        dt = time.time() - t0
        p = np.asarray(poses)
        success = (p[:, 1] ** 2 + p[:, 2] ** 2) < threshold ** 2
        setting = f'a{a_min}-{a_max}-l{loss_name}'
        print({f'{setting}_success_{int(threshold)}':
               float(success.mean()),
               'iters_per_sec': round(i / dt, 2)})
        return float(success.mean())

    initial_angles = [(15, 35), (35, 55), (55, 75)]
    if args.quick:
        initial_angles = [(15, 35)]

    results = {}
    for a_min, a_max in initial_angles:
        for loss_name in args.losses:
            res = execute_setting(a_min, a_max, loss_name)
            results[(a_min, a_max, loss_name)] = res
            if args.gif:
                execute_setting(
                    a_min, a_max, loss_name,
                    gif_path=os.path.join(
                        args.out_dir, 'opt_camera_a{}-{}-l{}_{}.gif'.format(
                            a_min, a_max, loss_name,
                            os.path.basename(
                                args.model_obj).split('.')[0])))
    return results


if __name__ == '__main__':
    main()
