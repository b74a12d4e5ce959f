"""Benchmark: forward+backward render time on one configuration, on a GPU.

Times the jitted fwd+bwd step of the headline config by default: 256^2, a
1280-face mesh (642-vertex icosphere), uniform CDF x probabilistic
t-conorm, hard RGB.  Each step ends in ``block_until_ready``; the result
is the median of ``--iters`` warm steps after one compile-and-run.  Fails
without a GPU: a CPU time says nothing about the device.

Prints the device it ran on, then ONE JSON line on stdout.

Usage: python bench.py [--backend xla|pallas] [--image-size 256] [--level 3]
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--backend', default=None,
                    help='xla | pallas (default: the platform\'s own)')
    ap.add_argument('--image-size', type=int, default=256)
    ap.add_argument('--iters', type=int, default=50)
    ap.add_argument('--face-chunk', type=int, default=128)
    ap.add_argument('--pixel-tile', type=int, default=0,
                    help='pixels per kernel tile (0 = the default)')
    ap.add_argument('--level', type=int, default=3,
                    help='icosphere subdivision level (3 = 1280 faces)')
    ap.add_argument('--texture-size', type=int, default=1,
                    help='texels per face (TS)')
    ap.add_argument('--rgb', default='hard',
                    help='hard (headline) | softmax')
    args = ap.parse_args()

    import jax
    if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        jax.config.update('jax_compilation_cache_dir', os.path.join(
            os.path.dirname(os.path.abspath(__file__)), '.jax_cache'))
    import jax.numpy as jnp
    from gendr_jax import data
    from gendr_jax.geometry import core
    from gendr_jax.geometry import transforms as T
    from gendr_jax.raster.render import render

    dev = jax.devices()[0]
    print(f'device: platform={dev.platform} kind={dev.device_kind} '
          f'count={len(jax.devices())}', file=sys.stderr)
    if dev.platform != 'gpu':
        print('bench.py measures a GPU; none found', file=sys.stderr)
        return 1

    v, f = data.icosphere(args.level)
    B, is_ = 1, args.image_size
    verts = jnp.asarray(v)[None] * 0.9
    eye = T.get_points_from_angles(2.732, 30.0, 45.0)
    verts = T.perspective(T.look_at(verts, eye), 30.0)
    fv = core.face_vertices(verts, jnp.asarray(f)[None]).reshape(B, -1, 9)
    F = fv.shape[1]
    TS = args.texture_size
    tex = jnp.asarray(np.random.RandomState(0).rand(B, F, TS, 3),
                      jnp.float32)

    kw = dict(image_size=is_, dist_func='uniform', dist_scale=1e-2,
              aggr_alpha_func='probabilistic', aggr_rgb_func=args.rgb,
              backend=args.backend, face_chunk=args.face_chunk,
              pixel_tile=args.pixel_tile)

    def loss(fv_, tex_):
        img = render(fv_, tex_, **kw)
        return jnp.sum(img[:, 3] ** 2) + jnp.sum(img[:, :3])

    step = jax.jit(jax.grad(loss, argnums=(0, 1)))
    t0 = time.perf_counter()
    jax.block_until_ready(step(fv, tex))
    print(f'compile+first-run: {time.perf_counter() - t0:.2f}s',
          file=sys.stderr)
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        jax.block_until_ready(step(fv, tex))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    print(json.dumps({
        'metric': f'fwd+bwd step time {is_}^2 {F}f {args.rgb} TS={TS}',
        'value': dt * 1e3,
        'unit': 'ms',
        'backend': args.backend or 'default',
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices())},
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
