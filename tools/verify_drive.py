"""End-to-end drive of the public gendr_jax API (the /verify recipe).

Renders a lit sphere through `GenDR` (composition: renderer(transform(
lighting(mesh)))), runs an annealed silhouette optimization to >0.9 hard
IoU, and fires the static-validation probes.  CPU at 64 px — fast enough
to run after any kernel or API change.

Usage: python tools/verify_drive.py [out.png]
"""

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update('jax_platforms', 'cpu')

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import gendr_jax as G  # noqa: E402


def octasphere(n=3):
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                  [0, 0, 1], [0, 0, -1]], np.float64)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    for _ in range(n):
        nv, nf, cache = list(v), [], {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = v[a] + v[b]
                cache[key] = len(nv)
                nv.append(m / np.linalg.norm(m))
            return cache[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v, f = np.array(nv), np.array(nf)
    return v.astype(np.float32), f.astype(np.int32)


def main():
    v, f = octasphere(3)
    mesh0 = G.Mesh.create(jnp.asarray(v)[None] * 0.9, jnp.asarray(f)[None])
    lighting = G.Lighting()
    transform = G.LookAt(viewing_angle=30)
    transform.set_eyes_from_angles(2.732, 30, 45)

    # 1. lit render through the module API
    rend = G.GenDR(image_size=64, dist_func='uniform',
                   aggr_alpha_func='probabilistic', aggr_rgb_func='softmax',
                   anti_aliasing=True)
    img = rend(transform(lighting(mesh0)))
    alpha = np.asarray(img[0, 3])
    rgb = np.asarray(img[0, :3])
    cov = float((alpha > 0.5).mean())
    center = float(rgb[:, 28:36, 28:36].mean())
    print(f'alpha coverage: {cov:.3f}  center rgb: {center:.3f}')
    assert 0.1 < cov < 0.9, cov
    assert center > 0.2, center
    if len(sys.argv) > 1:
        from PIL import Image
        Image.fromarray((np.transpose(rgb, (1, 2, 0)) * 255)
                        .clip(0, 255).astype(np.uint8)).save(sys.argv[1])

    # 2. annealed silhouette optimization (fixed tau stalls ~0.72 IoU;
    # logspace(-1.5, -2.5, 5) x 30 steps reaches > 0.95)
    tgt_rend = G.GenDR(image_size=64, dist_func='uniform', dist_scale=1e-3,
                       aggr_alpha_func='probabilistic', channels='alpha')
    soft = G.GenDR(image_size=64, dist_func='logistic',
                   aggr_alpha_func='probabilistic', channels='alpha')

    def sil(r, shift):
        m = G.Mesh.create(mesh0.vertices + shift, mesh0.faces)
        return r(transform(lighting(m)))[0, 3]

    tgt = sil(tgt_rend, jnp.asarray([0.25, -0.15, 0.0]))
    opt = optax.adam(0.05)
    shift = jnp.zeros(3)
    state = opt.init(shift)
    for tau in np.logspace(-1.5, -2.5, 5):
        soft.dist_scale = float(tau)  # static python float -> re-jit per tau

        @jax.jit
        def step(s, st):
            def loss(sh):
                return jnp.mean((sil(soft, sh) - tgt) ** 2)
            _, g = jax.value_and_grad(loss)(s)
            u, st2 = opt.update(g, st)
            return optax.apply_updates(s, u), st2

        for _ in range(30):
            shift, state = step(shift, state)
    final = sil(tgt_rend, shift)
    inter = jnp.sum((final > 0.5) & (tgt > 0.5))
    union = jnp.sum((final > 0.5) | (tgt > 0.5))
    iou = float(inter / union)
    print(f'silhouette-opt hard IoU: {iou:.4f}')
    assert iou > 0.9, iou

    # 3. static-validation probes
    try:
        G.GenDR(aggr_rgb_func='weird')
        raise SystemExit('probe1 FAILED: no ValueError')
    except ValueError:
        print('probe1 ok (ValueError on unknown rgb func)')
    from gendr_jax.functional import render as frender
    try:
        frender(mesh0.face_vertices, jnp.ones((1, f.shape[0], 1, 3)),
                image_size=64, dist_scale=-1.0)
        raise SystemExit('probe2 FAILED: no AssertionError')
    except AssertionError:
        print('probe2 ok (AssertionError on negative scale)')
    img17 = G.GenDR(image_size=17, dist_func='uniform',
                    aggr_alpha_func='probabilistic',
                    aggr_rgb_func='softmax')(transform(lighting(mesh0)))
    assert img17.shape == (1, 4, 17, 17)
    print('probe3 ok (odd image_size renders)')
    print('VERIFY PASS')


if __name__ == '__main__':
    main()
