"""End-to-end rasterizer tests: chunked XLA backend vs the dense sequential
oracle, plus finite-difference gradient checks through the custom VJP."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gendr_jax import config as C
from gendr_jax.raster import oracle
from gendr_jax.raster.render import render


def random_scene(rng, B=2, F=13, z0=2.0, spread=1.2):
    """Random triangles roughly facing the camera, in view."""
    center = (rng.rand(B, F, 1, 3) - 0.5) * spread
    center[..., 2] = 0.0
    offs = (rng.rand(B, F, 3, 3) - 0.5) * 0.8
    fv = center + offs
    fv[..., 2] += z0 + rng.rand(B, F, 3) * 0.5
    return fv.astype(np.float32)


def params_dict(**kw):
    d = dict(dist_scale=1e-2, dist_shape=0.0, dist_shift=0.0, dist_eps=1e4,
             aggr_alpha_t_conorm_p=0.0, aggr_rgb_eps=1e-3,
             aggr_rgb_gamma=1e-3, near=1.0, far=100.0,
             background_color=np.zeros(3, np.float32))
    d.update(kw)
    return {k: jnp.asarray(v, jnp.float32) for k, v in d.items()}


CONFIGS = [
    dict(dist_func='uniform', aggr_alpha_func='probabilistic',
         aggr_rgb_func='softmax'),
    dict(dist_func='logistic', aggr_alpha_func='probabilistic',
         aggr_rgb_func='hard'),
    dict(dist_func='gaussian', aggr_alpha_func='einstein',
         aggr_rgb_func='softmax'),
    dict(dist_func='cauchy', aggr_alpha_func='max', aggr_rgb_func='hard'),
    dict(dist_func='hard', aggr_alpha_func='hard', aggr_rgb_func='hard'),
    dict(dist_func='uniform', aggr_alpha_func='yager', tp=2.0,
         aggr_rgb_func='softmax'),
    dict(dist_func='logistic', aggr_alpha_func='aczel_alsina', tp=1.0,
         aggr_rgb_func='hard', squared=True),
    dict(dist_func='gamma', shape=2.0, aggr_alpha_func='probabilistic',
         aggr_rgb_func='softmax'),
    dict(dist_func='exponential_rev', aggr_alpha_func='hamacher', tp=0.5,
         aggr_rgb_func='hard'),
]


@pytest.mark.parametrize('spec', CONFIGS)
def test_xla_vs_oracle(spec):
    rng = np.random.RandomState(7)
    fv = random_scene(rng)
    B, F = fv.shape[:2]
    tex = rng.rand(B, F, 1, 3).astype(np.float32)

    cfg = C.RenderConfig.create(
        image_size=24, dist_func=spec['dist_func'],
        dist_squared=spec.get('squared', False),
        aggr_alpha_func=spec['aggr_alpha_func'],
        aggr_rgb_func=spec['aggr_rgb_func'], double_side=True,
        face_chunk=4)  # force multiple chunks
    params = params_dict(dist_scale=3e-2,
                         dist_shape=spec.get('shape', 0.0),
                         aggr_alpha_t_conorm_p=spec.get('tp', 0.0),
                         background_color=np.array([0.1, 0.2, 0.3]))

    want, want_aggr = oracle.render_forward(fv.reshape(B, F, 9), tex, cfg,
                                            params)

    got = render(
        fv, tex, image_size=24, dist_func=spec['dist_func'],
        dist_squared=spec.get('squared', False), dist_scale=3e-2,
        dist_shape=spec.get('shape', 0.0),
        aggr_alpha_func=spec['aggr_alpha_func'],
        aggr_alpha_t_conorm_p=spec.get('tp', 0.0),
        aggr_rgb_func=spec['aggr_rgb_func'], double_side=True,
        background_color=np.array([0.1, 0.2, 0.3]), face_chunk=4)

    np.testing.assert_allclose(np.asarray(got), want, atol=5e-4, rtol=1e-3)


def test_vertex_textures():
    rng = np.random.RandomState(3)
    fv = random_scene(rng, B=1, F=7)
    vtex = rng.rand(1, 7, 3, 3).astype(np.float32)  # face-gathered colors
    cfg = C.RenderConfig.create(image_size=16, dist_func='uniform',
                                aggr_rgb_func='softmax',
                                texture_type='vertex', face_chunk=3)
    params = params_dict(dist_scale=3e-2)
    want, _ = oracle.render_forward(fv.reshape(1, 7, 9), vtex, cfg, params)
    got = render(fv, vtex, image_size=16, dist_func='uniform',
                 dist_scale=3e-2, aggr_rgb_func='softmax',
                 texture_type='vertex', face_chunk=3)
    np.testing.assert_allclose(np.asarray(got), want, atol=5e-4, rtol=1e-3)


def test_surface_texture_res2():
    rng = np.random.RandomState(4)
    fv = random_scene(rng, B=1, F=5)
    tex = rng.rand(1, 5, 4, 3).astype(np.float32)  # R=2
    cfg = C.RenderConfig.create(image_size=16, dist_func='uniform',
                                aggr_rgb_func='softmax', face_chunk=2)
    params = params_dict(dist_scale=3e-2)
    want, _ = oracle.render_forward(fv.reshape(1, 5, 9), tex, cfg, params)
    got = render(fv, tex, image_size=16, dist_func='uniform',
                 dist_scale=3e-2, aggr_rgb_func='softmax', face_chunk=2)
    np.testing.assert_allclose(np.asarray(got), want, atol=5e-4, rtol=1e-3)


GRAD_CONFIGS = [
    dict(dist_func='uniform', aggr_alpha_func='probabilistic',
         aggr_rgb_func='hard'),
    dict(dist_func='logistic', aggr_alpha_func='probabilistic',
         aggr_rgb_func='softmax'),
    dict(dist_func='gaussian', aggr_alpha_func='einstein',
         aggr_rgb_func='hard', squared=True),
]


@pytest.mark.parametrize('spec', GRAD_CONFIGS)
def test_gradients_finite_difference(spec):
    """Silhouette-loss vertex gradients vs central differences.

    Note the reference's gradient is intentionally approximate (it ignores
    the dependence of the barycentric matrix on the vertices), so we check
    direction/magnitude with a loose tolerance on a smooth config.
    """
    rng = np.random.RandomState(11)
    fv = random_scene(rng, B=1, F=3)
    tex = np.ones((1, 3, 1, 3), np.float32)
    kw = dict(image_size=20, dist_func=spec['dist_func'],
              dist_squared=spec.get('squared', False), dist_scale=0.1,
              aggr_alpha_func=spec['aggr_alpha_func'],
              aggr_rgb_func=spec['aggr_rgb_func'], face_chunk=2)

    target = np.asarray(render(fv, tex, **kw))

    @jax.jit
    def loss(v):
        img = render(v, tex, **kw)
        return jnp.mean((img[:, 3] - target[:, 3] * 0.5) ** 2)

    g = np.asarray(jax.grad(loss)(jnp.asarray(fv)))
    assert np.all(np.isfinite(g))
    assert np.abs(g).max() > 0

    # central differences on a few random coordinates
    h = 2e-3
    checked = 0
    flat = fv.reshape(-1)
    for idx in rng.choice(flat.size, 12, replace=False):
        e = np.zeros_like(flat)
        e[idx] = h
        lp = float(loss(jnp.asarray((flat + e).reshape(fv.shape))))
        lm = float(loss(jnp.asarray((flat - e).reshape(fv.shape))))
        fd = (lp - lm) / (2 * h)
        ga = g.reshape(-1)[idx]
        if abs(fd) < 1e-5 and abs(ga) < 1e-5:
            checked += 1
            continue
        np.testing.assert_allclose(ga, fd, rtol=0.35, atol=2e-4)
        checked += 1
    assert checked >= 8


def test_texture_gradients():
    rng = np.random.RandomState(5)
    fv = random_scene(rng, B=1, F=3)
    tex = rng.rand(1, 3, 1, 3).astype(np.float32)
    kw = dict(image_size=16, dist_func='uniform', dist_scale=0.05,
              aggr_rgb_func='softmax', face_chunk=2)

    @jax.jit
    def loss(t):
        img = render(fv, t, **kw)
        return jnp.sum(img[:, :3] ** 2)

    g = np.asarray(jax.grad(loss)(jnp.asarray(tex)))
    assert np.all(np.isfinite(g))
    h = 1e-3
    flat = tex.reshape(-1)
    for idx in range(flat.size):
        e = np.zeros_like(flat)
        e[idx] = h
        lp = float(loss(jnp.asarray((flat + e).reshape(tex.shape))))
        lm = float(loss(jnp.asarray((flat - e).reshape(tex.shape))))
        fd = (lp - lm) / (2 * h)
        if abs(fd) < 1e-5 and abs(g.reshape(-1)[idx]) < 1e-5:
            continue
        np.testing.assert_allclose(g.reshape(-1)[idx], fd, rtol=0.05,
                                   atol=1e-4)
