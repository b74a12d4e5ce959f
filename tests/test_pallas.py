"""Pallas/Triton kernels vs the XLA backend (interpret mode on the CPU)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gendr_jax import config as C
from gendr_jax.raster import pallas_backend as PB
from gendr_jax.raster import xla_backend as X
from gendr_jax.raster import prep
from tests.test_render import random_scene, params_dict

# Module-level jitted entry points (cfg is a hashable frozen dataclass ->
# static).  Tests previously invoked the backends EAGERLY, which dispatches
# the interpret-mode kernels op by op from Python — ~5-15 s per call; one
# jit compile of the same program is ~5-10x faster and the wrappers being
# module-level singletons lets jax reuse traces across tests that share a
# config.  Wall-clock for the default tier is a round-3 deliverable
# (<8 min cold); the max-t-conorm fwd/bwd bitwise-pairing tests keep their
# existing tolerance budgets (fusion may round differently between the
# separately-jitted forward and backward programs).
J_XF = jax.jit(X.forward, static_argnums=3)
J_PF = jax.jit(PB.forward, static_argnums=3)
J_XB = jax.jit(X.backward, static_argnums=6)
J_PB = jax.jit(PB.backward, static_argnums=6)
J_PFA = jax.jit(PB.forward_with_aux, static_argnums=2)
J_PBA = jax.jit(PB.backward_from_aux, static_argnums=6)

CONFIGS = [
    dict(dist_func='uniform', aggr_alpha_func='probabilistic',
         aggr_rgb_func='hard'),
    dict(dist_func='logistic', aggr_alpha_func='probabilistic',
         aggr_rgb_func='softmax'),
    dict(dist_func='gaussian', aggr_alpha_func='einstein',
         aggr_rgb_func='hard', squared=True),
    dict(dist_func='hard', aggr_alpha_func='hard', aggr_rgb_func='hard'),
    dict(dist_func='cauchy', aggr_alpha_func='max', aggr_rgb_func='softmax'),
]


def _cfg(spec, texture_type='surface'):
    return C.RenderConfig.create(
        image_size=16, dist_func=spec['dist_func'],
        dist_squared=spec.get('squared', False),
        aggr_alpha_func=spec['aggr_alpha_func'],
        aggr_rgb_func=spec['aggr_rgb_func'], double_side=True,
        texture_type=texture_type, face_chunk=8, pixel_tile=64,
        backend='pallas')


@pytest.mark.parametrize('spec', CONFIGS)
def test_pallas_forward_matches_xla(spec):
    rng = np.random.RandomState(0)
    fv = random_scene(rng, B=2, F=13).reshape(2, 13, 9)
    tex = rng.rand(2, 13, 1, 3).astype(np.float32)
    cfg = _cfg(spec)
    params = params_dict(dist_scale=3e-2,
                         background_color=np.array([0.1, 0.2, 0.3]))
    finfo = prep.faces_info(jnp.asarray(fv))
    want, want_ag = J_XF(jnp.asarray(fv), jnp.asarray(tex), finfo, cfg,
                              params)
    got, got_ag = J_PF(jnp.asarray(fv), jnp.asarray(tex), finfo, cfg,
                             params)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4,
                               rtol=1e-3)
    # aggrs channel 0 (depth / softmax_sum) is order-independent
    np.testing.assert_allclose(np.asarray(got_ag)[:, 0],
                               np.asarray(want_ag)[:, 0],
                               atol=1e-3, rtol=1e-3)
    if spec['aggr_rgb_func'] == 'hard':
        # pallas keeps winner ids in Morton-sorted space; map back via the
        # prepass permutation before comparing
        aux = PB._prepass(jnp.asarray(fv), jnp.asarray(tex), cfg, params)
        perm = np.asarray(aux['perm'])
        got_idx = np.asarray(got_ag)[:, 1].astype(int)
        want_idx = np.asarray(want_ag)[:, 1].astype(int)
        for b in range(got_idx.shape[0]):
            mapped = np.where(got_idx[b] >= 0, perm[b][np.clip(
                got_idx[b], 0, perm.shape[1] - 1)], -1)
            np.testing.assert_array_equal(mapped, want_idx[b])
    else:
        np.testing.assert_allclose(np.asarray(got_ag)[:, 1],
                                   np.asarray(want_ag)[:, 1],
                                   atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize('spec', CONFIGS)
def test_pallas_backward_matches_xla(spec):
    """Each backend is paired with its own forward outputs (as in the
    production custom_vjp).  The max t-conorm detects its winner by exact
    float equality with the recomputed coverage (cu:574-575), so its grads
    are only meaningful for self-consistent fwd/bwd pairs — covered by the
    finite-difference test below instead."""
    if spec['aggr_alpha_func'] == 'max':
        pytest.skip('exact-equality winner detection: see FD test')
    # same (B, F) as test_pallas_forward_matches_xla so the module-level
    # jitted wrappers reuse its forward traces (cold compiles dominate the
    # suite's wall time)
    rng = np.random.RandomState(1)
    fv = jnp.asarray(random_scene(rng, B=2, F=13).reshape(2, 13, 9))
    tex = jnp.asarray(rng.rand(2, 13, 1, 3).astype(np.float32))
    cfg = _cfg(spec)
    params = params_dict(dist_scale=5e-2)
    finfo = prep.faces_info(fv)
    g = jnp.asarray(rng.randn(2, 4, 16, 16).astype(np.float32))
    soft_x, aggrs_x = J_XF(fv, tex, finfo, cfg, params)
    want_f, want_t = J_XB(fv, tex, finfo, soft_x, aggrs_x, g, cfg,
                                params)
    soft_p, aggrs_p = J_PF(fv, tex, finfo, cfg, params)
    got_f, got_t = J_PB(fv, tex, finfo, soft_p, aggrs_p, g, cfg,
                               params)
    _assert_mostly_close(got_f, want_f, atol=2e-4, rtol=2e-3)
    _assert_mostly_close(got_t, want_t, atol=2e-4, rtol=2e-3)


ALL_DISTS = ['hard', 'uniform', 'cubic_hermite', 'wigner_semicircle',
             'gaussian', 'laplace', 'logistic', 'gudermannian', 'cauchy',
             'reciprocal', 'gumbel_max', 'gumbel_min', 'exponential',
             'exponential_rev', 'gamma', 'gamma_rev', 'levy', 'levy_rev']

# per-distribution continuous params: gamma needs a shape; the asymmetric
# dists are exercised with a nonzero shift (cu:302-307)
DIST_PARAMS = {
    'gamma': dict(dist_shape=2.0),
    'gamma_rev': dict(dist_shape=2.0),
    'levy': dict(dist_shift=0.1),
    'levy_rev': dict(dist_shift=0.1),
    'exponential': dict(dist_shift=0.05),
    'gumbel_max': dict(dist_shift=0.05),
}

MATRIX_TCNS = [('probabilistic', 0.0), ('yager', 2.0), ('hamacher', 0.5),
               ('frank', 2.0)]

# Default-tier matrix subset: one representative per distribution FAMILY of
# the kernel's CDF dispatch (compact support, erf-based, heavy tail, Kummer
# series, erfc, asymmetric-shifted) so every numeric regime stays covered on
# every run; the full 18-dist cross product is the `exhaustive` tier
# (GENDR_EXHAUSTIVE=1; validated in full before each round's submission).
DEFAULT_MATRIX_DISTS = {'uniform', 'gaussian', 'cauchy', 'gamma', 'levy',
                        'gumbel_max', 'hard'}


def _matrix_params(values, default_set):
    """Wrap parametrize values: combos outside the default tier get the
    `exhaustive` marker (skipped unless GENDR_EXHAUSTIVE=1)."""
    out = []
    for v in values:
        key = v if isinstance(v, str) else v[0]
        if key in default_set:
            out.append(v)
        else:
            out.append(pytest.param(
                *((v,) if isinstance(v, str) else v),
                marks=pytest.mark.exhaustive))
    return out


def _assert_mostly_close(got, want, atol, rtol, max_flip_frac=0.02,
                         flip_cap_frac=0.03):
    """Tight closeness for the bulk; a small budget of isolated outliers.

    The two backends classify a pixel's inside/outside state from
    differently-rounded barycentrics, so a pair sitting within an ulp of
    the triangle boundary (or of the 1e-6 probability threshold) can flip
    between them, flipping that pair's gradient sign.  Such flips are
    isolated single elements; anything systematic trips the budget.
    """
    got, want = np.asarray(got), np.asarray(want)
    close = np.isclose(got, want, atol=atol, rtol=rtol)
    if close.all():
        return
    frac = 1.0 - close.mean()
    assert frac <= max_flip_frac, \
        f'{frac:.2%} elements outside tolerance (budget {max_flip_frac:.0%})'
    scale = np.abs(want).max() + 1e-12
    worst = np.abs(got - want)[~close].max()
    assert worst <= flip_cap_frac * scale, \
        f'outlier magnitude {worst:.3g} > {flip_cap_frac} * {scale:.3g}'


def _pallas_vs_xla(dist, tcn, p, rgb, extra=None, seed=11):
    """fwd + bwd parity of the pallas kernels against the XLA oracle for a
    full config.  Every branch of the reference kernel's distribution zoo
    (cu:242-459) is reachable; this pins each through the pallas path."""
    rng = np.random.RandomState(seed)
    fv = jnp.asarray(random_scene(rng, B=1, F=11).reshape(1, 11, 9))
    tex = jnp.asarray(rng.rand(1, 11, 1, 3).astype(np.float32))
    cfg = C.RenderConfig.create(
        image_size=16, dist_func=dist, aggr_alpha_func=tcn,
        aggr_rgb_func=rgb, face_chunk=8, pixel_tile=64, backend='pallas')
    pkw = dict(dist_scale=5e-2, aggr_alpha_t_conorm_p=p)
    pkw.update(extra or {})
    params = params_dict(**pkw)
    finfo = prep.faces_info(fv)

    want, want_ag = J_XF(fv, tex, finfo, cfg, params)
    got, got_ag, aux = J_PFA(fv, tex, cfg, params)
    # Forward: tight bulk tolerance, but the packed-constant distance algebra
    # (pack.py) associates differently from the XLA backend's, so a pixel
    # within an ulp of a steep CDF's support edge can differ by ~1e-3 of
    # probability.  Budget: <=1% of pixels, capped at 1% of full scale
    # (gamma's Kummer-series CDF is the steepest; it puts ~6/1024 pixels
    # just past the bulk tolerance).
    _assert_mostly_close(got, want, atol=2e-4, rtol=2e-3,
                         max_flip_frac=0.01, flip_cap_frac=0.01)

    g = jnp.asarray(rng.randn(1, 4, 16, 16).astype(np.float32))
    want_f, want_t = J_XB(fv, tex, finfo, want, want_ag, g, cfg,
                                params)
    got_f, got_t = J_PBA(fv, tex, aux, got, got_ag, g, cfg,
                                        params)
    # rtol 1e-2: the parametric t-conorm folds (yager powers etc.) associate
    # differently in the kernel's serial fold vs the XLA tree reduction.
    # Budget 8%:
    # compact-support PDFs (uniform/cubic_hermite/wigner) are DISCONTINUOUS
    # at the support edge, so a one-ulp distance difference between the two
    # backends flips that pair's pdf between 0 and O(1/tau), and each
    # flipped pair touches up to 6 of this tiny scene's 99 grad entries
    # (2-3 legitimate flips ~ 8%).  A systematic error (wrong sign/vertex
    # routing/scale) hits 50-100% and still trips the budget.
    _assert_mostly_close(got_f, want_f, atol=1e-3, rtol=1e-2,
                         max_flip_frac=0.08, flip_cap_frac=0.05)
    _assert_mostly_close(got_t, want_t, atol=1e-3, rtol=1e-2,
                         max_flip_frac=0.08, flip_cap_frac=0.05)


@pytest.mark.parametrize('dist', _matrix_params(ALL_DISTS,
                                                DEFAULT_MATRIX_DISTS))
@pytest.mark.parametrize('rgb', _matrix_params(['hard', 'softmax'],
                                               {'softmax'}))
def test_pallas_dist_matrix(dist, rgb):
    """All 18 distribution ids through the pallas kernels, fwd + bwd, both
    RGB modes (probabilistic t-conorm).  Default tier: representative dists
    x softmax (hard-RGB parity runs in the CONFIGS specs above); the full
    cross product is the exhaustive tier."""
    _pallas_vs_xla(dist, 'probabilistic', 0.0, rgb,
                   extra=DIST_PARAMS.get(dist))


@pytest.mark.parametrize('dist', _matrix_params(ALL_DISTS,
                                                {'uniform', 'gamma'}))
@pytest.mark.parametrize('tcn,p', MATRIX_TCNS[1:])
def test_pallas_dist_tcn_matrix(dist, tcn, p):
    """All 18 distribution ids x the parametric t-conorms (yager p=2,
    hamacher p=0.5, frank p=2) through the kernel's serial fold.
    Default tier:
    one compact-support + one series CDF per t-conorm (the fold logic is
    dist-independent); full cross product in the exhaustive tier."""
    _pallas_vs_xla(dist, tcn, p, 'hard', extra=DIST_PARAMS.get(dist))


def test_pallas_gamma_small_shape():
    """gamma with shape < 1 hits the Kummer-series small-a regime
    (cu:310-318)."""
    _pallas_vs_xla('gamma', 'probabilistic', 0.0, 'softmax',
                   extra=dict(dist_shape=0.5))


def test_pallas_dist_squared_exotic():
    """dist_squared routes dis^2 into the CDF (cu:770-772) — check it on a
    heavy-tail dist through pallas."""
    rng = np.random.RandomState(13)
    fv = jnp.asarray(random_scene(rng, B=1, F=9).reshape(1, 9, 9))
    tex = jnp.asarray(rng.rand(1, 9, 1, 3).astype(np.float32))
    cfg = C.RenderConfig.create(
        image_size=16, dist_func='cauchy', dist_squared=True,
        aggr_alpha_func='probabilistic', aggr_rgb_func='softmax',
        face_chunk=8, pixel_tile=64, backend='pallas')
    params = params_dict(dist_scale=1e-3)
    finfo = prep.faces_info(fv)
    want, want_ag = J_XF(fv, tex, finfo, cfg, params)
    got, got_ag = J_PF(fv, tex, finfo, cfg, params)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-4, rtol=2e-3)
    g = jnp.asarray(rng.randn(1, 4, 16, 16).astype(np.float32))
    want_f, _ = J_XB(fv, tex, finfo, want, want_ag, g, cfg, params)
    got_f, _ = J_PB(fv, tex, finfo, got, got_ag, g, cfg, params)
    np.testing.assert_allclose(np.asarray(got_f), np.asarray(want_f),
                               atol=5e-4, rtol=5e-3)


def test_pallas_max_tconorm_finite_difference():
    """Self-consistency of the pallas path for the max t-conorm."""
    from gendr_jax.raster.render import render
    rng = np.random.RandomState(7)
    fv = random_scene(rng, B=1, F=5)
    tex = np.ones((1, 5, 1, 3), np.float32)
    kw = dict(image_size=16, dist_func='logistic', dist_scale=0.1,
              aggr_alpha_func='max', aggr_rgb_func='hard', face_chunk=8,
              backend='pallas')

    def loss(v):
        img = render(v, tex, **kw)
        return jnp.mean(img[:, 3] ** 2)

    g = np.asarray(jax.grad(loss)(jnp.asarray(fv)))
    assert np.isfinite(g).all() and np.abs(g).max() > 0

    # central differences are unreliable at max-kinks (winner switches), so
    # compare against the XLA backend instead, which is FD-validated on the
    # smooth t-conorms and shares the max semantics
    def loss_x(v):
        img = render(v, tex, **{**kw, 'backend': 'xla'})
        return jnp.mean(img[:, 3] ** 2)

    g_x = np.asarray(jax.grad(loss_x)(jnp.asarray(fv)))
    # exact-equality winner detection means a pair that is within an ulp in
    # one recompute path can flip in the other; require bulk agreement
    close = np.isclose(g, g_x, atol=1e-5, rtol=1e-3)
    assert close.mean() > 0.7, close.mean()

    # and the gradient must actually descend the pallas loss
    l0 = float(loss(jnp.asarray(fv)))
    l1 = float(loss(jnp.asarray(fv) - 0.05 * g / (np.abs(g).max() + 1e-9)))
    assert l1 < l0


def test_pallas_max_tconorm_agreement_over_seeds():
    """Distribution-over-seeds check of pallas-vs-XLA max-t-conorm
    gradients.  Both backends run the SAME shared pair math
    (raster/pairmath.py), but the interpreted kernel and the XLA backend
    are separate programs whose f32 chains may contract into FMAs
    differently, so they differ by an ulp per affine chain; exact-equality
    winner detection (cu:574-575) then reassigns a few pixels between
    faces.  What must survive that noise: per-seed bulk agreement, a
    near-1 gradient direction (winner swaps preserve the directional
    derivative), and no seed-systematic divergence."""
    from gendr_jax.raster.render import render
    tex = np.ones((1, 5, 1, 3), np.float32)
    kw = dict(image_size=16, dist_func='logistic', dist_scale=0.1,
              aggr_alpha_func='max', aggr_rgb_func='hard', face_chunk=8)

    @jax.jit
    def grad_p(v):
        return jax.grad(lambda v: jnp.mean(
            render(v, tex, backend='pallas', **kw)[:, 3] ** 2))(v)

    @jax.jit
    def grad_x(v):
        return jax.grad(lambda v: jnp.mean(
            render(v, tex, backend='xla', **kw)[:, 3] ** 2))(v)

    fracs, worsts, coss = [], [], []
    for seed in range(10):
        fv = jnp.asarray(random_scene(np.random.RandomState(seed), B=1, F=5))
        g, g_x = np.asarray(grad_p(fv)), np.asarray(grad_x(fv))
        scale = np.abs(g_x).max()
        fracs.append((np.abs(g - g_x) <= 0.01 * scale).mean())
        worsts.append(np.abs(g - g_x).max() / scale)
        coss.append(float((g * g_x).sum())
                    / max(float(np.linalg.norm(g) * np.linalg.norm(g_x)),
                          1e-30))
    fracs, worsts = np.asarray(fracs), np.asarray(worsts)
    coss = np.asarray(coss)
    # Bounds are stated in units of each seed's gradient scale, because the
    # element level is provably not stable to rounding on this harness: the
    # XLA backend's OWN autodiff disagrees with central differences of its
    # own loss by up to ~40% on single coordinates here (winner detection
    # recomputes frag in a separately-jitted program; an ulp of fusion
    # difference reassigns a pixel between nearly-equal faces).  The sharp
    # per-element claims live in test_pallas_max_tconorm_finite_difference
    # (each backend vs its own loss).
    assert fracs.min() > 0.55, fracs       # bulk of elements essentially equal
    assert fracs.mean() > 0.70, fracs
    # isolated swaps stay bounded by roughly one pixel's own contribution
    # (empirically <= ~0.7x the gradient scale on this harness — a single
    # high-leverage pixel reassigned between faces; the exact landing spots
    # shift whenever XLA:CPU's fusion layout changes), while a SYSTEMATIC
    # divergence would push the median and every seed up together
    assert np.median(worsts) < 0.35, worsts
    assert worsts.max() < 1.0, worsts
    # the gradient DIRECTION must be essentially identical on every seed —
    # a systematic tie-break divergence would rotate it (one high-leverage
    # pixel swap in a 5-face 16^2 scene can alone cost ~0.03 of cosine on
    # a 45-dim gradient, hence the per-seed floor is looser than the mean)
    assert coss.min() > 0.95, coss
    assert coss.mean() > 0.985, coss


@pytest.mark.parametrize('rgb', ['hard', 'softmax'])
def test_pallas_vertex_textures(rgb):
    rng = np.random.RandomState(2)
    fv = jnp.asarray(random_scene(rng, B=1, F=9).reshape(1, 9, 9))
    tex = jnp.asarray(rng.rand(1, 9, 3, 3).astype(np.float32))
    cfg = _cfg(dict(dist_func='uniform', aggr_alpha_func='probabilistic',
                    aggr_rgb_func=rgb), texture_type='vertex')
    params = params_dict(dist_scale=3e-2)
    finfo = prep.faces_info(fv)
    want, want_ag = J_XF(fv, tex, finfo, cfg, params)
    got, got_ag = J_PF(fv, tex, finfo, cfg, params)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4,
                               rtol=1e-3)
    # each backward consumes its OWN forward's residuals (as the custom VJP
    # does): hard-RGB winner ids are backend-internal (Morton-sorted space
    # in pallas, input order in the XLA scan)
    g = jnp.asarray(rng.randn(*np.asarray(want).shape).astype(np.float32))
    want_f, want_t = J_XB(fv, tex, finfo, want, want_ag, g, cfg,
                                params)
    got_f, got_t = J_PB(fv, tex, finfo, got, got_ag, g, cfg, params)
    np.testing.assert_allclose(np.asarray(got_f), np.asarray(want_f),
                               atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(np.asarray(got_t), np.asarray(want_t),
                               atol=2e-4, rtol=2e-3)


def test_pallas_render_api():
    """End-to-end through render(backend='pallas') incl. custom VJP."""
    from gendr_jax.raster.render import render
    rng = np.random.RandomState(3)
    fv = random_scene(rng, B=1, F=7)
    tex = np.ones((1, 7, 1, 3), np.float32)
    kw = dict(image_size=16, dist_func='uniform', dist_scale=5e-2,
              aggr_rgb_func='hard', face_chunk=8)

    def loss(v, backend):
        img = render(v, tex, backend=backend, **kw)
        return jnp.sum(img[:, 3] ** 2)

    g_p = jax.grad(lambda v: loss(v, 'pallas'))(jnp.asarray(fv))
    g_x = jax.grad(lambda v: loss(v, 'xla'))(jnp.asarray(fv))
    np.testing.assert_allclose(np.asarray(g_p), np.asarray(g_x), atol=2e-4,
                               rtol=2e-3)


@pytest.mark.parametrize('rgb', ['hard', 'softmax'])
def test_pallas_surface_texture_res2(rgb):
    """R=2 surface textures: in-kernel one-hot texel sampling + per-texel
    gradient routing vs the XLA backend."""
    rng = np.random.RandomState(9)
    fv = jnp.asarray(random_scene(rng, B=1, F=7).reshape(1, 7, 9))
    tex = jnp.asarray(rng.rand(1, 7, 4, 3).astype(np.float32))
    cfg = _cfg(dict(dist_func='uniform', aggr_alpha_func='probabilistic',
                    aggr_rgb_func=rgb))
    params = params_dict(dist_scale=5e-2)
    finfo = prep.faces_info(fv)
    soft_x, aggrs_x = J_XF(fv, tex, finfo, cfg, params)
    soft_p, aggrs_p = J_PF(fv, tex, finfo, cfg, params)
    np.testing.assert_allclose(np.asarray(soft_p), np.asarray(soft_x),
                               atol=2e-4, rtol=1e-3)
    g = jnp.asarray(rng.randn(1, 4, 16, 16).astype(np.float32))
    want_f, want_t = J_XB(fv, tex, finfo, soft_x, aggrs_x, g, cfg,
                                params)
    got_f, got_t = J_PB(fv, tex, finfo, soft_p, aggrs_p, g, cfg,
                               params)
    np.testing.assert_allclose(np.asarray(got_f), np.asarray(want_f),
                               atol=5e-4, rtol=5e-3)
    np.testing.assert_allclose(np.asarray(got_t), np.asarray(want_t),
                               atol=5e-4, rtol=5e-3)


def test_pallas_obtuse_triangle_parity():
    """Strongly obtuse triangles: the pallas first-minimum argmin over
    clamped edge distances must agree with the XLA backend's reference
    decision chain (obt flags, cu:127-139) everywhere — including the
    vertex/corner Voronoi regions where the obtuse correction applies
    (ADVICE.md r1)."""
    # very flat triangles -> obtuse apex angles; plus skewed ones
    fv = np.array([
        [[-0.8, 0.0, 2.0, 0.8, 0.0, 2.0, 0.0, 0.06, 2.0]],
        [[-0.7, -0.5, 2.0, 0.7, -0.45, 2.0, -0.6, -0.42, 2.0]],
        [[0.1, 0.6, 2.0, 0.9, 0.62, 2.0, 0.88, 0.7, 2.0]],
    ], np.float32).reshape(3, 1, 9)
    tex = np.ones((3, 1, 1, 3), np.float32)
    cfg = C.RenderConfig.create(
        image_size=32, dist_func='logistic', aggr_alpha_func='probabilistic',
        aggr_rgb_func='softmax', face_chunk=8, pixel_tile=64,
        backend='pallas')
    # large tau so distant outside pixels (vertex Voronoi corners) carry
    # non-negligible coverage and gradients
    params = params_dict(dist_scale=0.2)
    fv_j, tex_j = jnp.asarray(fv), jnp.asarray(tex)
    finfo = prep.faces_info(fv_j)
    want, want_ag = J_XF(fv_j, tex_j, finfo, cfg, params)
    got, got_ag = J_PF(fv_j, tex_j, finfo, cfg, params)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-5, rtol=1e-4)
    rng = np.random.RandomState(3)
    g = jnp.asarray(rng.randn(3, 4, 32, 32).astype(np.float32))
    want_f, _ = J_XB(fv_j, tex_j, finfo, want, want_ag, g, cfg, params)
    got_f, _ = J_PB(fv_j, tex_j, finfo, got, got_ag, g, cfg, params)
    np.testing.assert_allclose(np.asarray(got_f), np.asarray(want_f),
                               atol=1e-4, rtol=1e-3)


class TestFallbackEnvelope:
    """The kernels' texture envelope: any surface texture size for both RGB
    modes (softmax gathers texels in-kernel; hard RGB samples in an XLA
    epilogue keyed on the winner id; both sum texture gradients in the
    backward kernel, in TEXEL_BLOCK one-hot blocks), with nothing to fall
    back from."""

    def test_hard_rgb_cap_texture_inkernel_parity(self):
        """TS=25 (the panda's texture_res=5) hard RGB matches the XLA
        backend fwd + bwd: winner colour gathered in the epilogue, texture
        grads summed in-kernel per winning face and texel."""
        rng = np.random.RandomState(11)
        fv = random_scene(rng, B=2, F=9).reshape(2, 9, 9)
        tex = rng.rand(2, 9, 25, 3).astype(np.float32)
        cfg = C.RenderConfig.create(
            image_size=16, dist_func='uniform',
            aggr_alpha_func='probabilistic', aggr_rgb_func='hard',
            double_side=True, face_chunk=8, pixel_tile=64,
            backend='pallas')
        params = params_dict(dist_scale=3e-2)
        fvj, texj = jnp.asarray(fv), jnp.asarray(tex)
        finfo = prep.faces_info(fvj)
        want, want_ag = J_XF(fvj, texj, finfo, cfg, params)
        got, got_ag, aux = J_PFA(fvj, texj, cfg, params)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-4, rtol=1e-3)
        g = jnp.asarray(rng.randn(2, 4, 16, 16).astype(np.float32))
        want_f, want_t = J_XB(fvj, texj, finfo, want, want_ag, g,
                                    cfg, params)
        got_f, got_t = J_PBA(fvj, texj, aux, got, got_ag, g,
                                            cfg, params)
        np.testing.assert_allclose(np.asarray(got_f), np.asarray(want_f),
                                   atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(np.asarray(got_t), np.asarray(want_t),
                                   atol=1e-5, rtol=1e-4)

    def test_hard_rgb_big_texture_pallas_parity(self):
        """TS=49 hard RGB runs the pallas kernels and matches the XLA
        backend fwd + bwd (texture grads routed per sampled texel,
        backward_sample_texture cu:197-207)."""
        rng = np.random.RandomState(4)
        fv = random_scene(rng, B=2, F=9).reshape(2, 9, 9)
        tex = rng.rand(2, 9, 49, 3).astype(np.float32)
        cfg = C.RenderConfig.create(
            image_size=16, dist_func='uniform',
            aggr_alpha_func='probabilistic', aggr_rgb_func='hard',
            double_side=True, face_chunk=8, pixel_tile=64,
            backend='pallas')
        params = params_dict(dist_scale=3e-2)
        fvj, texj = jnp.asarray(fv), jnp.asarray(tex)
        finfo = prep.faces_info(fvj)
        want, want_ag = J_XF(fvj, texj, finfo, cfg, params)
        got, got_ag, aux = J_PFA(fvj, texj, cfg, params)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-4, rtol=1e-3)
        g = jnp.asarray(rng.randn(2, 4, 16, 16).astype(np.float32))
        want_f, want_t = J_XB(fvj, texj, finfo, want, want_ag, g,
                                    cfg, params)
        got_f, got_t = J_PBA(fvj, texj, aux, got, got_ag, g,
                                            cfg, params)
        np.testing.assert_allclose(np.asarray(got_f), np.asarray(want_f),
                                   atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(np.asarray(got_t), np.asarray(want_t),
                                   atol=1e-5, rtol=1e-4)

    @pytest.mark.parametrize('ts', [
        49, pytest.param(256, marks=pytest.mark.exhaustive)])
    def test_softmax_big_texture_blocked_parity(self, ts):
        """Softmax RGB with surface TS > TEXEL_BLOCK sums its texture
        gradients over several one-hot texel blocks (TS=49: two blocks,
        the second with a masked tail) and matches the XLA backend fwd +
        bwd.  TS=256 == the reference's load_obj texture_res max
        (load_obj.py:33-106)."""
        assert ts > PB.TEXEL_BLOCK
        # seed 8: no pixel sits on a depth crossing where the near-hard
        # softmax winner flips with rounding (seed 5's scene has one, and
        # jitting the SAME XLA forward moves that pixel by up to 0.9 —
        # strict allclose would fail XLA-vs-itself there).
        rng = np.random.RandomState(8)
        fv = random_scene(rng, B=1, F=9).reshape(1, 9, 9)
        tex = rng.rand(1, 9, ts, 3).astype(np.float32)
        cfg = C.RenderConfig.create(
            image_size=16, dist_func='logistic',
            aggr_alpha_func='probabilistic', aggr_rgb_func='softmax',
            double_side=True, face_chunk=8, pixel_tile=64,
            backend='pallas')
        params = params_dict(dist_scale=3e-2)
        fvj, texj = jnp.asarray(fv), jnp.asarray(tex)
        finfo = prep.faces_info(fvj)
        want, want_ag = J_XF(fvj, texj, finfo, cfg, params)
        got, got_ag, aux = J_PFA(fvj, texj, cfg, params)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-4, rtol=1e-3)
        g = jnp.asarray(rng.randn(1, 4, 16, 16).astype(np.float32))
        want_f, want_t = J_XB(fvj, texj, finfo, want, want_ag, g,
                                    cfg, params)
        got_f, got_t = J_PBA(fvj, texj, aux, got, got_ag, g,
                                            cfg, params)
        np.testing.assert_allclose(np.asarray(got_f), np.asarray(want_f),
                                   atol=2e-4, rtol=2e-3)
        np.testing.assert_allclose(np.asarray(got_t), np.asarray(want_t),
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize('backend', ['xla', 'pallas'])
def test_alpha_only_channels(backend):
    """channels='alpha' returns the identical alpha channel and background
    RGB (a documented silhouette fast path, not in the reference)."""
    from gendr_jax.raster.render import render
    rng = np.random.RandomState(6)
    fv = random_scene(rng, B=1, F=9)
    tex = np.ones((1, 9, 1, 3), np.float32)
    kw = dict(image_size=16, dist_func='uniform', dist_scale=5e-2,
              aggr_rgb_func='hard', face_chunk=8,
              background_color=(0.3, 0.1, 0.6), backend=backend)
    full = np.asarray(render(fv, tex, **kw))
    al = np.asarray(render(fv, tex, channels='alpha', **kw))
    np.testing.assert_allclose(al[:, 3], full[:, 3], atol=1e-6)
    np.testing.assert_allclose(al[0, 0], 0.3, atol=1e-6)

    def loss(v, ch):
        img = render(v, tex, channels=ch, **kw)
        return jnp.sum(img[:, 3] ** 2)

    g_full = np.asarray(jax.grad(lambda v: loss(v, 'rgba'))(jnp.asarray(fv)))
    g_al = np.asarray(jax.grad(lambda v: loss(v, 'alpha'))(jnp.asarray(fv)))
    # grads identical up to fusion-order rounding (z column is zero in
    # both: hard RGB contributes no z grads)
    np.testing.assert_allclose(g_al, g_full, atol=1e-5, rtol=1e-4)


def test_bbox_gate_kills_phantom_sliver_coverage():
    """Near-degenerate sliver faces blow up the fp32 barycentric inverse:
    far pixels can read all-positive w ("inside") and contribute phantom
    coverage up to ~1 (diagnosed at 512^2 x 20480 faces: thin bands of
    phantom alpha 1e-4..0.3 crossing the image).  The per-pair bbox gate
    (pairmath P_MARGIN) must zero every pair whose pixel lies outside the
    vertex-derived bbox + probability-radius margin — independent of how
    badly the barycentric algebra misbehaves."""
    from gendr_jax.raster import pack
    from gendr_jax.raster import pairmath as PM

    # a sliver: two vertices 1e-7 apart, third collinear to fp32 noise
    fvert = np.array([[0.10, 0.10, 2.0,
                       0.10 + 1e-7, 0.10 + 1e-7, 2.0,
                       0.30, 0.30 + 1e-7, 2.0]], np.float32)[None]
    tex = np.ones((1, 1, 1, 3), np.float32)
    cfg = C.RenderConfig.create(image_size=64, dist_func='logistic',
                                aggr_alpha_func='probabilistic',
                                aggr_rgb_func='hard', backend='xla')
    params = params_dict(dist_scale=3e-3)
    packed = pack.pack_faces(jnp.asarray(fvert), jnp.asarray(tex),
                             jnp.ones((1,), bool), cfg)
    par = PM._params_vec(params, cfg=cfg)

    def row(i):
        return packed[0, i, :].reshape(1, 1)

    # probe pixels far outside the bbox+margin in every direction
    margin = float(np.asarray(pack.cull_margin(cfg, params)))
    for (px, py) in [(-0.9, -0.9), (0.9, 0.9), (0.9, -0.9), (-0.9, 0.9),
                     (0.2, 0.9), (0.9, 0.2)]:
        assert not (0.10 - margin <= px <= 0.30 + margin
                    and 0.10 - margin <= py <= 0.30 + margin)
        q = PM._pair_math(row, jnp.float32(px), jnp.float32(py),
                          [jnp.float32(x) for x in np.asarray(par)], cfg)
        assert float(np.asarray(q['frag'])) == 0.0, (px, py)
        assert not bool(np.asarray(q['valid'])), (px, py)
        assert bool(np.asarray(q['cull'])), (px, py)
        assert not bool(np.asarray(q['in_loose'])), (px, py)
    # and a pixel INSIDE the gate keeps nonzero coverage near the sliver
    q = PM._pair_math(row, jnp.float32(0.2), jnp.float32(0.2 + 1e-3),
                      [jnp.float32(x) for x in np.asarray(par)], cfg)
    assert float(np.asarray(q['frag'])) > 1e-6




# ---------------------------------------------------------------------------
# Tiling, image sizes, bands and the backend decision
# ---------------------------------------------------------------------------

def _sphere_scene(level=1, B=1):
    """A projected icosphere (10 * 4^level faces) seen from the reference's
    default camera."""
    from gendr_jax import data
    from gendr_jax.geometry import core, transforms as T
    v, f = data.icosphere(level)
    verts = jnp.tile(jnp.asarray(v)[None] * 0.8, (B, 1, 1))
    eye = T.get_points_from_angles(2.732, 30.0, 45.0)
    verts = T.perspective(T.look_at(verts, eye), 30.0)
    return core.face_vertices(
        verts, jnp.tile(jnp.asarray(f)[None], (B, 1, 1))).reshape(B, -1, 9)


@pytest.mark.parametrize('image_size', [17, 100, 250])
def test_any_image_size_matches_xla(image_size):
    """Image sizes that are no multiple of the tile: the last row and column
    of tiles overhang the image and the kernels mask the overhang, forward
    and backward (softmax RGB, vertex colours).  Vertex colours keep the
    gradient well conditioned: a surface texel index computed from clipped
    barycentrics of outside pixels (cu:178-185) is decided by rounding, so
    two compilations legitimately route some texel gradients differently
    at soft outside pixels."""
    fv = _sphere_scene(level=1)
    F = fv.shape[1]
    tex = jnp.asarray(np.random.RandomState(4).rand(1, F, 3, 3)
                      .astype(np.float32))
    kw = dict(image_size=image_size, dist_func='logistic', dist_scale=2e-2,
              aggr_alpha_func='probabilistic', aggr_rgb_func='softmax',
              texture_type='vertex', face_chunk=16)
    w = jnp.asarray(np.random.RandomState(5).randn(
        1, 4, image_size, image_size).astype(np.float32))

    def run(backend):
        from gendr_jax.raster.render import render

        def loss(v, t):
            img = render(v, t, backend=backend, **kw)
            return jnp.sum(img * w), img

        (_, img), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(fv, tex)
        return [np.asarray(x) for x in (img,) + grads]

    got, want = run('pallas'), run('xla')
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=1e-3)
    _assert_mostly_close(got[1], want[1], atol=2e-4, rtol=2e-3)
    _assert_mostly_close(got[2], want[2], atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize('image_size,pixel_tile,want', [
    (256, 0, (16, 8)),    # the default: 128 pixels, 16 wide
    (250, 0, (16, 8)),    # overhanging tiles, same shape
    (8, 0, (8, 16)),      # narrow image: the width shrinks, the count holds
    (16, 64, (16, 4)),
])
def test_tile_shape_and_grid(image_size, pixel_tile, want):
    """The wrapper's choice of tile: a power of two of pixels, at most 16
    wide; the grid is ceil-divided, so tiles cover the image with at most
    one overhanging row and column."""
    cfg = C.RenderConfig.create(image_size=image_size, pixel_tile=pixel_tile)
    assert PB._tile_shape(cfg) == want
    tiles = PB._Tiles(cfg, image_size)
    tw, th = want
    assert tiles.tx_n == -(-image_size // tw)
    assert tiles.ty_n == -(-image_size // th)
    assert (tiles.tx_n - 1) * tw < image_size <= tiles.tx_n * tw
    # every image pixel is covered exactly once by the tiles' on-image
    # pixels, in row-major order
    seen = np.zeros(image_size * image_size, int)
    for t in range(tiles.n):
        _, _, inside, pidx = tiles.pixels(jnp.int32(t), jnp.int32(0))
        seen[np.asarray(pidx)[np.asarray(inside)]] += 1
    assert (seen == 1).all()


def test_pixel_tile_must_be_a_power_of_two():
    with pytest.raises(ValueError, match='power of two'):
        PB._tile_shape(C.RenderConfig.create(pixel_tile=96))


@pytest.mark.parametrize('platform,want', [
    ('gpu', 'pallas'), ('cpu', 'xla'), ('rocm', None)])
def test_platform_backend_decision(monkeypatch, platform, want):
    """One decision from the platform: the kernels on a GPU, the XLA scan on
    the CPU, an error anywhere else; an explicit backend overrides it."""
    from gendr_jax.raster import render as R

    class Dev:
        pass

    dev = Dev()
    dev.platform = platform
    monkeypatch.setattr(R.jax, 'devices', lambda *a: [dev])
    cfg = C.RenderConfig.create()
    if want is None:
        with pytest.raises(RuntimeError, match='no raster backend'):
            R.backend_name(cfg)
    else:
        assert R.backend_name(cfg) == want
        assert R._get_backend(cfg).__name__.endswith(want + '_backend')
    assert R.backend_name(C.RenderConfig.create(backend='xla')) == 'xla'


def test_interpret_only_on_cpu(monkeypatch):
    """The kernels interpret on the CPU only; on a GPU they compile."""
    assert PB._interpret()

    class Dev:
        platform = 'gpu'

    monkeypatch.setattr(PB.jax, 'devices', lambda *a: [Dev()])
    assert not PB._interpret()


@pytest.mark.parametrize('level', [1, 2])
def test_band_render_bitwise(level):
    """Row-band renders (the pixel-sharded path) must be bitwise equal to
    the same rows of the full render: a band's tiles see the same hit lists
    and fold the same faces in the same order per pixel."""
    from gendr_jax.raster import xla_backend as XB
    fv = _sphere_scene(level=level)
    F = fv.shape[1]
    tex = jnp.ones((1, F, 1, 3), jnp.float32)
    cfg = C.RenderConfig.create(
        image_size=64, dist_func='logistic',
        aggr_alpha_func='probabilistic', aggr_rgb_func='hard',
        backend='pallas', face_chunk=32)
    params = params_dict(dist_scale=3e-3)
    bg = jnp.zeros((1, 64 * 64, 3), jnp.float32)

    def finalize(carry, P_loc, bg_rows):
        merged = XB.background_carry(1, P_loc, bg_rows, cfg, params)
        merged = XB.merge_carries(merged, carry, cfg, params)
        return XB.finalize(merged, cfg)[0]

    carry, _ = PB.forward_partial(fv, tex, cfg, params)
    full = np.asarray(finalize(carry, 64 * 64, bg))
    bands = []
    for r0 in (0, 32):
        c, _ = PB.forward_partial(fv, tex, cfg, params, row_band=(r0, 32))
        bands.append(np.asarray(finalize(c, 64 * 32, bg[:, :64 * 32])))
    band_img = np.concatenate(bands, axis=2)
    nbit = int((full.view(np.uint32) != band_img.view(np.uint32)).sum())
    assert nbit == 0, f'{nbit} values differ bitwise'


@pytest.mark.parametrize('rgb', ['softmax', 'hard'])
def test_backward_is_deterministic(rgb):
    """Each face's vertex and texture gradients are summed by one program in
    a fixed order, with no atomics: two runs agree bitwise."""
    fv = _sphere_scene(level=1, B=2)
    F = fv.shape[1]
    tex = jnp.asarray(np.random.RandomState(6).rand(2, F, 4, 3)
                      .astype(np.float32))
    cfg = C.RenderConfig.create(image_size=32, dist_func='gaussian',
                                aggr_rgb_func=rgb, face_chunk=16,
                                backend='pallas')
    params = params_dict(dist_scale=2e-2)
    soft, aggrs = J_PF(fv, tex, None, cfg, params)
    g = jnp.asarray(np.random.RandomState(7).randn(*soft.shape)
                    .astype(np.float32))
    a = [np.asarray(x) for x in J_PB(fv, tex, None, soft, aggrs, g, cfg,
                                     params)]
    b = [np.asarray(x) for x in J_PB(fv, tex, None, soft, aggrs, g, cfg,
                                     params)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert np.abs(a[0]).max() > 0 and np.abs(a[1]).max() > 0
