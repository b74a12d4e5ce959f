"""Multi-device tests on the virtual 8-device CPU mesh: the face-sharded +
batch-sharded render must match the single-device path, forward and
backward."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gendr_jax import config as C
from gendr_jax.parallel import sharding as S
from gendr_jax.raster.render import render
from tests.test_render import random_scene, params_dict

# Eager dispatch of the shard_map programs (and of the unsharded reference
# renders / grads) op-by-op from Python dominated this file's wall time
# (~5-8x the cost of one jit compile+run of the same program).  cfg and
# mesh are hashable -> static; axis-name kwargs are static by name.
J_RS = jax.jit(S.render_sharded, static_argnums=(2, 4),
               static_argnames=('dp_axis', 'fp_axis', 'sp_axis', 'backend',
                                'check_replication'))


def _jit_grad2(loss):
    """jit(grad(loss)) over the first two args."""
    return jax.jit(jax.grad(loss, argnums=(0, 1)))


@pytest.fixture(scope='module')
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    return S.make_mesh({'dp': 2, 'fp': 4})


@pytest.fixture(scope='module')
def mesh22():
    """2x2 submesh for the pallas variants: interpret-mode kernels under
    shard_map dominate the suite's wall time, and 2 fp shards already
    exercise the cross-shard carry merge + base-offset routing."""
    if len(jax.devices()) < 4:
        pytest.skip('needs 4 virtual devices')
    return S.make_mesh({'dp': 2, 'fp': 2})


@pytest.mark.parametrize('backend', [
    'xla', pytest.param('pallas', marks=pytest.mark.exhaustive)])
@pytest.mark.parametrize('rgb', [
    'hard', pytest.param('softmax', marks=pytest.mark.exhaustive)])
def test_sharded_forward_matches(mesh, mesh22, rgb, backend):
    # default tier: hard-xla only; the pallas/softmax corners run in the
    # exhaustive tier (GENDR_EXHAUSTIVE=1) and are subsumed by
    # test_sharded_gradients_match[softmax-pallas], which runs the same
    # forward under grad
    if backend == 'pallas':
        mesh = mesh22
    B, F = (4, 37) if backend == 'xla' else (2, 21)
    rng = np.random.RandomState(0)
    fv = random_scene(rng, B=B, F=F).reshape(B, F, 9)
    tex = rng.rand(B, F, 1, 3).astype(np.float32)
    cfg = C.RenderConfig.create(image_size=16, dist_func='uniform',
                                aggr_alpha_func='probabilistic',
                                aggr_rgb_func=rgb, face_chunk=4,
                                backend=backend)
    params = params_dict(dist_scale=3e-2,
                         background_color=np.array([0.2, 0.1, 0.4]))

    got = J_RS(fv, tex, cfg, params, mesh)
    # reference = the SAME backend unsharded (sharding must be a no-op;
    # pallas-vs-xla parity is covered by test_pallas)
    want = jax.jit(lambda fv_, tex_: render(
        fv_, tex_, image_size=16, dist_func='uniform',
        aggr_alpha_func='probabilistic', aggr_rgb_func=rgb,
        dist_scale=3e-2, face_chunk=4, backend=backend,
        background_color=np.array([0.2, 0.1, 0.4])))(fv, tex)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize('rgb', [
    'hard', pytest.param('softmax', marks=pytest.mark.exhaustive)])
def test_fp_carry_merge_is_replicated(mesh, rgb):
    # render_sharded's production out_specs drop the fp axis under
    # check_vma=False, so a bug that made the merged carry device-varying
    # would silently ship shard 0's pixels.  check_replication=True exposes
    # one copy per fp shard; the all_gather + identical deterministic fold
    # must make them BITWISE equal.
    B, F = 4, 37
    rng = np.random.RandomState(3)
    fv = random_scene(rng, B=B, F=F).reshape(B, F, 9)
    tex = rng.rand(B, F, 1, 3).astype(np.float32)
    cfg = C.RenderConfig.create(image_size=16, dist_func='logistic',
                                aggr_alpha_func='probabilistic',
                                aggr_rgb_func=rgb, face_chunk=4,
                                backend='xla')
    params = params_dict(dist_scale=3e-2,
                         background_color=np.array([0.2, 0.1, 0.4]))
    copies = np.asarray(J_RS(fv, tex, cfg, params, mesh,
                             check_replication=True))
    assert copies.shape[0] == mesh.shape['fp']
    for i in range(1, copies.shape[0]):
        np.testing.assert_array_equal(copies[0], copies[i])


@pytest.mark.parametrize('backend', [
    pytest.param('xla', marks=pytest.mark.exhaustive), 'pallas'])
@pytest.mark.parametrize('rgb', ['hard', 'softmax'])
def test_sharded_gradients_match(mesh, mesh22, rgb, backend):
    # default tier: softmax-pallas (the fullest path: production kernels,
    # fp carry merge, streaming-softmax z-chain, grads) AND hard-pallas
    # (the flagship silhouette config — its deferred texture-grad routing
    # must mask cross-shard winner ids, a bug class the softmax path cannot
    # catch); xla corners are exhaustive-tier
    if backend == 'pallas':
        mesh = mesh22
    B, F = (4, 21) if backend == 'xla' else (2, 13)
    rng = np.random.RandomState(1)
    fv = random_scene(rng, B=B, F=F).reshape(B, F, 9)
    tex = rng.rand(B, F, 1, 3).astype(np.float32)
    cfg = C.RenderConfig.create(image_size=12, dist_func='logistic',
                                aggr_alpha_func='probabilistic',
                                aggr_rgb_func=rgb, face_chunk=4,
                                backend=backend)
    params = params_dict(dist_scale=5e-2)
    render_fn = S.make_sharded_render(cfg, mesh)

    def loss_sharded(fv_, tex_):
        img = render_fn(fv_, tex_, params)
        return jnp.sum(img[:, 3] ** 2) + jnp.sum(img[:, :3] * 0.3)

    def loss_ref(fv_, tex_):
        # same backend unsharded: isolates the sharding-correctness property
        img = render(fv_, tex_, image_size=12, dist_func='logistic',
                     aggr_alpha_func='probabilistic', aggr_rgb_func=rgb,
                     dist_scale=5e-2, face_chunk=4, backend=backend)
        return jnp.sum(img[:, 3] ** 2) + jnp.sum(img[:, :3] * 0.3)

    g_sh = _jit_grad2(loss_sharded)(jnp.asarray(fv), jnp.asarray(tex))
    g_ref = _jit_grad2(loss_ref)(jnp.asarray(fv), jnp.asarray(tex))
    for a, b in zip(g_sh, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5, rtol=1e-3)


@pytest.mark.parametrize('tcn,p', [
    pytest.param('yager', 2.0, marks=pytest.mark.exhaustive),
    ('max', 0.0)])
def test_sharded_pallas_exotic_tconorms(mesh22, tcn, p):
    """Generic-butterfly and max t-conorm folds must also survive the
    cross-shard carry merge on the pallas path."""
    mesh = mesh22
    rng = np.random.RandomState(7)
    fv = random_scene(rng, B=2, F=19).reshape(2, 19, 9)
    tex = rng.rand(2, 19, 1, 3).astype(np.float32)
    cfg = C.RenderConfig.create(image_size=16, dist_func='gaussian',
                                aggr_alpha_func=tcn, face_chunk=4,
                                backend='pallas')
    params = params_dict(dist_scale=4e-2, aggr_alpha_t_conorm_p=p)
    got = J_RS(fv, tex, cfg, params, mesh)
    want = jax.jit(lambda fv_, tex_: render(
        fv_, tex_, image_size=16, dist_func='gaussian',
        aggr_alpha_func=tcn, aggr_alpha_t_conorm_p=p,
        dist_scale=4e-2, face_chunk=4, backend='pallas'))(fv, tex)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-5, rtol=1e-4)


@pytest.fixture(scope='module')
def mesh222():
    """Full 3-axis mesh: batch x faces x image rows."""
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    return S.make_mesh({'dp': 2, 'fp': 2, 'sp': 2})


@pytest.mark.parametrize('backend', [
    pytest.param('xla', marks=pytest.mark.exhaustive), 'pallas'])
@pytest.mark.parametrize('rgb', [
    'hard', pytest.param('softmax', marks=pytest.mark.exhaustive)])
def test_pixel_sharded_render_matches(mesh222, rgb, backend):
    """sp (image-row) sharding composed with dp x fp must be a no-op vs the
    unsharded render: each device renders a row band with global NDC
    coordinates (SURVEY.md 2.4's 'embarrassingly parallel pixel axis'),
    and the backward completes face/texture grads with one psum over sp."""
    B, F = 2, 17
    rng = np.random.RandomState(3)
    fv = random_scene(rng, B=B, F=F).reshape(B, F, 9)
    tex = rng.rand(B, F, 1, 3).astype(np.float32)
    kw = dict(image_size=16, dist_func='uniform',
              aggr_alpha_func='probabilistic', aggr_rgb_func=rgb,
              face_chunk=4, backend=backend)
    cfg = C.RenderConfig.create(**kw)
    params = params_dict(dist_scale=3e-2,
                         background_color=np.array([0.2, 0.1, 0.4]))

    got = J_RS(fv, tex, cfg, params, mesh222, sp_axis='sp')
    want = jax.jit(lambda fv_, tex_: render(
        fv_, tex_, dist_scale=3e-2,
        background_color=np.array([0.2, 0.1, 0.4]), **kw))(fv, tex)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-5, rtol=1e-4)

    render_fn = S.make_sharded_render(cfg, mesh222, sp_axis='sp')

    def loss_sharded(fv_, tex_):
        img = render_fn(fv_, tex_, params)
        return jnp.sum(img[:, 3] ** 2) + jnp.sum(img[:, :3] * 0.3)

    def loss_ref(fv_, tex_):
        img = render(fv_, tex_, dist_scale=3e-2,
                     background_color=np.array([0.2, 0.1, 0.4]), **kw)
        return jnp.sum(img[:, 3] ** 2) + jnp.sum(img[:, :3] * 0.3)

    g_sh = _jit_grad2(loss_sharded)(jnp.asarray(fv), jnp.asarray(tex))
    g_ref = _jit_grad2(loss_ref)(jnp.asarray(fv), jnp.asarray(tex))
    for a, b in zip(g_sh, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5, rtol=1e-3)


def test_dryrun_entrypoints():
    import __graft_entry__ as GE
    fn, args = GE.entry()
    jax.jit(fn).lower(*args)  # compile-check (lowering only: fast on CPU)
    GE.dryrun_multichip(len(jax.devices()))
