"""Convergence smoke tests for the three experiments (tiny configs).

The reference validates itself through these experiments' metrics
(SURVEY.md §4); these are their miniature equivalents.
"""

import runpy
import sys

import numpy as np
import pytest


def run_script(path, argv):
    old = sys.argv
    sys.argv = [path] + argv
    try:
        return runpy.run_path(path, run_name='__main__')
    finally:
        sys.argv = old


@pytest.mark.slow
def test_opt_shape_quick(tmp_path):
    # procedural 12-face cube target: the smoke test exercises the whole
    # pipeline; convergence quality needs full-length runs
    mod = run_script('experiments/opt_shape.py',
                     ['--quick', '-ni', '4', '-is', '24', '--chain', '4',
                      '--model_obj', 'proc_cube.obj',
                      '--views', '24@0', '--out-dir', str(tmp_path)])


@pytest.mark.slow
def test_opt_camera_quick(tmp_path):
    run_script('experiments/opt_camera.py',
               ['--quick', '-is', '24', '-ni', '10', '-bs', '4',
                '--chain', '5', '--model_obj', 'proc_cube.obj',
                '--out-dir', str(tmp_path)])


@pytest.mark.slow
def test_train_reconstruction_synthetic(tmp_path):
    run_script('experiments/train_reconstruction.py',
               ['--quick', '--synthetic', '--image_size', '16',
                '--num_iterations', '4', '--batch_size', '4',
                '--max-eval-batches', '1'])


@pytest.mark.slow
def test_train_reconstruction_checkpoint_resume(tmp_path):
    """Checkpoints save at eval_freq and restore on restart (the reference
    never saves its model; this is the orbax addition)."""
    ckpt = str(tmp_path / 'ckpt')
    argv = ['--quick', '--synthetic', '--image_size', '16',
            '--num_iterations', '4', '--batch_size', '2',
            '--max-eval-batches', '1', '--checkpoint-dir', ckpt]
    run_script('experiments/train_reconstruction.py', argv)
    import os
    steps = [d for d in os.listdir(ckpt) if d.isdigit()]
    assert steps, os.listdir(ckpt)
    # second run restores and resumes past the saved step (no retraining:
    # start_iter == num_iterations + 1 -> straight to final eval)
    run_script('experiments/train_reconstruction.py', argv)


def test_shapenet_npz_loader(tmp_path):
    """The ShapeNet npz ingestion path (never exercised by --synthetic):
    per-class `{id}_{set}_images.npz` / `{id}_{set}_voxels.npz` trees load,
    batch, and iterate exactly like the reference's loader
    (train_reconstruction.py:271-358)."""
    sys.path.insert(0, '.')
    import numpy as np
    from experiments.train_reconstruction import ShapeNet, CLASS_IDS_MAP

    root = tmp_path / 'data'
    d = root / 'mesh_reconstruction'
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    class_ids = ['02691156', '03001627']
    n_obj = {cid: 3 + i for i, cid in enumerate(class_ids)}
    for cid in class_ids:
        n = n_obj[cid]
        # NMR dataset format: per-class images npz is [n_obj, 24, 4, H, W]
        # uint8 (the loader flattens to [n_obj*24, 4, H, W])
        images = (rng.rand(n, 24, 4, 64, 64) * 255).astype(np.uint8)
        voxels = (rng.rand(n, 32, 32, 32) > 0.5).astype(np.uint8)
        np.savez(str(d / f'{cid}_train_images.npz'), images)
        np.savez(str(d / f'{cid}_train_voxels.npz'), voxels)

    ds = ShapeNet(str(root), class_ids, 'train')
    assert ds.images.shape == ((3 + 4) * 24, 4, 64, 64)
    assert ds.voxels.shape[0] == 7

    ia, ib, ea, eb = ds.get_random_batch(np.random.RandomState(1), 8)
    assert ia.shape == (8, 4, 64, 64) and ia.dtype == np.float32
    assert ea.shape == (8, 3)
    assert float(ia.max()) <= 1.0

    ids_a, ids_b, ea2, eb2 = ds.get_random_batch_ids(
        np.random.RandomState(1), 8)
    # identical rng draws -> the id variant indexes the same images
    np.testing.assert_allclose(ds.images[ids_a] / 255.0, ia)
    np.testing.assert_allclose(ea2, ea)

    total = 0
    for im, vx in ds.get_all_batches_for_evaluation(16, class_ids[0]):
        assert im.shape[1:] == (4, 64, 64)
        assert vx.shape[1:] == (32, 32, 32)
        total += im.shape[0]
    assert total == 3 * 24

    pairs = dict(ds.class_ids_pair)
    assert pairs['02691156'] == CLASS_IDS_MAP['02691156']


@pytest.mark.slow
def test_train_reconstruction_mock_real_tree(tmp_path):
    """End-to-end on a generated FULL-SHAPE mock of the real ShapeNet tree
    (13 class ids x 24 views x 64^2 rgba images x 32^3 voxels): 2 train
    steps + 1 full multi-class eval, crossing exactly the code paths a real
    run would (reference train_reconstruction.py:365-490)."""
    import numpy as np
    sys.path.insert(0, '.')
    from experiments.train_reconstruction import CLASS_IDS_MAP

    class_ids = [c for c in CLASS_IDS_MAP if not c.startswith('syn')]
    assert len(class_ids) == 13
    root = tmp_path / 'data'
    d = root / 'mesh_reconstruction'
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for cid in class_ids:
        for set_name in ('train', 'val'):
            images = (rng.rand(2, 24, 4, 64, 64) * 255).astype(np.uint8)
            voxels = (rng.rand(2, 32, 32, 32) > 0.7).astype(np.uint8)
            np.savez(str(d / f'{cid}_{set_name}_images.npz'), images)
            np.savez(str(d / f'{cid}_{set_name}_voxels.npz'), voxels)

    mod = run_script(
        'experiments/train_reconstruction.py',
        ['--dataset-dir', str(root), '--num_iterations', '2',
         '--batch_size', '2', '--print_freq', '1', '--eval_freq', '3',
         '--max-eval-batches', '1', '--chain', '1'])


def test_shape_model_parametrization():
    """The sigmoid reparametrization reproduces the template at zero
    displacement (opt_shape.py:75-87)."""
    sys.path.insert(0, '.')
    from experiments.opt_shape import ShapeModel
    import jax.numpy as jnp
    m = ShapeModel(642)
    params = m.init_params()
    verts, faces, lap, flat = m(params, 2)
    np.testing.assert_allclose(np.asarray(verts[0]),
                               np.asarray(m.base_vertices), atol=1e-5)
    assert verts.shape[0] == 2
    assert float(lap) >= 0 and float(flat) >= 0


def test_default_dist_scale_table():
    sys.path.insert(0, '.')
    from experiments.train_reconstruction import default_dist_scale
    # spot-check against train_reconstruction.py:556-574
    assert default_dist_scale('uniform', False, 'probabilistic', 0.0) == \
        pytest.approx(10 ** -1.5)
    assert default_dist_scale('logistic', True, 'yager', 2.0) == \
        pytest.approx(10 ** -4.0)
    assert default_dist_scale('cauchy', True, 'probabilistic', 0.0) == \
        pytest.approx(10 ** -4.5)
    with pytest.raises(AssertionError):
        default_dist_scale('levy', False, 'probabilistic', 0.0)
