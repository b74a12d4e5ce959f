"""Single-view 3D reconstruction on ShapeNet (13 classes).

JAX counterpart of the reference experiment
(experiments/train_reconstruction.py): a conv encoder + template-sphere
decoder is trained with a 2-view silhouette IoU loss through the
differentiable renderer, and evaluated by 32^3 voxel IoU against ground
truth.  Improvements over the reference: the full train step (encoder ->
decoder -> lighting -> look_at -> render x4 -> losses -> Adam) is one jitted
function; evaluation voxelization runs fully on device (no per-iteration
host sync); orbax checkpointing (the reference never saves its model,
SURVEY.md §5); optional batch data-parallel sharding over a device mesh.

Dataset: the reference downloads mesh_reconstruction.zip (npz per class,
train_reconstruction.py:272-312).  This environment has no egress, so point
--dataset-dir at an existing copy, or pass --synthetic for a procedurally
generated stand-in dataset (renders of randomly deformed spheres) that
exercises the full pipeline end to end.
"""

from __future__ import annotations

import argparse
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
from gendr_jax.geometry import core, voxelize
from experiments.common import iou_loss, use_compile_cache

CLASS_IDS_MAP = {
    '02691156': 'Airplane', '02828884': 'Bench', '02933112': 'Cabinet',
    '02958343': 'Car', '03001627': 'Chair', '03211117': 'Display',
    '03636649': 'Lamp', '03691459': 'Loudspeaker', '04090263': 'Rifle',
    '04256520': 'Sofa', '04379243': 'Table', '04401088': 'Telephone',
    '04530566': 'Watercraft',
}

# tuned default log10(dist_scale) per (distribution x t-conorm)
# (train_reconstruction.py:556-574)
DISTS_WITH_DEFAULT_SCALE = [
    'uniform', 'gaussian', 'logistic', 'logistic_squares', 'cauchy',
    'cauchy_squares', 'gumbel_min', 'gamma_rev', 'gamma_rev_squares',
    'exponential_rev',
]
TCONORMS_WITH_DEFAULT_SCALE = ['probabilistic_0.0', 'einstein_0.0',
                               'yager_2.0']
DEFAULT_LOG_SCALES = np.array([
    [-1.5, -1.5, -1.5],
    [-1.5, -1.5, -2.0],
    [-2.0, -2.0, -2.0],
    [-4.0, -4.0, -4.0],
    [-3.5, -3.5, -3.0],
    [-4.5, -4.5, -4.0],
    [-2.0, -2.5, -2.0],
    [-2.0, -2.0, -2.0],
    [-4.0, -4.0, -3.5],
    [-2.0, -2.0, -2.0],
], np.float32)


def default_dist_scale(distribution, squared, t_conorm, t_conorm_p):
    dist = distribution + ('_squares' if squared else '')
    tcn = f'{t_conorm}_{t_conorm_p:.1f}'
    assert dist in DISTS_WITH_DEFAULT_SCALE, dist
    assert tcn in TCONORMS_WITH_DEFAULT_SCALE, tcn
    log_scale = DEFAULT_LOG_SCALES[
        DISTS_WITH_DEFAULT_SCALE.index(dist),
        TCONORMS_WITH_DEFAULT_SCALE.index(tcn)]
    return float(10 ** log_scale)


# ---------------------------------------------------------------------------
# Models (train_reconstruction.py:91-167), in plain jax: parameters are
# nested dicts of arrays, initialised like torch-free defaults (LeCun-normal
# kernels, zero biases, unit BatchNorm scale)
# ---------------------------------------------------------------------------

_lecun = jax.nn.initializers.lecun_normal()
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def _dense_init(key, fan_in, fan_out):
    return dict(w=_lecun(key, (fan_in, fan_out), jnp.float32),
                b=jnp.zeros((fan_out,), jnp.float32))


def _dense(p, x):
    return x @ p['w'] + p['b']


class Encoder:
    """Three stride-2 5x5 conv + BatchNorm + ReLU blocks, then three dense
    layers (train_reconstruction.py:91-117).  NCHW in, NHWC inside."""

    def __init__(self, dim_out=512, dim1=64, dim2=1024):
        self.dims = (dim1, dim1 * 2, dim1 * 4)
        self.dim2, self.dim_out = dim2, dim_out

    def init(self, key, in_ch, image_size):
        keys = jax.random.split(key, 6)
        params, stats = {}, {}
        cin = in_ch
        for i, d in enumerate(self.dims):
            params[f'conv{i}'] = dict(
                w=_lecun(keys[i], (5, 5, cin, d), jnp.float32),
                b=jnp.zeros((d,), jnp.float32))
            params[f'bn{i}'] = dict(scale=jnp.ones((d,), jnp.float32),
                                    bias=jnp.zeros((d,), jnp.float32))
            stats[f'bn{i}'] = dict(mean=jnp.zeros((d,), jnp.float32),
                                   var=jnp.ones((d,), jnp.float32))
            cin = d
            image_size = -(-image_size // 2)
        flat = image_size * image_size * cin
        params['fc0'] = _dense_init(keys[3], flat, self.dim2)
        params['fc1'] = _dense_init(keys[4], self.dim2, self.dim2)
        params['fc2'] = _dense_init(keys[5], self.dim2, self.dim_out)
        return params, stats

    def apply(self, params, stats, x, train):
        """Returns (features, new batch statistics)."""
        x = jnp.transpose(x, (0, 2, 3, 1))
        new_stats = {}
        for i in range(len(self.dims)):
            c = params[f'conv{i}']
            x = jax.lax.conv_general_dilated(
                x, c['w'], window_strides=(2, 2), padding=((2, 2), (2, 2)),
                dimension_numbers=('NHWC', 'HWIO', 'NHWC')) + c['b']
            st = stats[f'bn{i}']
            if train:
                mean = jnp.mean(x, axis=(0, 1, 2))
                var = jnp.mean(jnp.square(x), axis=(0, 1, 2)) - mean ** 2
                new_stats[f'bn{i}'] = dict(
                    mean=BN_MOMENTUM * st['mean'] + (1 - BN_MOMENTUM) * mean,
                    var=BN_MOMENTUM * st['var'] + (1 - BN_MOMENTUM) * var)
            else:
                mean, var = st['mean'], st['var']
                new_stats[f'bn{i}'] = st
            bn = params[f'bn{i}']
            x = (x - mean) * jax.lax.rsqrt(var + BN_EPS) * bn['scale'] \
                + bn['bias']
            x = jax.nn.relu(x)
        x = x.reshape(x.shape[0], -1)
        for name in ('fc0', 'fc1', 'fc2'):
            x = jax.nn.relu(_dense(params[name], x))
        return x, new_stats


class Decoder:
    """Template-sphere deformation head (NMR-style; reference semantics
    train_reconstruction.py:119-167).

    An MLP predicts a per-vertex displacement in logit space plus a global
    centroid shift; the template's coordinates are mapped axis-wise to
    logits, displaced, and squashed back through a sigmoid, so the deformed
    mesh can never leave the unit volume.
    """

    def __init__(self, nv, centroid_scale=0.1, bias_scale=1.0, width=1024):
        self.nv = nv
        self.centroid_scale, self.bias_scale = centroid_scale, bias_scale
        self.width = width

    def init(self, key, dim_in):
        keys = jax.random.split(key, 4)
        w = self.width
        return dict(fc0=_dense_init(keys[0], dim_in, w),
                    fc1=_dense_init(keys[1], w, w * 2),
                    centroid=_dense_init(keys[2], w * 2, 3),
                    displace=_dense_init(keys[3], w * 2, self.nv * 3))

    def apply(self, params, features, vertices_base):
        h = jax.nn.relu(_dense(params['fc0'], features))
        h = jax.nn.relu(_dense(params['fc1'], h))
        centroid = jnp.tanh(
            _dense(params['centroid'], h) * self.centroid_scale)[:, None, :]
        displace = (_dense(params['displace'], h)
                    * self.bias_scale).reshape(-1, self.nv, 3)

        # template -> per-axis logits (half-extent scale keeps |t| < 1)
        template = vertices_base * 0.5
        axis_sign = jnp.sign(template)
        t_abs = jnp.abs(template)
        logits = jnp.log(t_abs / (1.0 - t_abs))
        deformed = jax.nn.sigmoid(logits + displace) * axis_sign

        # squeeze each half-space toward the shifted centroid so the
        # translation cannot push vertices out of [-1, 1]
        squeeze_hi = 1.0 - centroid
        squeeze_lo = 1.0 + centroid
        deformed = (jax.nn.relu(deformed) * squeeze_hi
                    - jax.nn.relu(-deformed) * squeeze_lo)
        return (deformed + centroid) * 0.5


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------

class ShapeNet:
    """npz-per-class dataset (train_reconstruction.py:271-358)."""

    def __init__(self, root, class_ids, set_name):
        self.class_ids = class_ids
        self.set_name = set_name
        self.elevation = 30.0
        self.distance = 2.732
        images, voxels = [], []
        self.num_data = {}
        self.pos = {}
        count = 0
        for class_id in class_ids:
            im = np.load(os.path.join(
                root, 'mesh_reconstruction',
                f'{class_id}_{set_name}_images.npz'))
            vx = np.load(os.path.join(
                root, 'mesh_reconstruction',
                f'{class_id}_{set_name}_voxels.npz'))
            images.append(list(im.items())[0][1])
            voxels.append(list(vx.items())[0][1])
            self.num_data[class_id] = images[-1].shape[0]
            self.pos[class_id] = count
            count += self.num_data[class_id]
        self.images = np.ascontiguousarray(
            np.concatenate(images, 0).reshape((-1, 4, 64, 64)))
        self.voxels = np.ascontiguousarray(np.concatenate(voxels, 0))

    @property
    def class_ids_pair(self):
        return zip(self.class_ids,
                   [CLASS_IDS_MAP[i] for i in self.class_ids])

    def get_random_batch(self, rng, batch_size):
        data_ids_a = np.zeros(batch_size, 'int32')
        data_ids_b = np.zeros(batch_size, 'int32')
        vp_a = np.zeros(batch_size, np.float32)
        vp_b = np.zeros(batch_size, np.float32)
        for i in range(batch_size):
            class_id = rng.choice(self.class_ids)
            object_id = rng.randint(0, self.num_data[class_id])
            va = rng.randint(0, 24)
            vb = rng.randint(0, 24)
            data_ids_a[i] = (object_id + self.pos[class_id]) * 24 + va
            data_ids_b[i] = (object_id + self.pos[class_id]) * 24 + vb
            vp_a[i] = va
            vp_b[i] = vb
        images_a = self.images[data_ids_a].astype(np.float32) / 255.
        images_b = self.images[data_ids_b].astype(np.float32) / 255.
        d = np.full(batch_size, self.distance, np.float32)
        e = np.full(batch_size, self.elevation, np.float32)
        eyes_a = np.asarray(gendr_jax.functional.get_points_from_angles(
            d, e, -vp_a * 15))
        eyes_b = np.asarray(gendr_jax.functional.get_points_from_angles(
            d, e, -vp_b * 15))
        return images_a, images_b, eyes_a, eyes_b

    def get_random_batch_ids(self, rng, batch_size):
        """Index-only variant for device-resident data: returns int32 image
        ids + eyes, so the per-step host->device transfer is ~1 KB instead
        of ~8 MB of decoded float images."""
        data_ids_a = np.zeros(batch_size, 'int32')
        data_ids_b = np.zeros(batch_size, 'int32')
        vp_a = np.zeros(batch_size, np.float32)
        vp_b = np.zeros(batch_size, np.float32)
        for i in range(batch_size):
            class_id = rng.choice(self.class_ids)
            object_id = rng.randint(0, self.num_data[class_id])
            va = rng.randint(0, 24)
            vb = rng.randint(0, 24)
            data_ids_a[i] = (object_id + self.pos[class_id]) * 24 + va
            data_ids_b[i] = (object_id + self.pos[class_id]) * 24 + vb
            vp_a[i] = va
            vp_b[i] = vb
        d = np.full(batch_size, self.distance, np.float32)
        e = np.full(batch_size, self.elevation, np.float32)
        eyes_a = np.asarray(gendr_jax.functional.get_points_from_angles(
            d, e, -vp_a * 15))
        eyes_b = np.asarray(gendr_jax.functional.get_points_from_angles(
            d, e, -vp_b * 15))
        return data_ids_a, data_ids_b, eyes_a, eyes_b

    def get_all_batches_for_evaluation(self, batch_size, class_id):
        data_ids = np.arange(self.num_data[class_id]) + self.pos[class_id]
        viewpoint_ids = np.tile(np.arange(24), data_ids.size)
        data_ids = np.repeat(data_ids, 24) * 24 + viewpoint_ids
        for i in range((data_ids.size - 1) // batch_size + 1):
            ids = data_ids[i * batch_size:(i + 1) * batch_size]
            images = self.images[ids].astype(np.float32) / 255.
            voxels = self.voxels[ids // 24].astype(np.float32)
            yield images, voxels


def _synthetic_shape(rng, family, v):
    """One random mesh of a synthetic class family (unit icosphere v)."""
    scale = 0.25 + rng.rand(3) * 0.2
    if family == 'syn_ellipsoid' or family == 'synthetic':
        return (v * scale[None, :]).astype(np.float32)
    if family == 'syn_box':
        # superquadric: pushes the sphere toward a rounded box
        p = 0.45 + rng.rand() * 0.2
        return (np.sign(v) * np.abs(v) ** p * scale[None, :] * 0.85) \
            .astype(np.float32)
    if family == 'syn_peanut':
        # two-lobe pinch along x
        pinch = 0.45 + rng.rand() * 0.25
        r = 1.0 - pinch * np.exp(-(v[:, 0] / 0.35) ** 2)
        out = v * scale[None, :]
        out[:, 1] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    # --- the 10 extra families that bring the synthetic benchmark to the
    # reference's 13-class scale (train_reconstruction.py:254-268 lists 13
    # ShapeNet classes; these are honest procedural stand-ins, each with a
    # distinct silhouette statistic, not ShapeNet data) ---
    if family == 'syn_disk':
        # flattened ellipsoid (display/table-top-like aspect)
        out = v * scale[None, :]
        out[:, 1] *= 0.25 + rng.rand() * 0.15
        return out.astype(np.float32)
    if family == 'syn_pear':
        # linear taper along y (lamp-shade-like)
        t = 0.35 + rng.rand() * 0.25
        r = 1.0 - t * (v[:, 1] + 1.0) * 0.5
        out = v * scale[None, :]
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_star':
        # radial lobes around the y axis
        k = rng.choice([3, 4, 5])
        a = 0.18 + rng.rand() * 0.12
        theta = np.arctan2(v[:, 2], v[:, 0])
        r = 1.0 + a * np.cos(k * theta) * (1.0 - v[:, 1] ** 2)
        out = v * scale[None, :]
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_bump':
        # one gaussian protrusion at a random surface direction
        d = rng.randn(3)
        d /= np.linalg.norm(d)
        a = 0.5 + rng.rand() * 0.3
        r = 1.0 + a * np.exp(-((1.0 - v @ d) / 0.3) ** 2)
        return (v * r[:, None] * scale[None, :] * 0.8).astype(np.float32)
    if family == 'syn_dumbbell':
        # deep asymmetric two-lobe pinch
        pinch = 0.62 + rng.rand() * 0.18
        c = rng.rand() * 0.3 - 0.15
        r = 1.0 - pinch * np.exp(-((v[:, 0] - c) / 0.3) ** 2)
        out = v * scale[None, :]
        out[:, 1] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_cone':
        # taper to a near-point at +y
        t = 0.75 + rng.rand() * 0.2
        r = 1.0 - t * np.clip(v[:, 1], 0.0, 1.0)
        out = v * scale[None, :]
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_capsule':
        # stretched midsection with spherical caps
        s = 0.8 + rng.rand() * 0.6
        out = v * scale[None, :]
        out[:, 0] = np.where(np.abs(v[:, 0]) < 0.5, v[:, 0] * (1 + s),
                             np.sign(v[:, 0]) * (np.abs(v[:, 0]) + 0.5 * s))
        out[:, 0] *= scale[0] * 0.7
        return out.astype(np.float32)
    if family == 'syn_egg':
        # asymmetric ellipsoid: one end fatter
        a = 0.25 + rng.rand() * 0.2
        r = 1.0 + a * v[:, 1]
        out = v * scale[None, :]
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    if family == 'syn_twist':
        # rotation around y proportional to height
        a = (0.6 + rng.rand() * 0.8) * np.pi / 2
        ang = a * v[:, 1]
        c, s = np.cos(ang), np.sin(ang)
        out = v * (scale * np.array([1.0, 1.0, 0.55]))[None, :]
        x, z = out[:, 0].copy(), out[:, 2].copy()
        out[:, 0] = c * x - s * z
        out[:, 2] = s * x + c * z
        return out.astype(np.float32)
    if family == 'syn_wave':
        # sinusoidal radial ripple along y
        k = 2 + rng.randint(3)
        a = 0.12 + rng.rand() * 0.1
        r = 1.0 + a * np.sin(np.pi * k * v[:, 1])
        out = v * scale[None, :]
        out[:, 0] *= r
        out[:, 2] *= r
        return out.astype(np.float32)
    raise ValueError(family)


class SyntheticShapeNet:
    """Procedural stand-in exercising the identical pipeline: random
    meshes from up to three shape families (ellipsoids, rounded boxes,
    two-lobe peanuts), silhouettes rendered by our own hard renderer, GT
    voxels from our own voxelizer.  With multiple classes the full
    multi-class evaluation loop (per-class IoU + mean, reference
    train_reconstruction.py:442-445) runs unchanged."""

    def __init__(self, n_objects=32, image_size=64, seed=0,
                 class_ids=('synthetic',)):
        rng = np.random.RandomState(seed)
        self.class_ids = list(class_ids)
        self.elevation = 30.0
        self.distance = 2.732
        self.num_data = {c: n_objects for c in self.class_ids}
        self.pos = {c: i * n_objects
                    for i, c in enumerate(self.class_ids)}
        v, f = data.icosphere(2)
        renderer = gendr_jax.GenDR(
            image_size=image_size, dist_func=0, dist_scale=1e-4,
            dist_squared=True, dist_eps=1, aggr_alpha_func=0,
            aggr_rgb_func='hard')
        lighting = gendr_jax.Lighting()
        transform = gendr_jax.LookAt(viewing_angle=15)
        azim = -np.arange(24) * 15.0
        transform.set_eyes_from_angles(
            np.full(24, self.distance, np.float32),
            np.full(24, self.elevation, np.float32),
            azim.astype(np.float32))
        faces_b = jnp.asarray(f)[None]

        @jax.jit
        def make_object(verts):
            # one dispatch per object: 24 silhouettes + the GT voxel grid
            mesh = gendr_jax.Mesh.create(jnp.tile(verts[None], (24, 1, 1)),
                                         jnp.tile(faces_b, (24, 1, 1)))
            sil = renderer(transform(lighting(mesh)))[:, 3]
            fv = core.face_vertices(verts[None], faces_b)
            vox = voxelize.voxelization(
                fv * 1.0 * (32 - 1) / 32 + 0.5, 32, False)[0]
            return sil, vox

        images = []
        voxels = []
        for class_id in self.class_ids:
          for _ in range(n_objects):
            verts = jnp.asarray(_synthetic_shape(rng, class_id, v))
            sil, vox = make_object(verts)
            sil = np.asarray(sil)
            vox = np.asarray(vox)
            rgba = np.zeros((24, 4, sil.shape[1], sil.shape[2]),
                            np.float32)
            rgba[:, :3] = sil[:, None]
            rgba[:, 3] = sil
            images.append((rgba * 255).astype(np.uint8))
            voxels.append(vox.transpose(1, 0, 2)[:, :, ::-1])
        self.images = np.concatenate(images, 0).reshape(-1, 4,
                                                        image_size,
                                                        image_size)
        self.voxels = np.stack(voxels, 0).astype(np.float32)

    class_ids_pair = ShapeNet.class_ids_pair
    get_random_batch = ShapeNet.get_random_batch
    get_random_batch_ids = ShapeNet.get_random_batch_ids
    get_all_batches_for_evaluation = ShapeNet.get_all_batches_for_evaluation


CLASS_IDS_MAP['synthetic'] = 'Synthetic'
CLASS_IDS_MAP['syn_ellipsoid'] = 'SynEllipsoid'
CLASS_IDS_MAP['syn_box'] = 'SynBox'
CLASS_IDS_MAP['syn_peanut'] = 'SynPeanut'
CLASS_IDS_MAP['syn_disk'] = 'SynDisk'
CLASS_IDS_MAP['syn_pear'] = 'SynPear'
CLASS_IDS_MAP['syn_star'] = 'SynStar'
CLASS_IDS_MAP['syn_bump'] = 'SynBump'
CLASS_IDS_MAP['syn_dumbbell'] = 'SynDumbbell'
CLASS_IDS_MAP['syn_cone'] = 'SynCone'
CLASS_IDS_MAP['syn_capsule'] = 'SynCapsule'
CLASS_IDS_MAP['syn_egg'] = 'SynEgg'
CLASS_IDS_MAP['syn_twist'] = 'SynTwist'
CLASS_IDS_MAP['syn_wave'] = 'SynWave'
SYNTHETIC_CLASSES = ('syn_ellipsoid', 'syn_box', 'syn_peanut')
# the 13-class synthetic benchmark mirroring the reference's 13 ShapeNet
# classes (reference train_reconstruction.py:254-268)
SYNTHETIC_CLASSES_13 = SYNTHETIC_CLASSES + (
    'syn_disk', 'syn_pear', 'syn_star', 'syn_bump', 'syn_dumbbell',
    'syn_cone', 'syn_capsule', 'syn_egg', 'syn_twist', 'syn_wave')


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--class_ids', type=str,
                        default=','.join(c for c in CLASS_IDS_MAP
                                         if not c.startswith('syn')))
    parser.add_argument('--image_size', type=int, default=64)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('-lr', '--learning_rate', type=float, default=1e-4)
    parser.add_argument('-ni', '--num_iterations', type=int, default=250000)
    parser.add_argument('--print_freq', type=int, default=1000)
    parser.add_argument('--eval_freq', type=int, default=10000)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--distribution', type=str, default='uniform')
    parser.add_argument('-sq', '--squared', action='store_true')
    parser.add_argument('--dist_scale', type=float, default=None)
    parser.add_argument('--dist_shape', type=float, default=0)
    parser.add_argument('--dist_shift', type=float, default=0)
    parser.add_argument('--dist_eps', type=float, default=300.)
    parser.add_argument('--t_conorm', type=str, default='probabilistic')
    parser.add_argument('--t_conorm_p', type=float, default=0)
    parser.add_argument('--lambda_laplacian', type=float, default=5e-3)
    parser.add_argument('--lambda_flatten', type=float, default=5e-4)
    parser.add_argument('--dataset-dir', type=str, default='./data-shapenet')
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--backend', type=str, default=None)
    parser.add_argument('--checkpoint-dir', type=str, default=None)
    parser.add_argument('--data-parallel', action='store_true',
                        help='shard the batch over all devices (dp mesh); '
                             'XLA inserts the gradient all-reduce')
    parser.add_argument('--quick', action='store_true')
    parser.add_argument('--host-data', action='store_true',
                        help='keep training images on the host and upload '
                        'each batch (default: images live on device as '
                        'uint8 and batches are gathered by index — the '
                        'per-step transfer drops from ~8 MB to ~1 KB)')
    parser.add_argument('--chain', type=int, default=1,
                        help='train steps chained on-device per dispatch '
                        '(staged batches + lax.scan; amortizes the host '
                        'round trip per step)')
    parser.add_argument('--decay-at', type=int, default=150000,
                        help='iteration at which lr and dist_scale decay '
                             'x0.3 (reference: 150k of 250k, '
                             'train_reconstruction.py:70-84); lower it to '
                             'exercise the decay logic in shorter runs')
    parser.add_argument('--max-eval-batches', type=int, default=0,
                        help='cap eval batches per class (0 = no cap); '
                        '--quick sets 2 unless given explicitly')
    args = parser.parse_args()
    use_compile_cache()

    # the encoder's convs/denses would otherwise run in TF32 on a GPU;
    # train in f32 like the reference (torch fp32)
    jax.config.update('jax_default_matmul_precision', 'float32')

    if args.dist_scale is None:
        args.dist_scale = default_dist_scale(
            args.distribution, args.squared, args.t_conorm, args.t_conorm_p)
        print(f'Using default dist_scale {args.dist_scale} for '
              f'{args.distribution} x {args.t_conorm}.')
    print(vars(args))


    if args.quick:
        args.num_iterations = min(args.num_iterations, 20)
        args.batch_size = min(args.batch_size, 8)
        args.print_freq = 5
        args.eval_freq = args.num_iterations  # eval exactly once, at the end
        args.max_eval_batches = args.max_eval_batches or 2

    # ---- data
    if args.synthetic:
        n_obj = 4 if args.quick else 64
        ids = args.class_ids.split(',')
        syn_ids = [c for c in ids if c.startswith('syn')] or ['synthetic']
        dataset_train = SyntheticShapeNet(n_obj, args.image_size,
                                          args.seed, class_ids=syn_ids)
        dataset_val = dataset_train
    else:
        class_ids = args.class_ids.split(',')
        dataset_train = ShapeNet(args.dataset_dir, class_ids, 'train')
        dataset_val = ShapeNet(args.dataset_dir, class_ids, 'val')

    # ---- model
    v, f = data.sphere(642)
    nv, nf = v.shape[0], f.shape[0]
    vertices_base = jnp.asarray(v)
    faces_t = jnp.asarray(f)
    encoder = Encoder()
    decoder = Decoder(nv=nv)
    laplacian = gendr_jax.LaplacianLoss(v, f)
    flatten = gendr_jax.FlattenLoss(f)
    lighting = gendr_jax.Lighting()
    transform = gendr_jax.LookAt(viewing_angle=15)
    renderer = gendr_jax.GenDR(
        image_size=args.image_size, dist_func=args.distribution,
        dist_scale=1.0, dist_squared=args.squared,
        dist_shape=args.dist_shape, dist_shift=args.dist_shift,
        dist_eps=args.dist_eps, aggr_alpha_func=args.t_conorm,
        aggr_alpha_t_conorm_p=args.t_conorm_p, aggr_rgb_func='hard',
        backend=args.backend, channels='alpha')

    key_enc, key_dec = jax.random.split(jax.random.PRNGKey(args.seed))
    enc_params, batch_stats = encoder.init(key_enc, 4, args.image_size)
    params = dict(enc=enc_params, dec=decoder.init(key_dec,
                                                   encoder.dim_out))

    opt = optax.adam(args.learning_rate)
    opt_state = opt.init(params)

    def reconstruct(params, batch_stats, images, train):
        feats, new_stats = encoder.apply(params['enc'], batch_stats, images,
                                         train)
        vertices = decoder.apply(params['dec'], feats, vertices_base)
        return vertices, new_stats

    def render_silhouettes(vertices, eyes, dist_scale):
        B = vertices.shape[0]
        faces = jnp.tile(faces_t[None], (B, 1, 1))
        mesh = gendr_jax.Mesh.create(vertices, faces)
        mesh = lighting(mesh)
        transform.set_eyes(eyes)
        mesh = transform(mesh)
        renderer.dist_scale = dist_scale
        return renderer(mesh)[:, 3]

    def loss_fn(params, batch_stats, images_a, images_b, eyes_a, eyes_b,
                dist_scale):
        """2-view cross-consistency loss (train_reconstruction.py:211-231,
        41-46): render [Raa, Rba, Rab, Rbb] and compare to the two target
        views."""
        images = jnp.concatenate([images_a, images_b], 0)
        vertices, new_stats = reconstruct(params, batch_stats, images, True)
        lap = jnp.mean(laplacian(vertices))
        flat = jnp.mean(flatten(vertices))
        vertices2 = jnp.concatenate([vertices, vertices], 0)
        eyes = jnp.concatenate([eyes_a, eyes_a, eyes_b, eyes_b], 0)
        sils = render_silhouettes(vertices2, eyes, dist_scale)
        B = images_a.shape[0]
        raa, rba, rab, rbb = (sils[:B], sils[B:2 * B], sils[2 * B:3 * B],
                              sils[3 * B:])
        ta = images_a[:, 3]
        tb = images_b[:, 3]
        sil_loss = (iou_loss(raa, ta) + iou_loss(rba, ta)
                    + iou_loss(rab, tb) + iou_loss(rbb, tb)) / 4
        loss = sil_loss + args.lambda_laplacian * lap \
            + args.lambda_flatten * flat
        return loss, new_stats

    # device-resident dataset: images stay on device as uint8; train steps
    # receive int32 ids and gather + normalize on device
    dev_images = None
    if not args.host_data:
        gb = dataset_train.images.nbytes / 1e9
        if gb <= 8.0:
            dev_images = jax.device_put(jnp.asarray(dataset_train.images))
            print(f'device-resident dataset: {gb:.2f} GB uint8')
        else:
            print(f'dataset {gb:.2f} GB > 8 GB; streaming batches from '
                  f'host (use --host-data to silence)')

    def train_step_body(dev_imgs, params, batch_stats, opt_state, images_a,
                        images_b, eyes_a, eyes_b, dist_scale, lr_scale):
        # dev_imgs is threaded as a jit ARGUMENT, never a closure constant:
        # a captured multi-hundred-MB array would be embedded in the
        # compiled program as a constant
        if dev_imgs is not None:
            # images_a/b are int32 ids into the device-resident array
            images_a = dev_imgs[images_a].astype(jnp.float32) / 255.
            images_b = dev_imgs[images_b].astype(jnp.float32) / 255.
        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, batch_stats, images_a, images_b,
                                   eyes_a, eyes_b, dist_scale)
        updates, opt_state = opt.update(grads, opt_state)
        updates = jax.tree_util.tree_map(lambda u: u * lr_scale, updates)
        params = optax.apply_updates(params, updates)
        return params, new_stats, opt_state, loss

    train_step = jax.jit(train_step_body)

    @jax.jit
    def train_block(dev_imgs, params, batch_stats, opt_state, ia, ib, ea,
                    eb, dist_scale, lr_scale):
        """n staged batches trained in one dispatch via lax.scan: one host
        round trip for n steps."""
        def one(carry, xs):
            p, bs, os_ = carry
            a, b, ea_, eb_ = xs
            p, bs, os_, loss = train_step_body(dev_imgs, p, bs, os_, a, b,
                                               ea_, eb_, dist_scale,
                                               lr_scale)
            return (p, bs, os_), loss
        (params, batch_stats, opt_state), losses = jax.lax.scan(
            one, (params, batch_stats, opt_state), (ia, ib, ea, eb))
        return params, batch_stats, opt_state, losses

    @jax.jit
    def predict_voxels(params, batch_stats, images):
        """evaluate_iou voxel pipeline (train_reconstruction.py:233-241),
        fully on device."""
        vertices, _ = reconstruct(params, batch_stats, images, False)
        B = vertices.shape[0]
        faces = jnp.tile(faces_t[None], (B, 1, 1))
        fv = core.face_vertices(vertices, faces)
        fv = fv * 1.0 * (32. - 1) / 32. + 0.5
        vox = voxelize.voxelization(fv, 32, False)
        return jnp.transpose(vox, (0, 2, 1, 3))[:, :, :, ::-1]

    def evaluate(dataset, label):
        iou_all = []
        for class_id, class_name in dataset.class_ids_pair:
            total, count = 0.0, 0
            for bi, (im, vx) in enumerate(
                    dataset.get_all_batches_for_evaluation(
                        args.batch_size, class_id)):
                if args.max_eval_batches and bi >= args.max_eval_batches:
                    break
                pad = args.batch_size - im.shape[0]
                imp = np.pad(im, ((0, pad), (0, 0), (0, 0), (0, 0)))
                pred = np.asarray(predict_voxels(
                    params, batch_stats, jnp.asarray(imp)))
                pred = pred[:im.shape[0]]
                inter = (vx * pred).sum((1, 2, 3))
                union = ((vx + pred) > 0).sum((1, 2, 3))
                total += (inter / np.maximum(union, 1)).sum()
                count += im.shape[0]
            iou_cls = total / count * 100
            iou_all.append(iou_cls)
            print(f'Mean {label} IoU: {iou_cls:.3f} for class {class_name}')
        mean_iou = sum(iou_all) / len(iou_all)
        print(f'Mean {label} IoU: {mean_iou:.3f} for all classes')
        return mean_iou

    # the batch stream RNG is part of the training state: a resumed run
    # must draw the same batches it would have drawn uninterrupted
    np_rng = np.random.RandomState(args.seed)

    def _rng_state_dict():
        name, keys, pos, has_gauss, gauss = np_rng.get_state()
        assert name == 'MT19937', name
        # 0-d ndarrays: orbax StandardSave rejects bare numpy scalars
        return dict(keys=np.asarray(keys, np.uint32),
                    pos=np.asarray(pos, np.int64),
                    has_gauss=np.asarray(has_gauss, np.int64),
                    gauss=np.asarray(gauss, np.float64))

    def _train_state():
        return dict(params=params, batch_stats=batch_stats,
                    opt_state=opt_state, rng_state=_rng_state_dict())

    ckpt_mgr = None
    start_iter = 1
    if args.checkpoint_dir:
        import orbax.checkpoint as ocp
        ckpt_mgr = ocp.CheckpointManager(
            os.path.abspath(args.checkpoint_dir),
            options=ocp.CheckpointManagerOptions(max_to_keep=3))
        latest = ckpt_mgr.latest_step()
        if latest is not None:
            restored = ckpt_mgr.restore(
                latest, args=ocp.args.StandardRestore(_train_state()))
            params = restored['params']
            batch_stats = restored['batch_stats']
            # Adam moments resume exactly; without this a restart silently
            # resets optimizer dynamics (ADVICE.md r1, medium)
            opt_state = restored['opt_state']
            rs = restored['rng_state']
            np_rng.set_state((
                'MT19937', np.asarray(rs['keys'], np.uint32),
                int(rs['pos']), int(rs['has_gauss']), float(rs['gauss'])))
            start_iter = latest + 1
            print(f'Restored checkpoint at iteration {latest}; '
                  f'resuming from {start_iter}.')

    shard = None
    if args.data_parallel and len(jax.devices()) > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from gendr_jax.parallel.sharding import make_mesh
        mesh = make_mesh({'dp': len(jax.devices())})
        dp_sharding = NamedSharding(mesh, P('dp'))
        repl = NamedSharding(mesh, P())
        params = jax.device_put(params, repl)
        batch_stats = jax.device_put(batch_stats, repl)
        opt_state = jax.device_put(opt_state, repl)
        if dev_images is not None:
            dev_images = jax.device_put(dev_images, repl)

        def shard(x):
            return jax.device_put(jnp.asarray(x), dp_sharding)
        print(f'data-parallel over {len(jax.devices())} devices')

    losses = []
    t0 = time.time()
    chain = max(1, args.chain)
    put = shard if shard is not None else jnp.asarray
    if shard is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        stacked_sharding = NamedSharding(mesh, P(None, 'dp'))

        def put_stacked(x):
            return jax.device_put(jnp.asarray(x), stacked_sharding)
    else:
        put_stacked = jnp.asarray

    i = start_iter
    decay_at = args.decay_at
    while i <= args.num_iterations:
        # lr and dist_scale decay at the boundary (reference: 150k,
        # train_reconstruction.py:70-84)
        lr_scale = 0.3 if i >= decay_at else 1.0
        dist_scale = args.dist_scale * (0.3 if i >= decay_at else 1.0)

        # block length: don't straddle the decay boundary or a print/eval
        # boundary (lr/tau are per-dispatch scalars; prints/evals fire at
        # exact iteration multiples)
        n = min(chain, args.num_iterations - i + 1)
        if i < decay_at < i + n:
            n = decay_at - i
        nxt_print = ((i - 1) // args.print_freq + 1) * args.print_freq
        nxt_eval = ((i - 1) // args.eval_freq + 1) * args.eval_freq
        n = max(1, min(n, nxt_print - i + 1, nxt_eval - i + 1))

        get_batch = (dataset_train.get_random_batch_ids
                     if dev_images is not None
                     else dataset_train.get_random_batch)
        batches = [get_batch(np_rng, args.batch_size) for _ in range(n)]
        if n == 1:
            ia, ib, ea, eb = batches[0]
            params, batch_stats, opt_state, loss = train_step(
                dev_images, params, batch_stats, opt_state, put(ia),
                put(ib), put(ea), put(eb), jnp.float32(dist_scale),
                jnp.float32(lr_scale))
            # keep the loss on device: a float() here would block the host
            # on every step and serialize dispatch with the device; fetched
            # lazily at print time
            losses.append(loss)
        else:
            stk = [put_stacked(np.stack([b[k] for b in batches]))
                   for k in range(4)]
            params, batch_stats, opt_state, lvec = train_block(
                dev_images, params, batch_stats, opt_state, *stk,
                jnp.float32(dist_scale), jnp.float32(lr_scale))
            losses.extend([lvec[j] for j in range(n)])
        i_last = i + n - 1

        if i_last % args.print_freq == 0:
            dt = time.time() - t0
            recent = [float(l) for l in losses[-args.print_freq:]]
            print(f'Iter: [{i_last}/{args.num_iterations}]\t'
                  f'Loss {np.mean(recent):.4f}\t'
                  f'lr {args.learning_rate * lr_scale:.6f}\t'
                  f'sv {dist_scale:.6f}\t'
                  f'({(i_last - start_iter + 1) / dt:.2f} it/s)')

        if i_last % args.eval_freq == 0:
            evaluate(dataset_val, 'Valid')
            if ckpt_mgr is not None:
                import orbax.checkpoint as ocp
                ckpt_mgr.save(i_last,
                              args=ocp.args.StandardSave(_train_state()))
                ckpt_mgr.wait_until_finished()
        i += n

    mean_iou = evaluate(dataset_val, 'Final')
    # a restored run past num_iterations trains zero steps; report NaN
    # explicitly instead of np.mean([])'s RuntimeWarning
    final_loss = (float(np.mean([float(l) for l in losses[-10:]]))
                  if losses else float('nan'))
    return mean_iou, final_loss


if __name__ == '__main__':
    main()
