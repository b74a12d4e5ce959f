"""Transforms, lighting, normals, and mesh-regularization loss tests."""

import math

import numpy as np
import jax.numpy as jnp

from gendr_jax import data
from gendr_jax.geometry import core, lighting, losses, transforms as T
from gendr_jax.geometry.mesh import Mesh


class TestTransforms:
    def test_look_at_basis(self):
        v = jnp.asarray(np.random.RandomState(0).randn(2, 5, 3), jnp.float32)
        out = T.look_at(v, eye=[0, 0, -3])
        # camera on -z looking at origin: z increases away from eye
        np.testing.assert_allclose(np.asarray(out[..., 2]),
                                   np.asarray(v[..., 2]) + 3, atol=1e-5)

    def test_look_at_distance_preserved(self):
        rng = np.random.RandomState(1)
        v = jnp.asarray(rng.randn(1, 10, 3), jnp.float32)
        eye = [1.5, 2.0, -2.0]
        out = np.asarray(T.look_at(v, eye))
        d_in = np.linalg.norm(np.asarray(v)[0] - np.array(eye), axis=-1)
        d_out = np.linalg.norm(out[0], axis=-1)
        np.testing.assert_allclose(d_in, d_out, rtol=1e-5)

    def test_get_points_from_angles(self):
        p = np.asarray(T.get_points_from_angles(2.0, 0.0, 0.0))
        np.testing.assert_allclose(p, [0, 0, -2], atol=1e-6)
        p = np.asarray(T.get_points_from_angles(1.0, 90.0, 0.0))
        np.testing.assert_allclose(p, [0, 1, 0], atol=1e-6)
        # batched
        p = np.asarray(T.get_points_from_angles(
            jnp.asarray([2.0, 1.0]), jnp.asarray([0.0, 90.0]),
            jnp.asarray([0.0, 0.0])))
        assert p.shape == (2, 3)

    def test_perspective(self):
        v = jnp.asarray([[[1.0, 2.0, 4.0]]])
        out = np.asarray(T.perspective(v, angle=45.0))
        np.testing.assert_allclose(out[0, 0],
                                   [1 / 4, 2 / 4, 4.0], atol=1e-5)

    def test_perspective_batched_angles(self):
        v = jnp.ones((3, 2, 3))
        out = T.perspective(v, angle=jnp.asarray([30.0, 45.0, 60.0]))
        assert out.shape == (3, 2, 3)

    def test_projection_matrix(self):
        P = np.zeros((1, 3, 4), np.float32)
        P[0, 0, 0] = P[0, 1, 1] = P[0, 2, 2] = 1.0
        v = jnp.asarray([[[100.0, 200.0, 1.0]]])
        out = np.asarray(T.projection(v, P, orig_size=512))
        # x' = 100, y' = 200 -> NDC
        np.testing.assert_allclose(
            out[0, 0, :2],
            [2 * (100 - 256) / 512, 2 * (200 - 256) / 512], atol=1e-3)

    def test_look_at_closure_constant_matches_arg(self):
        """jit with closure-captured eyes must equal jit with eyes as an
        argument: the constant-folded rotation-basis subgraph must agree
        with the runtime one (a remote accelerator backend once returned it
        corrupted)."""
        import jax
        rng = np.random.RandomState(3)
        v = jnp.asarray(rng.randn(4, 50, 3) * 0.3, jnp.float32)
        eyes = jnp.asarray(rng.randn(4, 3) + np.array([0, 0, -3.0]),
                           jnp.float32)
        ref = jax.jit(lambda a, e: T.perspective(T.look_at(a, e), 15.0))(
            v, eyes)
        got = jax.jit(lambda a: T.perspective(T.look_at(a, eyes), 15.0))(v)
        np.testing.assert_allclose(np.asarray(ref), np.asarray(got),
                                   atol=1e-5)
        # gradients flow through the basis
        g = jax.grad(lambda e: float(0) + jnp.sum(
            T.look_at(v, e) ** 2))(eyes)
        assert np.isfinite(np.asarray(g)).all()

    def test_lookat_class_roundtrip(self):
        v, f = data.icosphere(1)
        mesh = Mesh.create(v, f)
        t = T.LookAt(viewing_angle=30)
        t.set_eyes_from_angles(2.732, 30.0, 45.0)
        out = t(mesh)
        assert out.vertices.shape == mesh.vertices.shape
        assert np.isfinite(np.asarray(out.vertices)).all()


class TestLighting:
    def test_ambient(self):
        light = jnp.zeros((1, 4, 3))
        out = np.asarray(lighting.ambient_lighting(light, 0.5, (1, 0.5, 0)))
        np.testing.assert_allclose(out[0, 0], [0.5, 0.25, 0.0])

    def test_directional_lambert(self):
        light = jnp.zeros((1, 2, 3))
        normals = jnp.asarray([[[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]]])
        out = np.asarray(lighting.directional_lighting(
            light, normals, 1.0, (1, 1, 1), (0, 1, 0)))
        np.testing.assert_allclose(out[0, 0], [1, 1, 1], atol=1e-6)
        np.testing.assert_allclose(out[0, 1], [0, 0, 0], atol=1e-6)  # relu

    def test_lighting_pipeline(self):
        v, f = data.icosphere(1)
        mesh = Mesh.create(v, f)
        lit = lighting.Lighting()(mesh)
        tex = np.asarray(lit.textures)
        assert tex.min() >= 0.5 - 1e-6  # ambient floor
        assert tex.max() <= 1.0 + 1e-6  # 0.5 ambient + 0.5 directional


class TestNormals:
    def test_sphere_vertex_normals_radial(self):
        v, f = data.icosphere(2)
        n = np.asarray(core.vertex_normals(jnp.asarray(v)[None],
                                           jnp.asarray(f)[None]))[0]
        cos = np.sum(n * v / np.linalg.norm(v, axis=-1, keepdims=True), -1)
        assert cos.min() > 0.99

    def test_surface_normals_unit(self):
        v, f = data.icosphere(1)
        n = np.asarray(core.surface_normals(jnp.asarray(v)[None],
                                            jnp.asarray(f)[None]))[0]
        np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0,
                                   atol=1e-5)


class TestLosses:
    def test_laplacian_zero_for_centroid_mesh(self):
        # vertices at the mean of their neighbors -> zero loss: a regular
        # polygon ring
        n = 8
        ang = np.arange(n) * 2 * np.pi / n
        # use the sphere: laplacian of a sphere is small but nonzero;
        # scaling the mesh scales the loss quadratically
        v, f = data.icosphere(2)
        lap = losses.LaplacianLoss(v, f)
        l1 = float(lap(jnp.asarray(v)[None])[0])
        l2 = float(lap(jnp.asarray(v)[None] * 2.0)[0])
        np.testing.assert_allclose(l2, 4 * l1, rtol=1e-4)
        assert l1 > 0

    def test_laplacian_matches_dense_reference(self):
        # dense-matrix construction equivalent to losses.py:17-42
        v, f = data.icosphere(1)
        nv = v.shape[0]
        L = np.zeros((nv, nv), np.float32)
        for (a, b, c) in f:
            for (i, j) in ((a, b), (b, c), (a, c)):
                L[i, j] = -1
                L[j, i] = -1
        deg = -L.sum(1)
        L[np.arange(nv), np.arange(nv)] = deg
        L = L / deg[:, None]
        x = np.random.RandomState(0).randn(nv, 3).astype(np.float32)
        want = ((L @ x) ** 2).sum()
        got = float(losses.LaplacianLoss(v, f)(jnp.asarray(x)[None])[0])
        np.testing.assert_allclose(got, want, rtol=1e-4)

    def test_flatten_zero_for_plane_positive_for_sphere(self):
        v, f = data.icosphere(2)
        fl = losses.FlattenLoss(f)
        val = float(fl(jnp.asarray(v)[None])[0])
        assert val > 0
        # flattening the sphere to a pancake increases dihedral penalty
        v2 = v.copy()
        v2[:, 1] *= 0.1
        val2 = float(fl(jnp.asarray(v2)[None])[0])
        assert np.isfinite(val2)

    def test_flatten_scale_invariant(self):
        v, f = data.icosphere(1)
        fl = losses.FlattenLoss(f)
        l1 = float(fl(jnp.asarray(v)[None])[0])
        l2 = float(fl(jnp.asarray(v)[None] * 3.0)[0])
        np.testing.assert_allclose(l1, l2, rtol=1e-3)


class TestLookAndProjectionClasses:
    def test_look_function_defaults(self):
        # reference's look() crashes when up is omitted (look.py:38 quirk);
        # ours defaults up=(0,1,0)
        v = jnp.asarray(np.random.RandomState(3).randn(1, 6, 3), jnp.float32)
        out = T.look(v, eye=[0, 0, -2], direction=[0, 0, 1])
        assert np.isfinite(np.asarray(out)).all()
        # looking along +z from z=-2: z coords shift by +2
        np.testing.assert_allclose(np.asarray(out[..., 2]),
                                   np.asarray(v[..., 2]) + 2, atol=1e-5)

    def test_look_class(self):
        from gendr_jax import data as D2
        v, f = D2.icosphere(1)
        mesh = Mesh.create(v, f)
        t = T.Look(camera_direction=[0, 0, 1], eye=[0, 0, -3])
        out = t(mesh)
        assert np.isfinite(np.asarray(out.vertices)).all()

    def test_projection_class(self):
        P = np.zeros((1, 3, 4), np.float32)
        P[0, 0, 0] = P[0, 1, 1] = P[0, 2, 2] = 1.0
        from gendr_jax import data as D2
        v, f = D2.icosphere(1)
        mesh = Mesh.create(v * 100 + np.array([256, 256, 3]), f)
        t = T.Projection(P, orig_size=512)
        out = t(mesh)
        o = np.asarray(out.vertices)
        assert np.isfinite(o).all()
        assert np.abs(o[..., :2]).max() < 2.0  # roughly NDC

    def test_projection_invalid_matrix(self):
        with np.testing.assert_raises(ValueError):
            T.Projection(np.zeros((3, 4), np.float32))
