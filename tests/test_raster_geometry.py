"""Geometry-core validation: faces_info and the branchless signed distance
against independent brute-force oracles."""

import numpy as np
import jax.numpy as jnp

from gendr_jax.raster import prep
from gendr_jax.raster import geometry as G


def brute_force_closest(tri, p, n=4001):
    """Densely sample the triangle edges + check interior projection."""
    best = (np.inf, None)
    ts = np.linspace(0, 1, n)
    for k in range(3):
        a, b = tri[k], tri[(k + 1) % 3]
        pts = a[None] * (1 - ts[:, None]) + b[None] * ts[:, None]
        d = np.sum((pts - p[None]) ** 2, -1)
        i = np.argmin(d)
        if d[i] < best[0]:
            best = (d[i], pts[i])
    return best


def barycentric_np(tri, p):
    T = np.array([[tri[0][0] - tri[2][0], tri[1][0] - tri[2][0]],
                  [tri[0][1] - tri[2][1], tri[1][1] - tri[2][1]]])
    w01 = np.linalg.solve(T, p - tri[2])
    return np.array([w01[0], w01[1], 1 - w01[0] - w01[1]])


def make_inputs(tri, p):
    fv = np.zeros((1, 1, 9), np.float32)
    fv[0, 0, 0::3] = tri[:, 0]
    fv[0, 0, 1::3] = tri[:, 1]
    fv[0, 0, 2::3] = 1.0
    info = np.asarray(prep.faces_info(jnp.asarray(fv)))[0, 0]
    xy = tuple(jnp.float32(v) for v in
               (tri[0][0], tri[0][1], tri[1][0], tri[1][1],
                tri[2][0], tri[2][1]))
    inv = tuple(jnp.float32(info[i]) for i in range(9))
    sym = tuple(jnp.float32(info[9 + i]) for i in range(9))
    obt = tuple(jnp.float32(info[18 + i]) for i in range(3))
    return xy, inv, sym, obt


def test_faces_info_inverse():
    rng = np.random.RandomState(0)
    for _ in range(20):
        tri = rng.randn(3, 2).astype(np.float32)
        xy, inv, sym, obt = make_inputs(tri, None)
        # inv maps vertex k to the k-th unit barycentric
        for k in range(3):
            w = G.barycentric(inv, jnp.float32(tri[k][0]),
                              jnp.float32(tri[k][1]))
            expect = np.eye(3)[k]
            np.testing.assert_allclose(np.array(w), expect, atol=2e-4)


def test_signed_distance_brute_force():
    rng = np.random.RandomState(1)
    n_cases = 0
    for trial in range(30):
        tri = rng.randn(3, 2).astype(np.float32)
        area = 0.5 * abs(np.cross(tri[1] - tri[0], tri[2] - tri[0]))
        if area < 0.05:
            continue
        xy, inv, sym, obt = make_inputs(tri, None)
        for _ in range(20):
            p = rng.randn(2).astype(np.float32) * 1.5
            w_np = barycentric_np(tri.astype(np.float64),
                                  p.astype(np.float64))
            w = G.barycentric(inv, jnp.float32(p[0]), jnp.float32(p[1]))
            np.testing.assert_allclose(np.array(w), w_np, atol=1e-3)

            sign, dx, dy, tw = G.signed_distance(
                w, xy, sym, obt, jnp.float32(p[0]), jnp.float32(p[1]))
            dis2 = float(dx) ** 2 + float(dy) ** 2
            d_bf, q_bf = brute_force_closest(tri.astype(np.float64),
                                             p.astype(np.float64))
            inside = np.all(w_np > 0) and np.all(w_np < 1)
            assert float(sign) == (1.0 if inside else -1.0)
            np.testing.assert_allclose(dis2, d_bf, atol=5e-4, rtol=2e-2)
            # closest point from tw must reproduce the displacement
            q = (float(tw[0]) * tri[0] + float(tw[1]) * tri[1]
                 + float(tw[2]) * tri[2])
            np.testing.assert_allclose(q - p, [float(dx), float(dy)],
                                       atol=2e-3)
            n_cases += 1
    assert n_cases > 300
