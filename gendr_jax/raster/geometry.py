"""Per-(pixel, face) rasterization math, branchless.

This module is the array re-design of the reference's per-thread geometry
helpers (generalized_renderer_cuda_kernel.cu:38-165).  The CUDA code walks an
if/else region decision tree per (pixel, face) pair; array code gains
nothing from branching, so everything here is evaluated for all three edge
candidates and selected with masks — preserving exactly which closest point
wins (the gradient direction depends on it via ``t + w0``, cu:1044-1052).

All functions take/return *tuples of component arrays* (not stacked tensors)
so the same code runs on any broadcastable shapes.
"""

from __future__ import annotations

import jax.numpy as jnp


def barycentric(inv, xp, yp):
    """w_k = inv[k,0]*x + inv[k,1]*y + inv[k,2]  (cu:38-43).

    inv: 9-tuple of arrays (row-major 3x3); returns (w0, w1, w2).
    """
    w0 = inv[0] * xp + inv[1] * yp + inv[2]
    w1 = inv[3] * xp + inv[4] * yp + inv[5]
    w2 = inv[6] * xp + inv[7] * yp + inv[8]
    return w0, w1, w2


def inside_strict(w):
    """Strict interior test used by the distance function (cu:83-84)."""
    w0, w1, w2 = w
    return ((w0 > 0) & (w1 > 0) & (w2 > 0)
            & (w0 < 1) & (w1 < 1) & (w2 < 1))


def inside_loose(w):
    """check_pixel_inside (cu:61-64): non-strict [0, 1] bounds."""
    w0, w1, w2 = w
    return ((w0 >= 0) & (w0 <= 1) & (w1 >= 0) & (w1 <= 1)
            & (w2 >= 0) & (w2 <= 1))


def face_frontside(xy):
    """check_face_frontside (cu:55-58). xy = (x0,y0,x1,y1,x2,y2)."""
    x0, y0, x1, y1, x2, y2 = xy
    return (y2 - y0) * (x1 - x0) < (y1 - y0) * (x2 - x0)


def outside_bbox(xy, xp, yp, threshold):
    """check_border (cu:46-52): pixel further than ``threshold`` from the
    face's xy bounding box."""
    x0, y0, x1, y1, x2, y2 = xy
    xmax = jnp.maximum(jnp.maximum(x0, x1), x2)
    xmin = jnp.minimum(jnp.minimum(x0, x1), x2)
    ymax = jnp.maximum(jnp.maximum(y0, y1), y2)
    ymin = jnp.minimum(jnp.minimum(y0, y1), y2)
    return ((xp > xmax + threshold) | (xp < xmin - threshold)
            | (yp > ymax + threshold) | (yp < ymin - threshold))


def barycentric_clip(w, eps=1e-5):
    """Clamp to [0,1] and renormalize (cu:67-72)."""
    w0 = jnp.clip(w[0], 0.0, 1.0)
    w1 = jnp.clip(w[1], 0.0, 1.0)
    w2 = jnp.clip(w[2], 0.0, 1.0)
    s = jnp.maximum(w0 + w1 + w2, eps)
    return w0 / s, w1 / s, w2 / s


def _safe_div(num, den, tiny=1e-20):
    den = jnp.where(jnp.abs(den) < tiny,
                    jnp.where(den < 0, -tiny, tiny), den)
    return num / den


def _select3(idx, c0, c1, c2):
    return jnp.where(idx == 0, c0, jnp.where(idx == 1, c1, c2))


def signed_distance(w, xy, sym, obt, xp, yp):
    """Signed euclidean pixel-to-face distance + closest-point weights.

    Branchless port of ``euclidean_p2f_distance`` (cu:75-165).

    Args (all broadcast-compatible arrays):
      w:   (w0, w1, w2) unclipped barycentrics of the pixel.
      xy:  (x0, y0, x1, y1, x2, y2) face vertex screen coords.
      sym: 9-tuple, the Gram matrix F F^T + 1 row-major (cu:659-665).
      obt: (o0, o1, o2) obtuse-corner flags (cu:667-675).
      xp, yp: pixel coords.

    Returns:
      sign:  +1 strictly inside, -1 outside.
      dis_x, dis_y: displacement pixel -> closest point on the triangle.
      tw:    (tw0, tw1, tw2) closest-point barycentric weights = t + w0 of
             the reference backward (cu:1044-1052).
    """
    w0, w1, w2 = w
    x0, y0, x1, y1, x2, y2 = xy
    wk = (w0, w1, w2)
    xs = (x0, x1, x2)
    ys = (y0, y1, y2)

    # per-edge candidates k: edge between vertex k and k+1
    cand = []
    for k in range(3):
        v0, v1, v2 = k, (k + 1) % 3, (k + 2) % 3
        a0 = (sym[3 * v0 + 0] - sym[3 * v1 + 0],
              sym[3 * v0 + 1] - sym[3 * v1 + 1],
              sym[3 * v0 + 2] - sym[3 * v1 + 2])
        tv0 = _safe_div(w0 * a0[0] + w1 * a0[1] + w2 * a0[2] - a0[v1],
                        a0[v0] - a0[v1])
        # unclamped target (inside case, cu:99-105)
        tu = [None, None, None]
        tu[v0], tu[v1], tu[v2] = tv0, 1.0 - tv0, jnp.zeros_like(tv0)
        # The reference computes dis = sum_i (t_i - w_i) * p_i (cu:108-109,
        # 161-162).  Since sum_i w_i p_i == (xp, yp) whenever w is a true
        # barycentric, we use the equivalent dis = (closest point) - pixel,
        # which stays well-conditioned when w blows up on (near-)degenerate
        # projected faces (determinant clamp, cu:653) — there the reference
        # form suffers catastrophic cancellation and can emit dis = 0 for
        # pixels far from the face.
        dis_x_u = tu[0] * x0 + tu[1] * x1 + tu[2] * x2 - xp
        dis_y_u = tu[0] * y0 + tu[1] * y1 + tu[2] * y2 - yp
        dis2_u = dis_x_u * dis_x_u + dis_y_u * dis_y_u
        # clamped target (outside case, cu:150-158)
        tc = [None, None, None]
        tc[v0] = jnp.clip(tv0, 0.0, 1.0)
        tc[v1] = jnp.clip(1.0 - tv0, 0.0, 1.0)
        tc[v2] = jnp.zeros_like(tv0)
        dis_x_c = tc[0] * x0 + tc[1] * x1 + tc[2] * x2 - xp
        dis_y_c = tc[0] * y0 + tc[1] * y1 + tc[2] * y2 - yp
        cand.append(dict(tu=tu, dxu=dis_x_u, dyu=dis_y_u, d2u=dis2_u,
                         tc=tc, dxc=dis_x_c, dyc=dis_y_c))

    # ---- inside: argmin over the 3 unclamped edge distances, first-min wins
    d0, d1, d2 = cand[0]['d2u'], cand[1]['d2u'], cand[2]['d2u']
    sel0 = (d0 <= d1) & (d0 <= d2)
    sel1 = (~sel0) & (d1 <= d2)
    kin = jnp.where(sel0, 0, jnp.where(sel1, 1, 2))
    in_dx = _select3(kin, cand[0]['dxu'], cand[1]['dxu'], cand[2]['dxu'])
    in_dy = _select3(kin, cand[0]['dyu'], cand[1]['dyu'], cand[2]['dyu'])
    in_tw = tuple(
        _select3(kin, cand[0]['tu'][i], cand[1]['tu'][i], cand[2]['tu'][i])
        for i in range(3))

    # ---- outside: pick edge v0 by the region decision chain (cu:127-139)
    dotA = (xp - x0) * (x2 - x0) + (yp - y0) * (y2 - y0)
    dotB = (xp - x1) * (x0 - x1) + (yp - y1) * (y0 - y1)
    dotC = (xp - x2) * (x1 - x2) + (yp - y2) * (y1 - y2)
    c01 = (w1 <= 0) & (w2 <= 0)
    c12 = (w2 <= 0) & (w0 <= 0)
    c20 = (w0 <= 0) & (w1 <= 0)
    vA = jnp.where((obt[0] == 1) & (dotA > 0), 2, 0)  # vertex-0 region
    vB = jnp.where((obt[1] == 1) & (dotB > 0), 0, 1)  # vertex-1 region
    vC = jnp.where((obt[2] == 1) & (dotC > 0), 1, 2)  # vertex-2 region
    v0 = jnp.where(
        c01, vA,
        jnp.where(c12, vB,
                  jnp.where(c20, vC,
                            jnp.where(w0 <= 0, 1,
                                      jnp.where(w1 <= 0, 2, 0)))))
    out_dx = _select3(v0, cand[0]['dxc'], cand[1]['dxc'], cand[2]['dxc'])
    out_dy = _select3(v0, cand[0]['dyc'], cand[1]['dyc'], cand[2]['dyc'])
    out_tw = tuple(
        _select3(v0, cand[0]['tc'][i], cand[1]['tc'][i], cand[2]['tc'][i])
        for i in range(3))

    inside = inside_strict(w)
    sign = jnp.where(inside, 1.0, -1.0)
    dis_x = jnp.where(inside, in_dx, out_dx)
    dis_y = jnp.where(inside, in_dy, out_dy)
    # tw is t + w0 of the reference backward == the raw (un-shifted) closest-
    # point target weights tu/tc.
    tw = tuple(jnp.where(inside, in_tw[i], out_tw[i]) for i in range(3))
    return sign, dis_x, dis_y, tw


def perspective_depth(w_clip, z):
    """zp = 1 / sum_k(w_clip_k / z_k)  (cu:807-809)."""
    return 1.0 / (w_clip[0] / z[0] + w_clip[1] / z[1] + w_clip[2] / z[2])


def surface_texel_index(w_clip, R: int):
    """Texel index into the R x R folded-triangle texture grid
    (forward_sample_texture, cu:178-185).  Result clamped to [0, R^2-1]
    (the reference reads out of bounds when w hits an exact corner)."""
    w_x = jnp.floor(w_clip[0] * R).astype(jnp.int32)
    w_y = jnp.floor(w_clip[1] * R).astype(jnp.int32)
    lower = (w_clip[0] + w_clip[1]) * R - w_x.astype(jnp.float32) \
        - w_y.astype(jnp.float32) <= 1.0
    idx = jnp.where(lower, w_y * R + w_x,
                    (R - 1 - w_y) * R + (R - 1 - w_x))
    return jnp.clip(idx, 0, R * R - 1)
