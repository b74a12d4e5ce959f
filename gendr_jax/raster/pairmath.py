"""Shared per-(pixel, face) pair math for BOTH rasterizer backends.

One implementation of the coverage chain — barycentrics, packed-constant
signed distance (pack.py identities), CDF, culls — evaluated by the GPU
kernels on one face against a tile of pixels and by the streaming XLA
backend on [B, P, CF] broadcast blocks.  Sharing the exact f32 operation
sequence leaves the two backends differing only by compiler rounding (FMA
contraction, transcendental implementations), which keeps boundary flips
at discontinuous-pdf CDF support edges (uniform &c., cu:366-459) and
exact-equality winner swaps in the max t-conorm backward (cu:574-575)
rare.  The independent semantic witness
is the dense region-tree oracle (raster/oracle.py + geometry.signed_distance),
which keeps the reference decision-chain algebra (cu:75-165).

All inputs arrive through a ``row(i)`` accessor over the packed per-face
constant rows (see pack.py for the layout) plus broadcastable pixel coords,
so the code is shape-agnostic.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from gendr_jax import config as C
from gendr_jax.ops import distributions as D
from gendr_jax.raster import pack

# parameter-vector slots (scalar loads in the kernels); P_ROW0 is the
# global image row of the rendered band's first row (0 for a full render —
# the pixel-sharded path renders one band per device, NDC coords staying
# global)
(P_SCALE, P_SHAPE, P_SHIFT, P_THR, P_TCP, P_EPS, P_GAMMA, P_NEAR, P_FAR,
 P_GINV1, P_GINV, P_BG0, P_BG1, P_BG2, P_ROW0, P_MARGIN) = range(16)
NPAR = 16


def _params_vec(params: Dict, row0=0, cfg=None):
    # P_MARGIN: per-pair bbox-gate radius.  Pixels farther than this from a
    # face's (well-conditioned, vertex-derived) bbox have true coverage
    # <= PROBABILITY_THRESHOLD, so the reference drops them (cu:784); the
    # gate drops them WITHOUT evaluating the barycentric algebra, whose
    # fp32 blow-up on near-degenerate sliver faces otherwise reports
    # phantom "inside" (coverage up to ~1) along thin bands far from the
    # mesh (diagnosed at 512^2 x 20480 faces).  With cfg the radius is the
    # per-distribution probability radius (pack.cull_margin — the same
    # value the tile x chunk cull uses); without it, the reference's own
    # looser bbox-exit bound sqrt(dist_eps * tau) (cu:747).
    if cfg is not None:
        margin = pack.cull_margin(cfg, params)
    else:
        margin = jnp.sqrt(jnp.asarray(
            params['dist_eps'] * params['dist_scale'], jnp.float32))
    bg = jnp.asarray(params['background_color'], jnp.float32).reshape(3)
    vec = jnp.stack([
        jnp.asarray(params['dist_scale'], jnp.float32),
        jnp.asarray(params['dist_shape'], jnp.float32),
        jnp.asarray(params['dist_shift'], jnp.float32),
        jnp.asarray(params['dist_eps'] * params['dist_scale'], jnp.float32),
        jnp.asarray(params['aggr_alpha_t_conorm_p'], jnp.float32),
        jnp.asarray(params['aggr_rgb_eps'], jnp.float32),
        jnp.asarray(params['aggr_rgb_gamma'], jnp.float32),
        jnp.asarray(params['near'], jnp.float32),
        jnp.asarray(params['far'], jnp.float32),
        # gamma normalizers precomputed outside (no lgamma in the kernels)
        jnp.exp(-jax.lax.lgamma(
            jnp.asarray(params['dist_shape'], jnp.float32) + 1.0)),
        jnp.exp(-jax.lax.lgamma(jnp.maximum(
            jnp.asarray(params['dist_shape'], jnp.float32), 1e-6))),
        bg[0], bg[1], bg[2],
        jnp.asarray(row0, jnp.float32),
        jnp.asarray(margin, jnp.float32),
    ])
    # Runtime-opaque on purpose: the kernels read this vector as runtime
    # scalars, but without the barrier the XLA backend would see trace-time
    # CONSTANTS, and XLA may rewrite division by a constant into a
    # differently rounded multiply.  That skew flips max-t-conorm
    # exact-equality winners (cu:574-575) and is amplified to O(1) gradient
    # error by the frank backward's 1e-6 saturation guard.  The barrier
    # keeps true runtime divides in both backends.
    return jax.lax.optimization_barrier(vec)


def _dis_from_dis2(dis2, cfg):
    """(dis, rdis) from the squared distance.

    Non-squared dists need |dis| for the CDF and the backward needs
    1/|dis| to normalize the distance direction (cu:1046-1050) — one
    rsqrt serves both (dis = dis2 * rsqrt(dis2)), replacing a sqrt AND a
    per-pair divide with one slow op + two multiplies.  The 1e-30 floor
    keeps the forward dis exact down to 1e-15; the RETURNED rdis (used
    only by the backward direction normalization) is clamped to 1e6,
    matching the reference's max(|dis|, 1e-6) floor (cu:1050) so pairs
    with 0 < dis < 1e-6 get reference-scale gradients."""
    if cfg.dist_squared:
        return dis2, None
    rdis = jax.lax.rsqrt(jnp.maximum(dis2, 1e-30))
    return dis2 * rdis, jnp.minimum(rdis, 1e6)


def sel3(idx, c):
    """Pick c[idx] per element for a 3-tuple of candidate arrays."""
    return jnp.where(idx == 0, c[0], jnp.where(idx == 1, c[1], c[2]))


def tw_from_ksel(ksel, tv):
    """Closest-point barycentric weights from the selected edge + its
    (inside-folded) edge parameter: edge k runs vertex k -> k+1, the
    opposite vertex k+2 gets weight 0 (== the reference backward's
    ``t + w0`` combination, cu:1044-1052)."""
    one_m = 1.0 - tv
    zero = jnp.zeros_like(tv)
    tw0 = sel3(ksel, (tv, zero, one_m))
    tw1 = sel3(ksel, (one_m, tv, zero))
    tw2 = sel3(ksel, (zero, one_m, tv))
    return tw0, tw1, tw2


def _pair_math(row, xp, yp, par, cfg: C.RenderConfig, need_wcn=True,
               fwd_only=False, need_depth=True):
    """Shared per-(pixel, face) math on a (TP, FC) tile.

    row(i): the i-th packed per-face constant as a (1, FC) array.
    Returns a dict of (TP, FC) arrays (each field mirrors the reference
    per-thread quantity cited inline).  need_wcn=False skips the three
    per-pair normalization divides when the caller only needs the winner's
    normalized barycentrics (computed select-then-divide).
    """
    # NOTE: the reference's per-pixel bbox cull (cu:747, margin sqrt(thr))
    # is subsumed by the distance cull below: outside bbox+sqrt(thr) implies
    # dis >= dist-to-bbox >= sqrt(thr) and outside the face, i.e. exactly
    # the (~inside) & (dis2 >= thr) condition (cu:769).  It is a GPU
    # fast-path, not extra semantics, so the backends skip it per pair (the
    # kernels cull per tile instead).
    thr = par[P_THR]

    w0 = row(pack.R_INV + 0) * xp + row(pack.R_INV + 1) * yp \
        + row(pack.R_INV + 2)
    w1 = row(pack.R_INV + 3) * xp + row(pack.R_INV + 4) * yp \
        + row(pack.R_INV + 5)
    w2 = row(pack.R_INV + 6) * xp + row(pack.R_INV + 7) * yp \
        + row(pack.R_INV + 8)

    # bbox gate (P_MARGIN): the inverse-matrix rows above blow up in fp32
    # for near-degenerate sliver faces, reporting phantom "inside" (and
    # phantom-small clamped distances) along thin bands arbitrarily far
    # from the face.  The bbox is computed directly from the projected
    # vertices (exact min/max), so gating candidacy on it bounds every
    # contribution to the pixels the reference actually keeps: outside
    # bbox + margin the true coverage is <= PROBABILITY_THRESHOLD
    # (cu:784's drop).  For pairs inside the gate every value below is
    # bitwise-unchanged.
    mbb = par[P_MARGIN]
    bb = (xp >= row(pack.R_BBOX + 0) - mbb) \
        & (xp <= row(pack.R_BBOX + 1) + mbb) \
        & (yp >= row(pack.R_BBOX + 2) - mbb) \
        & (yp <= row(pack.R_BBOX + 3) + mbb)

    # the three barycentric rows sum to 1 by construction (pack.py emits
    # them from one inverse matrix), so all w_i > 0 already implies every
    # w_i < 1: the upper test is redundant and the wmax chain is dead —
    # ~6 fewer VPU ops on every (pixel, face) pair in both kernels
    wmin = jnp.minimum(jnp.minimum(w0, w1), w2)
    inside = (wmin > 0) & bb
    in_loose = (wmin >= 0) & bb

    q = dict(w=(w0, w1, w2), inside=inside, in_loose=in_loose)

    if cfg.dist_func == C.HEAVISIDE:
        frag = jnp.where(in_loose, 1.0, 0.0)
        zero = jnp.zeros(w0.shape, jnp.float32)
        q.update(sign=jnp.where(inside, 1.0, -1.0), dis=zero, dis_x=zero,
                 dis_y=zero, tv=zero, ksel=jnp.zeros_like(w0, jnp.int32),
                 cull=~bb, rdis=zero)
    elif fwd_only:
        # Forward pass needs only dis^2: the region decision tree
        # (cu:127-139) exists to FIND the minimizing clamped edge, so a
        # plain min over the three clamped edge distances gives the same
        # value without the selection logic.  Per edge, two packed-constant
        # identities do the rest (see pack.py): d2u = w_j^2 |m|^2 and
        # d2c = d2u + (clip(tv)-tv)^2 |e|^2 (the foot vector is
        # perpendicular to the edge).
        ws = (w0, w1, w2)
        d2u_min = None
        d2c_min = None
        for k in range(3):
            tv = row(pack.R_TV + 3 * k) * xp \
                + row(pack.R_TV + 3 * k + 1) * yp \
                + row(pack.R_TV + 3 * k + 2)
            wj = ws[(k + 2) % 3]
            d2u = wj * wj * row(pack.R_MM + k)
            dd = jnp.clip(tv, 0.0, 1.0) - tv
            d2c = d2u + dd * dd * row(pack.R_E2 + k)
            d2u_min = d2u if d2u_min is None else jnp.minimum(d2u_min, d2u)
            d2c_min = d2c if d2c_min is None else jnp.minimum(d2c_min, d2c)
        dis2 = jnp.where(inside, d2u_min, d2c_min)
        cull = ((~inside) & (dis2 >= thr)) | ~bb
        dis, _ = _dis_from_dis2(dis2, cfg)
        sign = jnp.where(inside, 1.0, -1.0)
        frag = D.cdf(cfg.dist_func, sign, dis, par[P_SCALE], par[P_SHAPE],
                     par[P_SHIFT], gamma_inv1=par[P_GINV1])
        q.update(sign=sign, dis=dis, cull=cull)
    else:
        # Per edge, fold the inside/outside cases elementwise up front:
        # inside pairs rank edges by the unclamped foot distance
        # (cu:91-120), outside pairs by the clamped-segment distance
        # (cu:127-139, whose obtuse-vertex decision chain exists only to
        # FIND the boundary-attaining edge — a first-minimum argmin over the
        # clamped distances selects the same closest feature with no
        # dot/obtuse algebra; at corner regions two edges tie, but both
        # clamp to the SAME corner point with identical dis_x/dis_y and
        # tv in {0, 1}, so gradients don't depend on which tie wins).
        # Folding first means ONE argmin chain and ONE tv table below
        # instead of separate inside/outside selection trees.
        ws = (w0, w1, w2)
        tvs, dds, d2sel = [], [], []
        for k in range(3):
            tv = row(pack.R_TV + 3 * k) * xp \
                + row(pack.R_TV + 3 * k + 1) * yp \
                + row(pack.R_TV + 3 * k + 2)
            wj = ws[(k + 2) % 3]
            tvc = jnp.clip(tv, 0.0, 1.0)
            dd = tvc - tv
            u2 = wj * wj * row(pack.R_MM + k)
            c2 = u2 + dd * dd * row(pack.R_E2 + k)
            tvs.append(jnp.where(inside, tv, tvc))
            dds.append(dd)
            d2sel.append(jnp.where(inside, u2, c2))

        sel0 = (d2sel[0] <= d2sel[1]) & (d2sel[0] <= d2sel[2])
        sel1 = (~sel0) & (d2sel[1] <= d2sel[2])
        ksel = jnp.where(sel0, 0, jnp.where(sel1, 1, 2))

        # distance vector of the SELECTED feature only: u = w_j m_k for the
        # unclamped foot, plus dd * e_k when the edge parameter clamps
        # (k+2)%3 per edge id
        wj_sel = sel3(ksel, (q['w'][2], q['w'][0], q['w'][1]))
        mx_sel = sel3(ksel, tuple(row(pack.R_M + 2 * k) for k in range(3)))
        my_sel = sel3(ksel, tuple(row(pack.R_M + 2 * k + 1)
                                  for k in range(3)))
        dis_x = wj_sel * mx_sel
        dis_y = wj_sel * my_sel
        out_dd = jnp.where(inside, 0.0, sel3(ksel, dds))
        dis_x = dis_x + out_dd * sel3(
            ksel, tuple(row(pack.R_E + 2 * k) for k in range(3)))
        dis_y = dis_y + out_dd * sel3(
            ksel, tuple(row(pack.R_E + 2 * k + 1) for k in range(3)))
        tv_sel = sel3(ksel, tvs)

        # dis magnitude via the same min-formula as the forward fast path so
        # recomputed coverages match the forward bitwise (the max t-conorm
        # backward detects its winner by exact equality, cu:574-575)
        dis2 = jnp.minimum(jnp.minimum(d2sel[0], d2sel[1]), d2sel[2])
        cull = ((~inside) & (dis2 >= thr)) | ~bb
        dis, rdis = _dis_from_dis2(dis2, cfg)
        sign = jnp.where(inside, 1.0, -1.0)
        frag = D.cdf(cfg.dist_func, sign, dis, par[P_SCALE], par[P_SHAPE],
                     par[P_SHIFT], gamma_inv1=par[P_GINV1])
        q.update(sign=sign, dis=dis, dis_x=dis_x, dis_y=dis_y,
                 tv=tv_sel, ksel=ksel, cull=cull)
        if rdis is not None:
            q['rdis'] = rdis

    valid = (~q['cull']) & (frag > 1e-6) & (row(pack.R_FVALID) > 0)
    frag = jnp.where(valid, frag, 0.0)
    q['frag'] = frag
    q['valid'] = valid

    if not need_depth:
        return q

    if cfg.aggr_rgb_func == C.RGB_HARD:
        # Hard-RGB depth fast path: the z-argmin only ranks pixels that are
        # inside-loose (cu:815-822), where the clipped barycentrics equal
        # the raw ones and sum to exactly 1, so zp = 1/denom.  The argmin
        # over zp becomes an argmax over denom and the [near, far] window
        # becomes denom in [1/far, 1/near] — no per-pair divide, no clips.
        denom = row(pack.R_DZ + 0) * xp + row(pack.R_DZ + 1) * yp \
            + row(pack.R_DZ + 2)
        q['denom'] = denom
        q['zvalid'] = (denom >= 1.0 / par[P_FAR]) \
            & (denom <= 1.0 / par[P_NEAR])
        if need_wcn:
            # consumers mask by the (inside-loose) winner, where the raw
            # barycentrics are already clipped and normalized
            q['wcn'] = (w0, w1, w2)
    else:
        # clipped barycentrics, depth (cu:807-810)
        wc0 = jnp.clip(w0, 0.0, 1.0)
        wc1 = jnp.clip(w1, 0.0, 1.0)
        wc2 = jnp.clip(w2, 0.0, 1.0)
        s = jnp.maximum(wc0 + wc1 + wc2, 1e-5)
        denom = (wc0 * row(pack.R_IZ + 0) + wc1 * row(pack.R_IZ + 1)
                 + wc2 * row(pack.R_IZ + 2))
        zp = s / denom
        if need_wcn:
            q['wcn'] = (wc0 / s, wc1 / s, wc2 / s)
        q['zp'] = zp
        q['zvalid'] = (zp >= par[P_NEAR]) & (zp <= par[P_FAR])
    if cfg.double_side:
        q['front_ok'] = jnp.ones_like(valid)
    else:
        q['front_ok'] = row(pack.R_FRONT) > 0
    return q
