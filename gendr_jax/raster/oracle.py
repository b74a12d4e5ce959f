"""Dense reference oracle for the rasterizer (test-only).

Materializes all [B, P, F] pairs at once and aggregates with the *exact
sequential semantics* of the reference CUDA loop (python loop over faces for
the t-conorm fold, dense logsumexp for softmax RGB).  Used by the test suite
to validate the chunked-streaming XLA backend and the GPU kernels; far too
memory-hungry for production sizes.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gendr_jax import config as C
from gendr_jax.ops import distributions as D
from gendr_jax.ops import tconorms as T
from gendr_jax.raster import geometry as G
from gendr_jax.raster import prep
from gendr_jax.raster.xla_backend import pixel_grid, BIG_DEPTH


def render_forward(face_vertices, textures, cfg: C.RenderConfig, params):
    """Returns (soft_colors [B,4,H,W], aggrs_info [B,2,H,W]) as numpy."""
    face_vertices = jnp.asarray(face_vertices, jnp.float32)
    if face_vertices.ndim == 4:
        face_vertices = face_vertices.reshape(
            face_vertices.shape[0], face_vertices.shape[1], 9)
    textures = jnp.asarray(textures, jnp.float32)
    B, F = face_vertices.shape[:2]
    TS = textures.shape[2]
    is_ = cfg.image_size
    P = is_ * is_
    xp, yp = pixel_grid(is_)
    finfo = prep.faces_info(face_vertices)

    fb = face_vertices[:, None, :, :]
    ib = finfo[:, None, :, :]
    xpb = xp[None, :, None]
    ypb = yp[None, :, None]
    xy = tuple(fb[..., i] for i in (0, 1, 3, 4, 6, 7))
    z = (fb[..., 2], fb[..., 5], fb[..., 8])
    inv = tuple(ib[..., i] for i in range(9))
    sym = tuple(ib[..., 9 + i] for i in range(9))
    obt = tuple(ib[..., 18 + i] for i in range(3))

    threshold = float(params['dist_eps'] * params['dist_scale'])
    border_out = G.outside_bbox(xy, xpb, ypb, np.sqrt(threshold))
    w = G.barycentric(inv, xpb, ypb)

    if cfg.dist_func == C.HEAVISIDE:
        frag = jnp.where(G.inside_loose(w), 1.0, 0.0)
        dist_cull = jnp.zeros_like(frag, bool)
    else:
        sign, dis_x, dis_y, tw = G.signed_distance(w, xy, sym, obt, xpb, ypb)
        dis2 = dis_x ** 2 + dis_y ** 2
        dist_cull = (sign < 0) & (dis2 >= threshold)
        dis = dis2 if cfg.dist_squared else jnp.sqrt(dis2)
        frag = D.cdf(cfg.dist_func, sign, dis, params['dist_scale'],
                     params['dist_shape'], params['dist_shift'])
    valid = (~border_out) & (~dist_cull) & (frag > C.PROBABILITY_THRESHOLD)
    frag = np.asarray(jnp.where(valid, frag, 0.0))
    valid = np.asarray(valid)

    w_clip = G.barycentric_clip(w)
    zp = np.asarray(G.perspective_depth(w_clip, z))
    zvalid = (zp >= float(params['near'])) & (zp <= float(params['far']))
    front_ok = np.asarray(G.face_frontside(xy) | cfg.double_side)
    front_ok = np.broadcast_to(front_ok, frag.shape)
    inside = np.asarray(G.inside_loose(w))

    # -- colors per pair
    tex = np.asarray(textures)
    wc = [np.asarray(x) for x in w_clip]
    if cfg.texture_type == C.TEXTURE_VERTEX:
        colors = (wc[0][..., None] * tex[:, None, :, 0, :]
                  + wc[1][..., None] * tex[:, None, :, 1, :]
                  + wc[2][..., None] * tex[:, None, :, 2, :])
    else:
        R = int(round(TS ** 0.5))
        ti = np.asarray(G.surface_texel_index(
            tuple(jnp.asarray(x) for x in wc), R))
        colors = np.take_along_axis(
            tex[:, None], ti[..., None, None], axis=3)[..., 0, :]

    # -- alpha: exact sequential fold over faces
    alpha = np.zeros((B, P), np.float32)
    p_t = float(params['aggr_alpha_t_conorm_p'])
    if cfg.aggr_alpha_func == C.ALPHA_HARD:
        alpha = np.where(np.any(frag > 0.5, axis=-1), 1.0, alpha)
    else:
        for f in range(F):
            b = frag[:, :, f]
            upd = np.asarray(T.fold_step(cfg.aggr_alpha_func,
                                         jnp.asarray(alpha),
                                         jnp.asarray(b), p_t))
            alpha = np.where(valid[:, :, f], upd, alpha)

    bg = np.broadcast_to(np.asarray(params['background_color'],
                                    np.float32).reshape(1, 1, 3), (B, P, 3))

    if cfg.aggr_rgb_func == C.RGB_HARD:
        hmask = valid & zvalid & inside & front_ok
        zp_m = np.where(hmask, zp, np.inf)
        fidx = np.argmin(zp_m, axis=-1)
        zmin = np.min(zp_m, axis=-1)
        has = np.isfinite(zmin)
        rgb = np.where(
            has[..., None],
            np.take_along_axis(colors, fidx[..., None, None],
                               axis=2)[:, :, 0, :], bg)
        aggr0 = np.where(has, zmin, BIG_DEPTH)
        aggr1 = np.where(has, fidx, -1).astype(np.float32)
    else:
        cmask = valid & zvalid & front_ok
        eps = float(params['aggr_rgb_eps'])
        gamma = float(params['aggr_rgb_gamma'])
        zp_norm = (float(params['far']) - zp) / (float(params['far'])
                                                 - float(params['near']))
        zn = np.where(cmask, zp_norm, -np.inf)
        M = np.maximum(eps, zn.max(axis=-1))
        wexp = np.where(cmask, frag * np.exp((zn - M[..., None]) / gamma),
                        0.0)
        # the reference initializes softmax_sum = exp(eps/gamma) at
        # softmax_max = eps (cu:729), i.e. the background carries an extra
        # exp(eps/gamma) factor relative to a face with z-score eps
        bg_w = np.exp(eps / gamma) * np.exp((eps - M) / gamma)
        ssum = bg_w + wexp.sum(-1)
        rgb = (bg * bg_w[..., None]
               + np.einsum('bpf,bpfk->bpk', wexp, colors)) / ssum[..., None]
        aggr0, aggr1 = ssum, M

    soft = np.concatenate([rgb, alpha[..., None]], axis=-1)
    soft = soft.reshape(B, is_, is_, 4).transpose(0, 3, 1, 2)
    aggrs = np.stack([aggr0, aggr1], 1).reshape(B, 2, is_, is_)
    return soft, aggrs
