"""Pure-XLA streaming rasterizer: face-chunked scan with associative folds.

This is the array re-design of the reference's per-pixel CUDA loops
(``forward_render_cuda_kernel`` cu:680-862, ``backward_render_cuda_kernel``
cu:866-1065).  Instead of one thread per pixel serially looping over all
faces, each scan step processes a [B, P, CF] pixel x face-chunk block fully
vectorized, and the per-pixel aggregation state (alpha t-conorm fold,
streaming softmax-depth RGB, or hard z-argmin) is carried across chunks —
the same math that makes ring attention work: the t-conorm is associative
and the softmax is a streaming logsumexp.

Gradients are accumulated per chunk with dense reductions over the pixel
axis (deterministic by construction — no atomics, unlike the reference's
``atomicAdd`` scatter, cu:1054-1063).
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp

from gendr_jax import config as C
from gendr_jax.ops import distributions as D
from gendr_jax.ops import tconorms as T
from gendr_jax.raster import geometry as G
from gendr_jax.raster import pack
from gendr_jax.raster import pairmath as PM

BIG_DEPTH = 10000000.0  # cu:739
NEG_INF = -1e30


def pixel_grid(image_size: int, height=None, row0=0):
    """NDC pixel centers, flattened row-major over the output image.

    ``height``/``row0`` select a horizontal band (rows [row0, row0+height))
    of the image for the pixel-sharded path; NDC coordinates stay GLOBAL
    (derived from image_size), so the band result is bit-identical to the
    corresponding rows of a full render.  row0 may be a traced scalar."""
    if height is not None and (height != image_size
                               or not isinstance(row0, int) or row0 != 0):
        is_ = image_size
        rows = row0 + jnp.arange(height * is_, dtype=jnp.int32) // is_
        cols = jnp.arange(height * is_, dtype=jnp.int32) % is_
        yi = (is_ - 1 - rows).astype(jnp.float32)
        xi = cols.astype(jnp.float32)
        return (2.0 * xi + 1.0 - is_) / is_, (2.0 * yi + 1.0 - is_) / is_
    return _pixel_grid_full(image_size)


def _pixel_grid_full(image_size: int):
    """NDC pixel centers, flattened row-major over the output image
    (cu:712-719: yi = is-1-row is the vertical flip)."""
    is_ = image_size
    rows = jnp.arange(is_ * is_, dtype=jnp.int32) // is_
    cols = jnp.arange(is_ * is_, dtype=jnp.int32) % is_
    yi = (is_ - 1 - rows).astype(jnp.float32)
    xi = cols.astype(jnp.float32)
    yp = (2.0 * yi + 1.0 - is_) / is_
    xp = (2.0 * xi + 1.0 - is_) / is_
    return xp, yp


def tconorm_chunk_reduce(tid: int, frags: jnp.ndarray, p) -> jnp.ndarray:
    """Reduce the face axis (last) with the t-conorm.

    Associativity + commutativity of t-conorms makes any tree order
    equivalent to the reference's sequential fold up to float rounding.
    This one is an ascending-stride roll butterfly over a zero-padded
    power-of-two width; zero lanes vanish exactly
    (tconorms._zero_identity).
    """
    n = frags.shape[-1]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        pad = jnp.zeros(frags.shape[:-1] + (m - n,), frags.dtype)
        frags = jnp.concatenate([frags, pad], axis=-1)
    h = 1
    while h < m:
        frags = T.fold_step(tid, frags, jnp.roll(frags, h, axis=-1), p)
        h *= 2
    return frags[..., 0]


def _pair_quantities(pk, xp, yp, cfg: C.RenderConfig, par, fwd_only=False):
    """All per-(pixel, face) quantities for one chunk.

    pk: [B, NI, CF] packed per-face constants (pack.pack_faces, geometry
    rows); xp, yp: [P]; par: pairmath._params_vec.  Every returned array
    broadcasts to [B, P, CF].

    This delegates to the SAME shared pair math the GPU kernels run
    (pairmath._pair_math), so the two backends evaluate one operation
    sequence per pair; they differ only by compiler rounding (FMA
    contraction, transcendental implementations).
    """
    def row(i):
        return pk[:, i, None, :]       # [B, 1, CF]
    return PM._pair_math(row, xp[None, :, None], yp[None, :, None], par,
                         cfg, need_wcn=True, fwd_only=fwd_only,
                         need_depth=cfg.channels != 'alpha')


def _sample_colors(tex, wcn, cfg: C.RenderConfig):
    """Per-pair colors [B, P, CF, 3] (forward_sample_texture, cu:175-191)."""
    B, CF, TS, _ = tex.shape
    if cfg.texture_type == C.TEXTURE_VERTEX:
        w0, w1, w2 = wcn
        t = tex[:, None, :, :, :]  # [B,1,CF,3,3]
        return (w0[..., None] * t[..., 0, :] + w1[..., None] * t[..., 1, :]
                + w2[..., None] * t[..., 2, :])
    R = int(round(TS ** 0.5))
    ti = G.surface_texel_index(wcn, R)  # [B,P,CF]
    if TS == 1:
        return jnp.broadcast_to(tex[:, None, :, 0, :],
                                ti.shape + (3,))
    # flatten (CF, TS) and gather once per batch element
    tex_flat = tex.reshape(B, CF * TS, 3)
    cf_idx = jnp.arange(CF, dtype=jnp.int32)[None, None, :]
    flat_idx = cf_idx * TS + ti
    return jax.vmap(lambda tf, fi: tf[fi])(tex_flat, flat_idx)


def _sample_winner_color(tex, win_cf, w_clip_win, cfg: C.RenderConfig):
    """Color of the hard-RGB winning face per pixel. win_cf: [B, P]."""
    B, CF, TS, _ = tex.shape
    tex_win = jnp.take_along_axis(
        tex, win_cf[:, :, None, None].astype(jnp.int32), axis=1)  # [B,P,TS,3]
    if cfg.texture_type == C.TEXTURE_VERTEX:
        w0, w1, w2 = w_clip_win
        return (w0[..., None] * tex_win[..., 0, :]
                + w1[..., None] * tex_win[..., 1, :]
                + w2[..., None] * tex_win[..., 2, :])
    R = int(round(TS ** 0.5))
    if TS == 1:
        return tex_win[..., 0, :]
    ti = G.surface_texel_index(w_clip_win, R)  # [B,P]
    return jnp.take_along_axis(tex_win, ti[:, :, None, None],
                               axis=2)[..., 0, :]


def _chunked(arr, nc, cf):
    """[B, F, ...] -> [NC, B, CF, ...] for scan xs."""
    b = arr.shape[0]
    rest = arr.shape[2:]
    return jnp.moveaxis(arr.reshape(b, nc, cf, *rest), 1, 0)


def _chunked_rows(packed, nc, cf):
    """[B, NI, F] -> [NC, B, NI, CF] for scan xs."""
    b, ni = packed.shape[:2]
    return jnp.moveaxis(packed.reshape(b, ni, nc, cf), 2, 0)


def _pad_faces(face_vertices, textures, finfo, cf):
    B, F = face_vertices.shape[:2]
    nc = -(-F // cf)
    Fp = nc * cf
    if Fp != F:
        pad = ((0, 0), (0, Fp - F), (0, 0))
        face_vertices = jnp.pad(face_vertices, pad)
        if finfo is not None:
            finfo = jnp.pad(finfo, pad)
        textures = jnp.pad(textures, ((0, 0), (0, Fp - F), (0, 0), (0, 0)))
    fvalid = (jnp.arange(Fp) < F)
    return face_vertices, textures, finfo, fvalid, nc, Fp


# ---------------------------------------------------------------------------
# Forward — exposed as init/scan/merge/finalize so the face-axis-sharded
# path (gendr_jax.parallel) can run per-shard partial scans and merge the
# carries with collectives (the t-conorm fold is associative; softmax-RGB is
# a streaming logsumexp; hard RGB is an indexed argmin)
# ---------------------------------------------------------------------------

def background_carry(B, P, bg, cfg: C.RenderConfig, params: Dict):
    """The initial per-pixel aggregation state holding the background
    (cu:728-739).  bg: [B, P, 3]."""
    alpha0 = jnp.zeros((B, P), jnp.float32)
    eps = params['aggr_rgb_eps']
    gamma = params['aggr_rgb_gamma']
    smax0 = jnp.full((B, P), 1.0, jnp.float32) * eps
    ssum0 = jnp.full((B, P), 1.0, jnp.float32) * jnp.exp(eps / gamma)
    if cfg.aggr_rgb_func == C.RGB_SOFTMAX and cfg.channels != 'alpha':
        rgb0 = bg * ssum0[..., None]
    else:
        rgb0 = bg
    depth0 = jnp.full((B, P), BIG_DEPTH, jnp.float32)
    fidx0 = jnp.full((B, P), -1, jnp.int32)
    return (alpha0, smax0, ssum0, rgb0, depth0, fidx0)


def empty_carry(B, P, cfg: C.RenderConfig):
    """Identity aggregation state (no background) for per-shard partials."""
    return (jnp.zeros((B, P), jnp.float32),
            jnp.full((B, P), NEG_INF, jnp.float32),
            jnp.zeros((B, P), jnp.float32),
            jnp.zeros((B, P, 3), jnp.float32),
            jnp.full((B, P), BIG_DEPTH, jnp.float32),
            jnp.full((B, P), -1, jnp.int32))


def merge_carries(a, b, cfg: C.RenderConfig, params: Dict):
    """Merge two aggregation states; ``a`` covers faces that precede ``b``
    (tie-breaks: hard-RGB strict < keeps the earlier face)."""
    gamma = params['aggr_rgb_gamma']
    p_t = params['aggr_alpha_t_conorm_p']
    alpha_a, smax_a, ssum_a, rgb_a, depth_a, fidx_a = a
    alpha_b, smax_b, ssum_b, rgb_b, depth_b, fidx_b = b
    if cfg.aggr_alpha_func == C.ALPHA_HARD:
        alpha = jnp.maximum(alpha_a, alpha_b)
    else:
        alpha = T.fold_step(cfg.aggr_alpha_func, alpha_a, alpha_b, p_t)
    m = jnp.maximum(smax_a, smax_b)
    sa = jnp.exp((smax_a - m) / gamma)
    sb = jnp.exp((smax_b - m) / gamma)
    ssum = ssum_a * sa + ssum_b * sb
    rgb_soft = rgb_a * sa[..., None] + rgb_b * sb[..., None]
    better = depth_b < depth_a
    depth = jnp.where(better, depth_b, depth_a)
    fidx = jnp.where(better, fidx_b, fidx_a)
    if cfg.aggr_rgb_func == C.RGB_HARD:
        rgb = jnp.where(better[..., None], rgb_b, rgb_a)
    else:
        rgb = rgb_soft
    return (alpha, m, ssum, rgb, depth, fidx)


def forward_carry(face_vertices, textures, finfo, fvalid, carry0,
                  cfg: C.RenderConfig, params: Dict, base_offset=0,
                  row_band=None):
    """Scan all face chunks, starting from ``carry0``.  Inputs must already
    be padded to a multiple of cfg.face_chunk; fvalid: [Fp] bool.
    ``base_offset`` shifts the global face indices recorded for hard RGB;
    ``row_band=(row0, height)`` renders only that row band (carry0 must be
    sized height*image_size pixels)."""
    del finfo  # superseded by the packed-constant pair math
    B, Fp = face_vertices.shape[:2]
    is_ = cfg.image_size
    row0, hb = row_band if row_band is not None else (0, None)
    xp, yp = pixel_grid(is_, hb, row0)
    cf = min(cfg.face_chunk, max(Fp, 1))
    nc = Fp // cf
    gamma = params['aggr_rgb_gamma']
    par = PM._params_vec(params, cfg=cfg)
    packed = pack.pack_faces(face_vertices, textures, fvalid, cfg,
                             with_tex=False)

    xs = (_chunked_rows(packed, nc, cf), _chunked(textures, nc, cf),
          base_offset + jnp.arange(nc, dtype=jnp.int32) * cf)

    def body(carry, chunk):
        alpha, smax, ssum, rgb, depth_min, fidx = carry
        pk, tex, base = chunk
        q = _pair_quantities(pk, xp, yp, cfg, par, fwd_only=True)
        frag, valid = q['frag'], q['valid']

        # -- alpha aggregation (cu:791-801).  The t-conorm parameter comes
        # from the runtime-opaque par vector, as in the kernels, not from
        # params (a trace-time constant XLA may fold differently).
        if cfg.aggr_alpha_func == C.ALPHA_HARD:
            alpha = jnp.where(jnp.any(frag > 0.5, axis=-1), 1.0, alpha)
        else:
            chunk_agg = tconorm_chunk_reduce(
                cfg.aggr_alpha_func, frag, par[PM.P_TCP])
            alpha = T.fold_step(cfg.aggr_alpha_func, alpha, chunk_agg,
                                par[PM.P_TCP])

        # -- RGB aggregation
        if cfg.channels == 'alpha':
            pass  # silhouette-only: depth/RGB skipped entirely
        elif cfg.aggr_rgb_func == C.RGB_HARD:
            # z-argmin among pixels inside the face (cu:815-822); the pair
            # math emits the affine denom = 1/zp (valid on inside-loose
            # candidates), so rank by its reciprocal
            hmask = valid & q['zvalid'] & q['in_loose'] & q['front_ok']
            zp_m = jnp.where(hmask, 1.0 / q['denom'], jnp.inf)
            win_cf = jnp.argmin(zp_m, axis=-1)  # [B,P], ties -> first
            zmin_chunk = jnp.min(zp_m, axis=-1)
            w_clip_win = tuple(
                jnp.take_along_axis(wc, win_cf[..., None],
                                    axis=-1)[..., 0]
                for wc in q['wcn'])
            color_win = _sample_winner_color(tex, win_cf, w_clip_win, cfg)
            better = zmin_chunk < depth_min
            depth_min = jnp.where(better, zmin_chunk, depth_min)
            fidx = jnp.where(better, base + win_cf.astype(jnp.int32), fidx)
            rgb = jnp.where(better[..., None], color_win, rgb)
        else:
            # streaming softmax over zp_norm weighted by coverage
            # (cu:824-839)
            cmask = valid & q['zvalid'] & q['front_ok']
            zp_norm = (params['far'] - q['zp']) / (params['far']
                                                   - params['near'])
            zn = jnp.where(cmask, zp_norm, NEG_INF)
            m_new = jnp.maximum(smax, jnp.max(zn, axis=-1))
            scale_old = jnp.exp((smax - m_new) / gamma)
            expz = jnp.exp((zn - m_new[..., None]) / gamma)
            wexp = jnp.where(cmask, frag * expz, 0.0)
            colors = _sample_colors(tex, q['wcn'], cfg)
            ssum = ssum * scale_old + jnp.sum(wexp, axis=-1)
            rgb = rgb * scale_old[..., None] \
                + jnp.einsum('bpc,bpck->bpk', wexp, colors,
             precision=jax.lax.Precision.HIGHEST)
            smax = m_new

        return (alpha, smax, ssum, rgb, depth_min, fidx), None

    carry, _ = jax.lax.scan(body, carry0, xs)
    return carry


def finalize(carry, cfg: C.RenderConfig):
    """Carry -> (soft_colors [B,4,H,W], aggrs_info [B,2,H,W]).  H is
    derived from the carry's pixel count (it is a band height under the
    pixel-sharded path), W = cfg.image_size."""
    alpha, smax, ssum, rgb, depth_min, fidx = carry
    B = alpha.shape[0]
    is_ = cfg.image_size
    h = alpha.shape[1] // is_
    if cfg.channels == 'alpha':
        rgb_final = rgb  # carries the background untouched
        aggr0, aggr1 = depth_min, fidx.astype(jnp.float32)
    elif cfg.aggr_rgb_func == C.RGB_HARD:
        rgb_final = rgb
        aggr0, aggr1 = depth_min, fidx.astype(jnp.float32)
    else:
        rgb_final = rgb / ssum[..., None]
        aggr0, aggr1 = ssum, smax
    soft_colors = jnp.concatenate([rgb_final, alpha[..., None]], axis=-1)
    soft_colors = soft_colors.reshape(B, h, is_, 4).transpose(0, 3, 1, 2)
    aggrs_info = jnp.stack([aggr0, aggr1], axis=1).reshape(B, 2, h, is_)
    return soft_colors, aggrs_info


def forward(face_vertices, textures, finfo, cfg: C.RenderConfig,
            params: Dict):
    """Returns (soft_colors [B,4,H,W], aggrs_info [B,2,H,W]).

    Semantics of ``forward_render_cuda_kernel`` (cu:680-862), streamed over
    face chunks.
    """
    B, F = face_vertices.shape[:2]
    is_ = cfg.image_size
    P = is_ * is_
    cf = min(cfg.face_chunk, max(F, 1))
    face_vertices, textures, finfo, fvalid, nc, Fp = _pad_faces(
        face_vertices, textures, finfo, cf)
    bg = jnp.broadcast_to(
        jnp.asarray(params['background_color'],
                    jnp.float32).reshape(1, 1, 3), (B, P, 3))
    carry0 = background_carry(B, P, bg, cfg, params)
    carry = forward_carry(face_vertices, textures, finfo, fvalid, carry0,
                          cfg, params)
    return finalize(carry, cfg)


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def backward(face_vertices, textures, finfo, soft_colors, aggrs_info,
             grad_soft_colors, cfg: C.RenderConfig, params: Dict,
             base_offset=0, row_band=None):
    """Returns (grad_face_vertices [B,F,9], grad_textures [B,F,TS,3]).

    Semantics of ``backward_render_cuda_kernel`` (cu:866-1065): recompute the
    per-pair coverage, apply the aggregate-inverse t-conorm rule, the softmax
    RGB chain, and the closest-point distance chain; accumulate per chunk
    with dense pixel reductions instead of atomicAdd.  ``row_band`` as in
    forward_carry: the image tensors then hold only that row band.
    """
    B, F = face_vertices.shape[:2]
    TS = textures.shape[2]
    is_ = cfg.image_size
    row0, hb = row_band if row_band is not None else (0, None)
    P = soft_colors.shape[2] * soft_colors.shape[3]
    xp, yp = pixel_grid(is_, hb, row0)
    cf = min(cfg.face_chunk, max(F, 1))
    gamma = params['aggr_rgb_gamma']

    del finfo  # superseded by the packed-constant pair math
    face_vertices_p, textures_p, _, fvalid, nc, Fp = _pad_faces(
        face_vertices, textures, None, cf)
    par = PM._params_vec(params, cfg=cfg)
    packed = pack.pack_faces(face_vertices_p, textures_p, fvalid, cfg,
                             with_tex=False)

    # flatten pixel-space tensors to [B, P, .]
    g = grad_soft_colors.transpose(0, 2, 3, 1).reshape(B, P, 4)
    final = soft_colors.transpose(0, 2, 3, 1).reshape(B, P, 4)
    aggr = aggrs_info.reshape(B, 2, P)
    aggr0, aggr1 = aggr[:, 0], aggr[:, 1]  # (ssum, smax) or (depth, idx)

    xs = (_chunked_rows(packed, nc, cf), _chunked(textures_p, nc, cf),
          base_offset + jnp.arange(nc, dtype=jnp.int32) * cf)

    def body(_, chunk):
        pk, tex, base = chunk
        q = _pair_quantities(pk, xp, yp, cfg, par)
        frag, valid = q['frag'], q['valid']
        w_clip = q.get('wcn')

        gA = g[..., 3]  # [B, P]
        # alpha path (cu:973-987)
        if cfg.aggr_alpha_func == C.ALPHA_HARD:
            # reference quirk: the incoming alpha grad still flows into the
            # coverage chain un-multiplied (cu:975-976 only skips the
            # t-conorm factor)
            c_grad_xy = jnp.broadcast_to(gA[..., None], frag.shape)
        else:
            c_grad_xy = gA[..., None] * T.aggregate_backward(
                cfg.aggr_alpha_func, final[..., 3:4], frag,
                par[PM.P_TCP])
        c_grad_xy = jnp.where(valid, c_grad_xy, 0.0)

        gz = None
        gtex_coef = None  # [B,P,CF,3] per-channel texture-grad coefficient
        if cfg.channels == 'alpha':
            gtex_coef = jnp.zeros(frag.shape + (3,), jnp.float32)
        elif cfg.aggr_rgb_func == C.RGB_HARD:
            # texture grad only to the winning face (cu:997-1004)
            zmask = valid & q['zvalid']
            cf_ids = base + jnp.arange(cf, dtype=jnp.int32)[None, None, :]
            win = zmask & (aggr1[..., None].astype(jnp.int32) == cf_ids)
            gtex_coef = jnp.where(win[..., None], g[:, :, None, :3], 0.0)
        else:
            zp = q['zp']
            cmask = valid & q['zvalid'] & q['front_ok']
            zp_norm = (params['far'] - zp) / (params['far'] - params['near'])
            # aggr0 = softmax_sum, aggr1 = softmax_max (cu:916-917, 1010)
            zp_softmax = jnp.where(
                cmask,
                frag * jnp.exp((jnp.where(cmask, zp_norm, NEG_INF)
                                - aggr1[..., None]) / gamma)
                / aggr0[..., None], 0.0)
            colors = _sample_colors(tex, w_clip, cfg)
            diff = colors - final[:, :, None, :3]  # color_k - final_k
            c_xyz = jnp.einsum('bpk,bpck->bpc', g[..., :3], diff,
            precision=jax.lax.Precision.HIGHEST) \
                * zp_softmax  # cu:1012-1023
            gtex_coef = zp_softmax[..., None] * g[:, :, None, :3]
            c_grad_xy = c_grad_xy + jnp.where(
                cmask, c_xyz / jnp.where(cmask, frag, 1.0), 0.0)  # cu:1024
            c_z = c_xyz / gamma / (params['near'] - params['far']) \
                * zp * zp  # cu:1026
            # w_clip_j / z_j^2 == wcn_j * iz_j^2 (cu:1027-1029)
            iz = tuple(pk[:, pack.R_IZ + k, None, :] for k in range(3))
            gz = tuple(jnp.where(cmask,
                                 c_z * w_clip[k] * (iz[k] * iz[k]), 0.0)
                       for k in range(3))

        # distance chain (cu:1034-1052)
        pdf_v = D.pdf(cfg.dist_func, q['sign'], q['dis'],
                      params['dist_scale'], params['dist_shape'],
                      params['dist_shift'], gamma_inv=par[PM.P_GINV])
        c_grad_xy = jnp.where(valid, c_grad_xy * pdf_v, 0.0)

        tw = PM.tw_from_ksel(q['ksel'], q['tv'])
        dis_x, dis_y = q['dis_x'], q['dis_y']
        if cfg.dist_squared:
            base_coef = 2.0 * q['sign'] * c_grad_xy
        else:
            # |(dis_x, dis_y)| == dis by construction (the selected
            # feature's distance vector is the quantity dis was drawn
            # from), so the direction normalization reuses the rsqrt that
            # produced dis — no per-pair divide (cu:1046-1050)
            base_coef = q['sign'] * c_grad_xy * q['rdis']

        # per-chunk gradient tensors, reduced over pixels (deterministic)
        gface = []
        for k in range(3):
            gx = jnp.sum(base_coef * tw[k] * dis_x, axis=1)  # [B, CF]
            gy = jnp.sum(base_coef * tw[k] * dis_y, axis=1)
            if gz is not None:
                gzk = jnp.sum(gz[k], axis=1)
            else:
                gzk = jnp.zeros_like(gx)
            gface.extend([gx, gy, gzk])
        gface = jnp.stack(gface, axis=-1)  # [B, CF, 9]

        # texture gradients (backward_sample_texture, cu:194-214)
        if cfg.channels == 'alpha':
            gtex = jnp.zeros((B, cf) + textures.shape[2:], jnp.float32)
        elif cfg.texture_type == C.TEXTURE_VERTEX:
            gtex = jnp.stack([
                jnp.einsum('bpc,bpck->bck', w_clip[j], gtex_coef,
            precision=jax.lax.Precision.HIGHEST)
                for j in range(3)], axis=2)  # [B, CF, 3, 3]
        else:
            R = int(round(TS ** 0.5))
            if TS == 1:
                gtex = jnp.sum(gtex_coef, axis=1)[:, :, None, :]
            else:
                ti = G.surface_texel_index(w_clip, R)  # [B,P,CF]
                slices = []
                for t in range(TS):
                    m = (ti == t).astype(gtex_coef.dtype)
                    slices.append(jnp.einsum('bpc,bpck->bck', m, gtex_coef,
            precision=jax.lax.Precision.HIGHEST))
                gtex = jnp.stack(slices, axis=2)  # [B, CF, TS, 3]

        return None, (gface, gtex)

    _, (gfaces, gtexs) = jax.lax.scan(body, None, xs)
    grad_faces = jnp.moveaxis(gfaces, 0, 1).reshape(B, Fp, 9)[:, :F]
    grad_tex = jnp.moveaxis(gtexs, 0, 1).reshape(B, Fp, TS, 3)[:, :F]
    return grad_faces, grad_tex


# ---------------------------------------------------------------------------
# Backend aux contract (see raster.render): the packed constants are cheap
# O(F) prep recomputed bitwise-identically in backward, so aux is None
# ---------------------------------------------------------------------------

def forward_with_aux(face_vertices, textures, cfg: C.RenderConfig,
                     params: Dict):
    soft_colors, aggrs_info = forward(face_vertices, textures, None, cfg,
                                      params)
    return soft_colors, aggrs_info, None


def backward_from_aux(face_vertices, textures, aux, soft_colors, aggrs_info,
                      grad_soft_colors, cfg: C.RenderConfig, params: Dict,
                      base_offset=0):
    return backward(face_vertices, textures, aux, soft_colors, aggrs_info,
                    grad_soft_colors, cfg, params, base_offset)
