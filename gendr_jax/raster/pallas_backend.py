"""GPU rasterization kernels: Pallas on the Triton route.

Re-design of the reference's CUDA render kernels (forward cu:680-862,
backward cu:866-1065) that keeps their per-pixel serial fold and replaces
their early exits and atomics:

* prepass (plain jnp, shared by forward and backward): Morton-sort the
  faces so that face chunks are spatially tight, fold the per-face algebra
  into affine constants (``pack.pack_faces``), and build tile x chunk hit
  lists (``pack.tile_chunk_mask`` / ``pack.compact_hits``) in place of the
  reference's per-thread bbox and distance exits (cu:747, 769).
* forward: one program per (image, 2D pixel tile), one pixel per thread.
  The program walks its tile's hit chunks and folds their faces serially
  per pixel with the carries in registers, as cu:791-839 does.  A face
  whose bbox + cull margin misses the tile is skipped after one scalar
  test.  Every t-conorm family, the hard-RGB z-argmin and the streaming
  softmax share this one loop.
* backward: one program per (image, face).  It walks the hit tiles of its
  face's chunk, accumulates per-pixel gradient terms in registers and sums
  them over the pixels once, at the end: deterministic, with no atomics
  (cu:1054-1063 scatters with atomicAdd).
* hard RGB samples its colour in an XLA epilogue keyed on the winning face
  id (``_hard_rgb_sample``); softmax RGB samples in-kernel with a gather.
  Both take their texture gradients in the backward kernel, where each
  face program sums its own pixels' terms.

The per-pair math is ``pairmath._pair_math``, shared with the XLA scan.
Image tiles may overhang the image: the kernels mask the overhang, so any
image size runs.  On the CPU the kernels run in Pallas's interpreter, which
is how the tests reach them; on a GPU they compile through Triton.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from gendr_jax import config as C
from gendr_jax.ops import distributions as D
from gendr_jax.ops import tconorms as T
from gendr_jax.raster import pack
from gendr_jax.raster import xla_backend as X
from gendr_jax.raster.pairmath import (
    P_SCALE, P_SHAPE, P_SHIFT, P_TCP, P_GAMMA, P_NEAR, P_FAR, P_GINV,
    P_ROW0, P_MARGIN, NPAR, _params_vec, _pair_math, tw_from_ksel)

NEG_INF = -1e30
BIG_DEPTH = X.BIG_DEPTH
# pixels per tile when cfg.pixel_tile is 0: one pixel per thread, four warps
DEFAULT_TILE = 128
# texels per block of the backward's one-hot texture-gradient sum
TEXEL_BLOCK = 32
# pixel columns the backward reads, by RGB mode
_PIX_COLS_ALPHA = ('ga', 'fa')
_PIX_COLS_HARD = ('ga', 'fa', 'gr0', 'gr1', 'gr2', 'fid')
_PIX_COLS_SOFTMAX = ('gr0', 'gr1', 'gr2', 'ga', 'fr0', 'fr1', 'fr2', 'fa',
                     'a0', 'a1')


def _interpret():
    """Pallas interprets the kernels on the CPU only; on a GPU they compile
    through Triton or fail."""
    return jax.devices()[0].platform == 'cpu'


def _pow2_ceil(n):
    return 1 << max(0, int(n) - 1).bit_length()


def _tile_shape(cfg: C.RenderConfig):
    """(tile_w, tile_h) of the 2D pixel tile: a power of two of pixels
    (cfg.pixel_tile, or DEFAULT_TILE), at most 16 wide.  Tiles overhang
    the image where its size is not a multiple; the kernels mask them."""
    tp = cfg.pixel_tile or DEFAULT_TILE
    if tp & (tp - 1):
        raise ValueError(f'pixel_tile must be a power of two, got {tp}')
    tile_w = min(16, _pow2_ceil(cfg.image_size), tp)
    return tile_w, tp // tile_w


def _compiler_params(tp):
    return plt.CompilerParams(num_warps=max(1, min(8, tp // 32)),
                              num_stages=1)


def _rgb_mode(cfg: C.RenderConfig):
    """'alpha', 'hard' or 'softmax': what the kernels aggregate."""
    if cfg.channels == 'alpha':
        return 'alpha'
    return 'hard' if cfg.aggr_rgb_func == C.RGB_HARD else 'softmax'


def _texel_index_from_w(w0, w1, TS):
    """surface_texel_index (cu:178-185), elementwise on any shape."""
    R = int(round(TS ** 0.5))
    w_x = jnp.floor(w0 * R).astype(jnp.int32)
    w_y = jnp.floor(w1 * R).astype(jnp.int32)
    lower = (w0 + w1) * R - w_x.astype(jnp.float32) \
        - w_y.astype(jnp.float32) <= 1.0
    idx = jnp.where(lower, w_y * R + w_x,
                    (R - 1 - w_y) * R + (R - 1 - w_x))
    return jnp.clip(idx, 0, TS - 1)


def _colors(packed_ref, b, f, row, q, cfg: C.RenderConfig, TS):
    """Per-pair colours of face f (forward_sample_texture, cu:175-191):
    vertex = barycentric blend; surface = the texel the clipped
    barycentrics select, gathered from the face's packed texel rows."""
    if cfg.texture_type == C.TEXTURE_VERTEX:
        w = q['wcn']
        return [w[0] * row(pack.R_TEX + c) + w[1] * row(pack.R_TEX + 3 + c)
                + w[2] * row(pack.R_TEX + 6 + c) for c in range(3)]
    if TS == 1:
        return [row(pack.R_TEX + c) for c in range(3)]
    ti = _texel_index_from_w(q['wcn'][0], q['wcn'][1], TS)
    return [packed_ref[b, f, pack.R_TEX + 3 * ti + c] for c in range(3)]


class _Tiles:
    """Static tile geometry of one render (or row band)."""

    def __init__(self, cfg: C.RenderConfig, hb):
        self.is_ = cfg.image_size
        self.hb = hb
        self.tile_w, self.tile_h = _tile_shape(cfg)
        self.tp = self.tile_w * self.tile_h
        self.tx_n = -(-self.is_ // self.tile_w)
        self.ty_n = -(-hb // self.tile_h)
        self.n = self.tx_n * self.ty_n

    def _x(self, col):
        return (2.0 * col.astype(jnp.float32) + 1.0 - self.is_) / self.is_

    def _y(self, grow):
        return (2.0 * (self.is_ - 1 - grow).astype(jnp.float32) + 1.0
                - self.is_) / self.is_

    def pixels(self, t, row0):
        """Pixels of tile t: NDC (xp, yp), the on-image mask and the
        band-local row-major pixel index, each of shape (tp,).  row0 is
        the band's first global row (int32 scalar)."""
        lidx = jnp.arange(self.tp, dtype=jnp.int32)
        ty = jax.lax.div(t, self.tx_n)
        tx = t - ty * self.tx_n
        prow = ty * self.tile_h + jax.lax.div(lidx, self.tile_w)
        pcol = tx * self.tile_w + jax.lax.rem(lidx, self.tile_w)
        inside = (prow < self.hb) & (pcol < self.is_)
        return (self._x(pcol), self._y(prow + row0), inside,
                prow * self.is_ + pcol)

    def overlaps(self, t, row0, row, margin):
        """Scalar test: can any pixel of tile t lie inside face row's
        bbox + margin?  Padded by half a pixel, so it never drops a pair
        that the per-pair gate (pairmath P_MARGIN) keeps."""
        ty = jax.lax.div(t, self.tx_n)
        tx = t - ty * self.tx_n
        pad = 1.0 / self.is_
        c0 = tx * self.tile_w
        r0 = row0 + ty * self.tile_h
        x_lo = self._x(c0) - pad
        x_hi = self._x(c0 + self.tile_w - 1) + pad
        y_hi = self._y(r0) + pad
        y_lo = self._y(r0 + self.tile_h - 1) - pad
        return ((row(pack.R_FVALID) > 0)
                & (row(pack.R_BBOX + 0) - margin <= x_hi)
                & (row(pack.R_BBOX + 1) + margin >= x_lo)
                & (row(pack.R_BBOX + 2) - margin <= y_hi)
                & (row(pack.R_BBOX + 3) + margin >= y_lo))


# ---------------------------------------------------------------------------
# Forward kernel
# ---------------------------------------------------------------------------

def _fwd_out_cols(cfg: C.RenderConfig):
    """Forward output rows: [alpha] (alpha only), [alpha, depth, winner id]
    (hard RGB; colour is the epilogue gather keyed on the id), or [alpha,
    ssum, smax, r, g, b] (softmax RGB)."""
    return {'alpha': 1, 'hard': 3, 'softmax': 6}[_rgb_mode(cfg)]


def _fwd_kernel(count_ref, ids_ref, par_ref, packed_ref, out_ref, *,
                cfg: C.RenderConfig, tiles: _Tiles, FC, TS):
    b = pl.program_id(0)
    t = pl.program_id(1)
    n = count_ref[b, t]
    par = tuple(par_ref[i] for i in range(NPAR))
    row0 = par[P_ROW0].astype(jnp.int32)
    xp, yp, inside, pidx = tiles.pixels(t, row0)
    tid = cfg.aggr_alpha_func
    mode = _rgb_mode(cfg)
    need_wcn = mode == 'softmax' and (cfg.texture_type == C.TEXTURE_VERTEX
                                      or TS > 1)
    gamma = par[P_GAMMA]

    zero = jnp.zeros((tiles.tp,), jnp.float32)
    neg = jnp.full((tiles.tp,), NEG_INF, jnp.float32)
    init = [zero]
    if mode == 'hard':
        init += [neg, jnp.full((tiles.tp,), -1.0, jnp.float32)]
    elif mode == 'softmax':
        init += [zero, neg, zero, zero, zero]

    def fold(f, carry):
        def row(i):
            return packed_ref[b, f, i]

        q = _pair_math(row, xp, yp, par, cfg, need_wcn=need_wcn,
                       fwd_only=True, need_depth=mode != 'alpha')
        frag = q['frag']
        a = carry[0]
        # alpha (cu:791-801): the reference's serial fold, one face at a time
        if tid == C.ALPHA_HARD:
            out = [jnp.maximum(a, jnp.where(frag > 0.5, 1.0, 0.0))]
        else:
            out = [T.fold_step(tid, a, frag, par[P_TCP])]
        if mode == 'hard':
            # z-argmin as a denom argmax (zp = 1/denom on inside-loose
            # pixels, see _pair_math); strict > keeps the earlier face on
            # ties, as cu:815-822 does
            dbest, fbest = carry[1], carry[2]
            hmask = q['valid'] & q['zvalid'] & q['in_loose'] & q['front_ok']
            dm = jnp.where(hmask, q['denom'], NEG_INF)
            better = dm > dbest
            out += [jnp.where(better, dm, dbest),
                    jnp.where(better, f.astype(jnp.float32), fbest)]
        elif mode == 'softmax':
            # streaming softmax over depth (cu:824-839)
            ssum, smax, sr, sg, sb = carry[1:]
            cmask = q['valid'] & q['zvalid'] & q['front_ok']
            zn = (par[P_FAR] - q['zp']) / (par[P_FAR] - par[P_NEAR])
            m_new = jnp.where(cmask, jnp.maximum(smax, zn), smax)
            scale = jnp.exp((smax - m_new) / gamma)
            w = jnp.where(cmask, frag * jnp.exp((zn - m_new) / gamma), 0.0)
            cols = _colors(packed_ref, b, f, row, q, cfg, TS)
            out += [ssum * scale + w, m_new, sr * scale + w * cols[0],
                    sg * scale + w * cols[1], sb * scale + w * cols[2]]
        return tuple(out)

    def face_body(f, carry):
        def row(i):
            return packed_ref[b, f, i]

        hit = tiles.overlaps(t, row0, row, par[P_MARGIN])
        return jax.lax.cond(hit, functools.partial(fold, f), lambda c: c,
                            carry)

    def chunk_body(j, carry):
        f0 = ids_ref[b, t, j] * FC
        return jax.lax.fori_loop(f0, f0 + FC, face_body, carry)

    final = jax.lax.fori_loop(0, n, chunk_body, tuple(init))

    cols = [final[0]]
    if mode == 'hard':
        dbest, fbest = final[1], final[2]
        any_v = dbest > NEG_INF
        cols += [jnp.where(any_v, 1.0 / dbest, BIG_DEPTH),
                 jnp.where(any_v, fbest, -1.0)]
    elif mode == 'softmax':
        cols += list(final[1:])
    for c, v in enumerate(cols):
        plt.store(out_ref.at[b, c, pidx], v, mask=inside)


def _fwd_kernel_out(face_vertices, textures, cfg: C.RenderConfig,
                    params: Dict, aux=None, fvalid=None, row_band=None):
    """Run the forward kernel; returns (out [B, NO_F, P] channel-major in
    row-major pixel order, aux).  ``row_band=(row0, height)`` renders only
    that image row band (pixel-sharded path); P = height * image_size."""
    B = face_vertices.shape[0]
    TS = textures.shape[2]
    is_ = cfg.image_size
    row0, hb = row_band if row_band is not None else (0, is_)
    if aux is None:
        aux = _prepass(face_vertices, textures, cfg, params, fvalid,
                       row_band)
    tiles = _Tiles(cfg, hb)
    kernel = functools.partial(_fwd_kernel, cfg=cfg, tiles=tiles,
                               FC=cfg.face_chunk, TS=TS)
    out = pl.pallas_call(
        kernel,
        grid=(B, tiles.n),
        out_shape=jax.ShapeDtypeStruct((B, _fwd_out_cols(cfg), hb * is_),
                                       jnp.float32),
        backend='triton',
        compiler_params=_compiler_params(tiles.tp),
        interpret=_interpret(),
        name='gendr_raster_fwd',
    )(aux['tile_counts'], aux['tile_ids'], _params_vec(params, row0, cfg),
      aux['packed'])
    return out, aux


# ---------------------------------------------------------------------------
# Backward kernel
# ---------------------------------------------------------------------------

def _bwd_tex_cols(cfg: C.RenderConfig, TS):
    """Texture-gradient columns the backward kernel emits (alpha-only has
    none)."""
    if _rgb_mode(cfg) == 'alpha':
        return 0
    return 9 if cfg.texture_type == C.TEXTURE_VERTEX else 3 * TS


def _bwd_kernel(count_ref, ids_ref, par_ref, packed_ref, pix_ref, out_ref, *,
                cfg: C.RenderConfig, tiles: _Tiles, FC, TS, NTEX):
    b = pl.program_id(0)
    f = pl.program_id(1)
    k = jax.lax.div(f, FC)
    n = count_ref[b, k]
    par = tuple(par_ref[i] for i in range(NPAR))
    row0 = par[P_ROW0].astype(jnp.int32)
    gamma = par[P_GAMMA]
    tid = cfg.aggr_alpha_func
    mode = _rgb_mode(cfg)
    softmax = mode == 'softmax'
    names = {'alpha': _PIX_COLS_ALPHA, 'hard': _PIX_COLS_HARD,
             'softmax': _PIX_COLS_SOFTMAX}[mode]
    surface_blocks = (mode != 'alpha' and TS > 1
                      and cfg.texture_type == C.TEXTURE_SURFACE)
    TB = min(_pow2_ceil(TS), TEXEL_BLOCK)
    nblk = -(-TS // TB)
    n_geom = 9 if softmax else 6
    n_lane_tex = 0 if surface_blocks else NTEX  # per-pixel tex carries

    def row(i):
        return packed_ref[b, f, i]

    def pair_terms(t):
        """Per-pixel gradient terms of this face on tile t."""
        xp, yp, inside, pidx = tiles.pixels(t, row0)
        # off-image pixels read 0 (1 for the softmax sum a0, a divisor)
        pc = {nm: plt.load(pix_ref.at[b, i, pidx], mask=inside,
                           other=1.0 if nm == 'a0' else 0.0)
              for i, nm in enumerate(names)}
        q = _pair_math(row, xp, yp, par, cfg, need_wcn=softmax,
                       need_depth=softmax)
        frag = q['frag']
        valid = q['valid'] & inside

        # alpha chain (cu:973-987); ALPHA_HARD keeps the reference quirk of
        # an un-multiplied incoming grad (cu:975-976)
        if tid == C.ALPHA_HARD:
            cg = pc['ga']
        else:
            cg = pc['ga'] * T.aggregate_backward(tid, pc['fa'], frag,
                                                 par[P_TCP])
        cg = jnp.where(valid, cg, 0.0)
        gz, tex_coef, ti = [], None, None
        if mode == 'hard':
            # the pixels this face won (cu:998-1004) send their colour
            # gradient to what the forward sampled there, weighted by the
            # raw barycentrics _hard_rgb_sample uses
            win = inside & (pc['fid'] == f.astype(jnp.float32))
            tex_coef = [jnp.where(win, pc[f'gr{c}'], 0.0) for c in range(3)]
            wt = q['w']
        elif softmax:
            # softmax RGB chain (cu:1006-1029)
            cmask = valid & q['zvalid'] & q['front_ok']
            zp_norm = (par[P_FAR] - q['zp']) / (par[P_FAR] - par[P_NEAR])
            zps = jnp.where(
                cmask, frag * jnp.exp((jnp.where(cmask, zp_norm, NEG_INF)
                                       - pc['a1']) / gamma) / pc['a0'], 0.0)
            cols = _colors(packed_ref, b, f, row, q, cfg, TS)
            c_xyz = (pc['gr0'] * (cols[0] - pc['fr0'])
                     + pc['gr1'] * (cols[1] - pc['fr1'])
                     + pc['gr2'] * (cols[2] - pc['fr2'])) * zps
            tex_coef = [zps * pc[f'gr{c}'] for c in range(3)]
            cg = cg + jnp.where(cmask, c_xyz / jnp.where(cmask, frag, 1.0),
                                0.0)
            c_z = c_xyz / gamma / (par[P_NEAR] - par[P_FAR]) \
                * q['zp'] * q['zp']
            # w_clip_j / z_j^2 == wcn_j * iz_j^2 (cu:1027-1029)
            gz = [jnp.where(cmask, c_z * q['wcn'][j]
                            * (row(pack.R_IZ + j) ** 2), 0.0)
                  for j in range(3)]
            wt = q['wcn']
        if surface_blocks:
            ti = _texel_index_from_w(wt[0], wt[1], TS)

        # distance chain (cu:1034-1052)
        pdf_v = D.pdf(cfg.dist_func, q['sign'], q['dis'], par[P_SCALE],
                      par[P_SHAPE], par[P_SHIFT], gamma_inv=par[P_GINV])
        cg = jnp.where(valid, cg * pdf_v, 0.0)
        if cfg.dist_squared:
            coef = 2.0 * q['sign'] * cg
        else:
            # |(dis_x, dis_y)| == dis by construction, so the direction
            # normalization reuses the rsqrt that produced dis
            coef = q['sign'] * cg * q['rdis']
        cx = coef * q['dis_x']
        cy = coef * q['dis_y']
        geom = []
        for w in tw_from_ksel(q['ksel'], q['tv']):
            geom += [cx * w, cy * w]
        geom += gz
        lane_tex = []
        if tex_coef is not None and not surface_blocks:
            if cfg.texture_type == C.TEXTURE_VERTEX:
                lane_tex = [wt[j] * tex_coef[c]
                            for j in range(3) for c in range(3)]
            else:
                lane_tex = tex_coef
        return geom + lane_tex, tex_coef, ti

    def texel_sums(tex_coef, ti, blk):
        """(TB,) per-channel sums of tex_coef over the pixels whose texel
        falls in block blk (backward_sample_texture, cu:197-207)."""
        tix = blk * TB + jnp.arange(TB, dtype=jnp.int32)
        onehot = ti[:, None] == tix[None, :]
        return [jnp.sum(jnp.where(onehot, c[:, None], 0.0), axis=0)
                for c in tex_coef]

    def tile_pass(blk, with_lanes):
        """Walk the chunk's hit tiles once; accumulate the per-pixel terms
        (with_lanes) and texel block blk's sums (surface textures)."""
        zero = jnp.zeros((tiles.tp,), jnp.float32)
        zb = jnp.zeros((TB,), jnp.float32)
        init = ([zero] * (n_geom + n_lane_tex) if with_lanes else []) \
            + ([zb] * 3 if surface_blocks else [])

        def body(j, acc):
            t = ids_ref[b, k, j]

            def hit(acc):
                lanes, tex_coef, ti = pair_terms(t)
                out = ([a + v for a, v in zip(acc, lanes)]
                       if with_lanes else [])
                if surface_blocks:
                    out += [a + v for a, v in zip(
                        acc[len(out):], texel_sums(tex_coef, ti, blk))]
                return tuple(out)

            return jax.lax.cond(
                tiles.overlaps(t, row0, row, par[P_MARGIN]), hit,
                lambda a: a, acc)

        return jax.lax.fori_loop(0, n, body, tuple(init))

    def store_texels(blk, sums):
        tix = blk * TB + jnp.arange(TB, dtype=jnp.int32)
        for c in range(3):
            plt.store(out_ref.at[b, f, n_geom + 3 * tix + c], sums[c],
                      mask=tix < TS)

    acc = tile_pass(0, True)
    for i in range(n_geom + n_lane_tex):
        out_ref[b, f, i] = jnp.sum(acc[i])
    if surface_blocks:
        store_texels(0, acc[n_geom + n_lane_tex:])
        if nblk > 1:
            def blk_body(blk, carry):
                store_texels(blk, tile_pass(blk, False))
                return carry

            jax.lax.fori_loop(1, nblk, blk_body, ())


def _pixel_columns(cfg, soft_colors, aggrs_info, grad_soft_colors, P,
                   base_offset):
    """[B, NC, P] stack of the pixel-space columns the backward reads (the
    _PIX_COLS_* of its RGB mode)."""
    B = soft_colors.shape[0]
    g = grad_soft_colors.reshape(B, 4, P)
    fin = soft_colors.reshape(B, 4, P)
    aggr = aggrs_info.reshape(B, 2, P)
    mode = _rgb_mode(cfg)
    if mode == 'alpha':
        return jnp.stack([g[:, 3], fin[:, 3]], axis=1)
    if mode == 'hard':
        # winner ids are in sorted space + base_offset; shift them back to
        # this shard's own sorted space, where other shards' winners fall
        # outside [0, Fp) and match no face
        fid = aggr[:, 1:2]
        if base_offset is not None:
            fid = fid - jnp.float32(base_offset)
        return jnp.concatenate([g[:, 3:4], fin[:, 3:4], g[:, :3], fid],
                               axis=1)
    return jnp.concatenate([g, fin, aggr], axis=1)


def backward(face_vertices, textures, finfo, soft_colors, aggrs_info,
             grad_soft_colors, cfg: C.RenderConfig, params: Dict,
             base_offset=0, fvalid=None, row_band=None):
    """Same contract as xla_backend.backward."""
    del finfo
    return backward_from_aux(face_vertices, textures, None, soft_colors,
                             aggrs_info, grad_soft_colors, cfg, params,
                             base_offset, fvalid, row_band)


def backward_from_aux(face_vertices, textures, aux, soft_colors,
                      aggrs_info, grad_soft_colors, cfg: C.RenderConfig,
                      params: Dict, base_offset=0, fvalid=None,
                      row_band=None):
    B, F = face_vertices.shape[:2]
    TS = textures.shape[2]
    is_ = cfg.image_size
    row0, hb = row_band if row_band is not None else (0, is_)
    P = is_ * hb
    if aux is None:
        aux = _prepass(face_vertices, textures, cfg, params, fvalid,
                       row_band)
    packed, iperm = aux['packed'], aux['iperm']
    Fp = packed.shape[1]
    mode = _rgb_mode(cfg)
    NTEX = _bwd_tex_cols(cfg, TS)
    n_geom = 9 if mode == 'softmax' else 6
    tiles = _Tiles(cfg, hb)
    kernel = functools.partial(_bwd_kernel, cfg=cfg, tiles=tiles,
                               FC=cfg.face_chunk, TS=TS, NTEX=NTEX)
    out = pl.pallas_call(
        kernel,
        grid=(B, Fp),
        out_shape=jax.ShapeDtypeStruct((B, Fp, n_geom + NTEX), jnp.float32),
        backend='triton',
        compiler_params=_compiler_params(tiles.tp),
        interpret=_interpret(),
        name='gendr_raster_bwd',
    )(aux['chunk_counts'], aux['chunk_ids'], _params_vec(params, row0, cfg),
      packed, _pixel_columns(cfg, soft_colors, aggrs_info, grad_soft_colors,
                             P, base_offset))

    # un-permute: the grad of original face j sits at sorted row iperm[j]
    out = jnp.take_along_axis(out, iperm[..., None], axis=1)[:, :F]
    # [x0 y0 x1 y1 x2 y2] (+ [z0 z1 z2]) -> [B, F, 9]
    gxy = out[..., :6].reshape(B, F, 3, 2)
    if mode == 'softmax':
        gzv = out[..., 6:9, None]
    else:
        gzv = jnp.zeros((B, F, 3, 1), jnp.float32)
    grad_faces = jnp.concatenate([gxy, gzv], axis=-1).reshape(B, F, 9)
    if mode == 'alpha':
        grad_tex = jnp.zeros(textures.shape, jnp.float32)
    else:
        grad_tex = out[..., n_geom:].reshape((B, F) + textures.shape[2:])
    return grad_faces, grad_tex


# ---------------------------------------------------------------------------
# Prepass
# ---------------------------------------------------------------------------

def _sorted_faces(face_vertices, textures, F, FC, fvalid_in=None):
    """Pad to a chunk multiple and Morton-sort faces by projected bbox
    center (tight chunk bboxes make the tile x chunk cull selective).

    Returns (fv, tex, fvalid, perm) where sorted[i] = orig[perm[i]].
    Deterministic given the inputs, so forward and backward compute the
    identical permutation.  Face *order* only affects exact-tie resolution
    in the hard-RGB z-argmin (cu:816's strict <): sorted order resolves such
    ties by Morton rank instead of input rank.

    ``fvalid_in`` ([F] bool, optional) marks externally-padded faces (the
    face-sharded path pads globally before slicing per shard); they sort to
    the end like local padding and contribute nothing.
    """
    B = face_vertices.shape[0]
    Fp = -(-F // FC) * FC
    fv = jnp.asarray(face_vertices, jnp.float32)
    tex = jnp.asarray(textures, jnp.float32)
    if Fp != F:
        fv = jnp.pad(fv, ((0, 0), (0, Fp - F), (0, 0)))
        tex = jnp.pad(tex, ((0, 0), (0, Fp - F), (0, 0), (0, 0)))
    fvalid = jnp.arange(Fp) < F
    if fvalid_in is not None:
        fvalid = fvalid & jnp.pad(jnp.asarray(fvalid_in, bool),
                                  (0, Fp - F))

    xs = fv[..., 0::3]
    ys = fv[..., 1::3]
    cx = 0.5 * (jnp.min(xs, -1) + jnp.max(xs, -1))
    cy = 0.5 * (jnp.min(ys, -1) + jnp.max(ys, -1))
    qx = jnp.clip((cx + 1.0) * 512.0, 0, 1023).astype(jnp.int32)
    qy = jnp.clip((cy + 1.0) * 512.0, 0, 1023).astype(jnp.int32)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    key = spread(qx) | (spread(qy) << 1)
    key = jnp.where(fvalid[None, :], key, jnp.int32(0x7FFFFFFF))
    perm = jnp.argsort(key, axis=1)  # [B, Fp]

    fv = jnp.take_along_axis(fv, perm[..., None], axis=1)
    tex = jnp.take_along_axis(tex, perm[..., None, None], axis=1)
    # validity travels with the sort when invalid faces can sit in the
    # middle of the input (per-batch sorted order)
    fvalid = jnp.take_along_axis(
        jnp.broadcast_to(fvalid[None, :], (B, Fp)), perm, axis=1)
    return fv, tex, fvalid, perm


def _prepass(face_vertices, textures, cfg: C.RenderConfig, params: Dict,
             fvalid_in=None, row_band=None):
    """Sort, pack, and build the hit lists once; shared by fwd and bwd.
    ``row_band=(row0, height)`` builds the lists for that image row band
    only (pixel-sharded path).  aux['packed'] is face-major [B, Fp, NI]:
    one face's constants are contiguous, as the kernels read them."""
    B, F = face_vertices.shape[:2]
    is_ = cfg.image_size
    row0, hb = row_band if row_band is not None else (0, is_)
    FC = cfg.face_chunk
    tile_w, tile_h = _tile_shape(cfg)
    fv, tex, fvalid, perm = _sorted_faces(face_vertices, textures, F, FC,
                                          fvalid_in)
    packed = pack.pack_faces(fv, tex, fvalid, cfg)
    mask = pack.tile_chunk_mask(packed, is_, tile_w, tile_h, FC,
                                pack.cull_margin(cfg, params), height=hb,
                                row0=row0)
    tile_counts, tile_ids, chunk_counts, chunk_ids = pack.compact_hits(mask)
    # inverse permutation via scatter (an argsort here would re-sort every
    # backward step); iperm[b, perm[b, i]] = i
    Fp = perm.shape[1]
    iperm = jnp.zeros_like(perm).at[
        jnp.arange(B)[:, None], perm].set(
            jnp.broadcast_to(jnp.arange(Fp, dtype=perm.dtype)[None, :],
                             perm.shape))
    return dict(packed=packed.transpose(0, 2, 1), perm=perm, iperm=iperm,
                tile_counts=tile_counts, tile_ids=tile_ids,
                chunk_counts=chunk_counts, chunk_ids=chunk_ids)


# ---------------------------------------------------------------------------
# Forward entry points and epilogues
# ---------------------------------------------------------------------------

def forward(face_vertices, textures, finfo, cfg: C.RenderConfig,
            params: Dict):
    """Same contract as xla_backend.forward."""
    del finfo  # the kernels use their own packed constants
    soft, aggrs, _ = forward_with_aux(face_vertices, textures, cfg, params)
    return soft, aggrs


def forward_with_aux(face_vertices, textures, cfg: C.RenderConfig,
                     params: Dict, aux=None):
    out, aux = _fwd_kernel_out(face_vertices, textures, cfg, params, aux)
    soft_colors, aggrs_info = _finalize_soa(out, cfg, params, aux['packed'],
                                            TS=textures.shape[2])
    return soft_colors, aggrs_info, aux


def _pix_coords(is_, height=None, row0=0):
    """Row-major pixel-center NDC coords ([P], [P]) — identical to the
    kernels' in-tile formula (cu:716-719).  ``height``/``row0`` select an
    image row band; NDC stays global (row0 may be traced)."""
    h = is_ if height is None else height
    ii = jnp.arange(is_, dtype=jnp.float32)
    jj = row0 + jnp.arange(h, dtype=jnp.float32)
    xp1 = (2.0 * ii + 1.0 - is_) / is_
    yp1 = (2.0 * (is_ - 1.0 - jj) + 1.0 - is_) / is_
    return jnp.tile(xp1, (h,)), jnp.repeat(yp1, is_)


def _face_rows(packed, idx, r0, nr):
    """packed[b, idx[b, p], r0:r0+nr] -> [B, P, nr] (packed face-major)."""
    return jnp.take_along_axis(packed[:, :, r0:r0 + nr], idx[:, :, None],
                               axis=1)


def _winner_bary(packed, idx, is_, height=None, row0=0):
    """Barycentrics of each pixel's hard-RGB winner face ([B, P] x3).
    Winners are inside-loose (cu:815-822), where the raw affine
    barycentrics are already clipped and normalized."""
    rows = _face_rows(packed, idx, pack.R_INV, 9)
    xp, yp = _pix_coords(is_, height, row0)
    w0 = rows[..., 0] * xp + rows[..., 1] * yp + rows[..., 2]
    w1 = rows[..., 3] * xp + rows[..., 4] * yp + rows[..., 5]
    return w0, w1, 1.0 - w0 - w1


def _hard_rgb_sample(packed, fidx, cfg, TS, is_, height=None, row0=0):
    """Hard-RGB texture sampling (forward_sample_texture, cu:175-191) as an
    XLA epilogue: the kernel emits only the winning face id per pixel
    ([B, P] float, -1 = none); the colour is gathered from the packed texel
    rows here.  Returns [B, 3, P]; callers mask by ``fidx >= 0``."""
    Fp = packed.shape[1]
    idx = jnp.clip(fidx.astype(jnp.int32), 0, Fp - 1)
    if cfg.texture_type == C.TEXTURE_VERTEX:
        w0, w1, w2 = _winner_bary(packed, idx, is_, height, row0)
        tex = _face_rows(packed, idx, pack.R_TEX, 9)  # [B, P, 9]
        return jnp.stack([w0 * tex[..., c] + w1 * tex[..., 3 + c]
                          + w2 * tex[..., 6 + c] for c in range(3)], axis=1)
    if TS == 1:
        return _face_rows(packed, idx, pack.R_TEX, 3).transpose(0, 2, 1)
    # surface TS > 1: per-pixel texel row id — one flat gather per channel
    w0, w1, _ = _winner_bary(packed, idx, is_, height, row0)
    ti = _texel_index_from_w(w0, w1, TS)
    B, _, NI = packed.shape
    flat = packed.reshape(B, Fp * NI)
    lin0 = idx * NI + pack.R_TEX + 3 * ti
    return jnp.stack([jnp.take_along_axis(flat, lin0 + c, axis=1)
                      for c in range(3)], axis=1)


def _finalize_soa(out, cfg: C.RenderConfig, params: Dict, packed, TS=1):
    """Background fold + finalize on the channel-major kernel output
    ([B, NO_F, P]) — semantics of X.background_carry + X.merge_carries +
    X.finalize, without leaving SoA layout (the final [B, 4, H, W] is a
    reshape)."""
    B, _, P = out.shape
    is_ = cfg.image_size
    bg = jnp.asarray(params['background_color'],
                     jnp.float32).reshape(1, 3, 1)
    alpha = out[:, 0:1]  # [B, 1, P]
    mode = _rgb_mode(cfg)
    if mode == 'alpha':
        rgb_final = jnp.broadcast_to(bg, (B, 3, P))
        aggr0 = jnp.full((B, 1, P), BIG_DEPTH, jnp.float32)
        aggr1 = jnp.full((B, 1, P), -1.0, jnp.float32)
    elif mode == 'hard':
        depth, fidx = out[:, 1:2], out[:, 2:3]
        rgb = _hard_rgb_sample(packed, out[:, 2], cfg, TS, is_)
        rgb_final = jnp.where(fidx >= 0, rgb, bg)
        aggr0, aggr1 = depth, fidx
    else:
        eps = params['aggr_rgb_eps']
        gamma = params['aggr_rgb_gamma']
        ssum_k, smax_k = out[:, 1:2], out[:, 2:3]
        # streaming-softmax merge with the background state
        # (smax_bg = eps, ssum_bg = exp(eps / gamma), rgb_bg = bg * ssum_bg)
        m = jnp.maximum(eps, smax_k)
        sa = jnp.exp((eps - m) / gamma)
        sb = jnp.exp((smax_k - m) / gamma)
        ssum = jnp.exp(eps / gamma) * sa + ssum_k * sb
        rgb = bg * (jnp.exp(eps / gamma) * sa) + out[:, 3:6] * sb
        rgb_final = rgb / ssum
        aggr0, aggr1 = ssum, m
    h = P // is_  # band height (== is_ for a full render)
    soft_colors = jnp.concatenate([rgb_final, alpha], axis=1) \
        .reshape(B, 4, h, is_)
    aggrs_info = jnp.concatenate([aggr0, aggr1], axis=1) \
        .reshape(B, 2, h, is_)
    return soft_colors, aggrs_info


def forward_partial(face_vertices, textures, cfg: C.RenderConfig,
                    params: Dict, aux=None, base_offset=0, fvalid=None,
                    row_band=None):
    """Run the forward kernel and return the per-pixel aggregation carry
    WITHOUT the background fold — an ``xla_backend.empty_carry``-compatible
    partial state, mergeable with ``X.merge_carries``.  This is what the
    face-sharded path (gendr_jax.parallel.sharding) calls per fp shard.

    ``base_offset`` globally offsets the recorded hard-RGB winner ids (they
    stay in this shard's Morton-sorted space plus the offset); ``fvalid``
    ([F] bool) marks externally-padded faces; ``row_band=(row0, height)``
    restricts the render to that image row band (pixel-sharded path).
    Returns (carry, aux).
    """
    out, aux = _fwd_kernel_out(face_vertices, textures, cfg, params, aux,
                               fvalid, row_band)
    alpha = out[:, 0]
    mode = _rgb_mode(cfg)
    no_depth = jnp.full_like(alpha, BIG_DEPTH)
    no_id = jnp.full_like(alpha, -1).astype(jnp.int32)
    if mode == 'alpha':
        # silhouette-only: identity state everywhere but alpha
        carry = (alpha, jnp.full_like(alpha, NEG_INF),
                 jnp.zeros_like(alpha),
                 jnp.zeros(alpha.shape + (3,), jnp.float32), no_depth, no_id)
    elif mode == 'hard':
        fidx = out[:, 2].astype(jnp.int32)
        row0, hb = row_band if row_band is not None else (0, None)
        rgb = _hard_rgb_sample(aux['packed'], out[:, 2], cfg,
                               textures.shape[2], cfg.image_size, hb, row0)
        # mask the gather's clamped id-0 colour on no-winner pixels
        rgb = jnp.where((fidx >= 0)[..., None], rgb.transpose(0, 2, 1), 0.0)
        if base_offset is not None:
            fidx = jnp.where(fidx >= 0, fidx + base_offset, fidx)
        carry = (alpha, jnp.full_like(alpha, NEG_INF),
                 jnp.zeros_like(alpha), rgb, out[:, 1], fidx)
    else:
        carry = (alpha, out[:, 2], out[:, 1],
                 out[:, 3:6].transpose(0, 2, 1), no_depth, no_id)
    return carry, aux
