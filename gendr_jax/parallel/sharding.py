"""Multi-chip scaling via jax.sharding: data-parallel batch + face-parallel
+ pixel-parallel rendering.

The reference has **no** distributed support of any kind (SURVEY.md §2.4 —
single process, single GPU, NCCL/MPI absent).  This module is the scaling
layer in its place:

* **Batch DP** — silhouette losses are per-image, so batch sharding needs no
  cross-device communication except the gradient all-reduce pjit inserts
  automatically.
* **Face-axis parallelism (fp)** — for very large meshes, faces are sharded
  across devices; each device folds its face shard into a partial
  aggregation carry (associative t-conorm / streaming logsumexp / indexed
  z-argmin) and carries are merged with an ``all_gather`` in transformed
  space under ``shard_map``.  This is exactly the ring-attention trick
  applied to rasterization.
* **Pixel-axis parallelism (sp)** — for very large images, each device
  renders a horizontal row band (NDC coordinates stay global, so the band
  is bit-identical to the same rows of a full render — embarrassingly
  parallel forward, SURVEY.md §2.4).  Backward needs one ``psum`` of the
  face/texture gradients over sp.  Composes with dp and fp into a 3-axis
  mesh.

Typical use:

    mesh = make_mesh({'dp': 2, 'fp': 2, 'sp': 2})
    out = render_sharded(face_vertices, textures, cfg, params, mesh)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gendr_jax import config as C
from gendr_jax.raster import xla_backend as X


def _resolve_backend(cfg: C.RenderConfig, backend=None) -> str:
    """Which local per-shard engine to run: ``backend`` if given, else the
    config's own (the platform's, see raster.render.backend_name)."""
    from gendr_jax.raster.render import backend_name
    return backend or backend_name(cfg)


def _local_forward_carry(backend, fv_l, tex_l, fvalid_l, cfg, params,
                         base_offset, P_pix, axes, row_band=None):
    """Partial aggregation carry for one (fp, sp) shard (no background).
    ``row_band=(row0, height)`` is the sp shard's image row band."""
    if backend == 'pallas':
        from gendr_jax.raster import pallas_backend as PB
        carry, _ = PB.forward_partial(fv_l, tex_l, cfg, params,
                                      base_offset=base_offset,
                                      fvalid=fvalid_l, row_band=row_band)
        return carry
    b_l = fv_l.shape[0]
    carry0 = jax.tree_util.tree_map(
        lambda x: jax.lax.pcast(x, tuple(a for a in axes if a),
                                to='varying'),
        X.empty_carry(b_l, P_pix, cfg))
    return X.forward_carry(fv_l, tex_l, None, fvalid_l, carry0, cfg,
                           params, base_offset=base_offset,
                           row_band=row_band)


def _local_backward(backend, fv_l, tex_l, fvalid_l, soft_l, aggr_l, g_l,
                    cfg, params, base_offset, row_band=None):
    if backend == 'pallas':
        from gendr_jax.raster import pallas_backend as PB
        return PB.backward(fv_l, tex_l, None, soft_l, aggr_l, g_l, cfg,
                           params, base_offset=base_offset, fvalid=fvalid_l,
                           row_band=row_band)
    return X.backward(fv_l, tex_l, None, soft_l, aggr_l, g_l, cfg,
                      params, base_offset=base_offset, row_band=row_band)


def make_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """Build a Mesh from an axis-name -> size dict, e.g. {'dp': 4, 'fp': 2}."""
    if devices is None:
        devices = jax.devices()
    sizes = list(axes.values())
    n = int(np.prod(sizes))
    assert n <= len(devices), (n, len(devices))
    dev = np.array(devices[:n]).reshape(sizes)
    return Mesh(dev, tuple(axes.keys()))


def shard_batch(tree, mesh: Mesh, axis: str = 'dp'):
    """Place a pytree with its leading (batch) axis sharded over ``axis``."""
    spec = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, spec), tree)


def _pad_to(x, n, axis):
    need = n - x.shape[axis]
    if need == 0:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, need)
    return jnp.pad(x, pads)


def _axis_index(axis):
    """This shard's index along ``axis`` (0 when the axis is absent)."""
    return jax.lax.axis_index(axis) if axis else 0


def _gather_carries(carry, fp_axis):
    """Every fp shard's carry, stacked on a leading axis."""
    if not fp_axis:
        return jax.tree_util.tree_map(lambda x: x[None], carry)
    return jax.lax.all_gather(carry, fp_axis)


def _band(sp_axis, n_sp, is_):
    """(row0, height) of this sp shard's image row band (traced row0), or
    None when the pixel axis is unsharded."""
    if not sp_axis or n_sp == 1:
        return None
    hb = is_ // n_sp
    return (jax.lax.axis_index(sp_axis) * hb, hb)


def render_sharded(face_vertices, textures, cfg: C.RenderConfig,
                   params: Dict, mesh: Mesh, dp_axis: Optional[str] = 'dp',
                   fp_axis: Optional[str] = 'fp',
                   sp_axis: Optional[str] = None, backend=None,
                   check_replication: bool = False):
    """Forward render with batch sharded over ``dp_axis``, faces over
    ``fp_axis``, and image rows over ``sp_axis``.  Returns soft_colors
    [B, 4, H, W] (sharded over dp x sp, replicated over fp).

    face_vertices: [B, F, 9]; textures: [B, F, TS, 3].  ``backend`` picks
    the per-shard engine ('pallas' kernels or 'xla' streaming scan);
    default the config's own.

    ``check_replication``: the production out_specs drop the fp axis, which
    requires ``check_vma=False`` (the vma checker cannot see that the
    all_gather + deterministic fold makes every fp shard's merged carry
    identical) — so a bug that made the carry genuinely device-varying
    would silently return shard 0's value.  With ``check_replication=True``
    the fp axis is exposed instead: returns [n_fp, B, 4, H, W] with one
    (claimed-identical) copy per fp shard, for tests to assert bitwise
    equality across axis 0.
    """
    from jax import shard_map

    B, F = face_vertices.shape[:2]
    is_ = cfg.image_size
    n_fp = mesh.shape[fp_axis] if fp_axis else 1
    n_sp = mesh.shape[sp_axis] if sp_axis else 1
    assert is_ % n_sp == 0, (is_, n_sp)
    P_loc = is_ * (is_ // n_sp)
    backend = _resolve_backend(cfg, backend)
    cf = cfg.face_chunk
    Fp = -(-F // (n_fp * cf)) * (n_fp * cf)

    face_vertices = _pad_to(jnp.asarray(face_vertices, jnp.float32), Fp, 1)
    textures = _pad_to(jnp.asarray(textures, jnp.float32), Fp, 1)
    fvalid = jnp.arange(Fp) < F

    in_specs = (P(dp_axis, fp_axis), P(dp_axis, fp_axis), P(fp_axis),
                P(dp_axis, sp_axis))
    out_specs = P(dp_axis, None, sp_axis)

    bg = jnp.broadcast_to(
        jnp.asarray(params['background_color'], jnp.float32).reshape(1, 1, 3),
        (B, is_ * is_, 3))

    def local_render(fv_local, tex_local, fvalid_local, bg_local):
        b_local = fv_local.shape[0]
        band = _band(sp_axis, n_sp, is_)
        carry = _local_forward_carry(
            backend, fv_local, tex_local, fvalid_local, cfg, params,
            _axis_index(fp_axis) * (Fp // n_fp), P_loc,
            (dp_axis, fp_axis) + ((sp_axis,) if band else ()), band)
        # merge partial carries across the face axis, in shard order, with
        # the background state folded in first (reference init order)
        gathered = _gather_carries(carry, fp_axis)  # leading axis n_fp
        merged = X.background_carry(b_local, P_loc, bg_local, cfg, params)
        for i in range(n_fp):
            part = jax.tree_util.tree_map(lambda x: x[i], gathered)
            merged = X.merge_carries(merged, part, cfg, params)
        soft_colors, _ = X.finalize(merged, cfg)
        if check_replication:
            return soft_colors[None]  # expose this shard's fp copy
        return soft_colors

    if check_replication:
        out_specs = P(fp_axis, dp_axis, None, sp_axis)
    fn = shard_map(local_render, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs, check_vma=False)
    return fn(face_vertices, textures, fvalid, bg)


def make_sharded_render(cfg: C.RenderConfig, mesh: Mesh, dp_axis='dp',
                        fp_axis='fp', sp_axis=None, backend=None):
    """Differentiable batch+face+pixel-sharded render with the reference
    gradient semantics (aggregate-inverse t-conorm backward etc.).

    The backward runs under the same shard_map: every fp shard computes the
    gradients of its own faces from the final aggregates — no cross-device
    reduction for grad_faces over fp (they are face-sharded); when the
    pixel axis is sharded each sp shard contributes its band's gradients
    and one ``psum`` over sp completes them.  The dp gradient all-reduce
    for model parameters is inserted by XLA outside this function.

    ``backend`` picks the per-shard engine ('pallas' kernels or 'xla'
    streaming scan); default the config's own.  The fp-shard carry merge is
    backend-agnostic, so the kernels run unchanged under sharding.
    """
    from jax import shard_map
    import functools

    n_fp = mesh.shape[fp_axis] if fp_axis else 1
    n_sp = mesh.shape[sp_axis] if sp_axis else 1
    is_ = cfg.image_size
    assert is_ % n_sp == 0, (is_, n_sp)

    def _prepare(face_vertices, textures):
        B, F = face_vertices.shape[:2]
        cf = cfg.face_chunk
        Fp = -(-F // (n_fp * cf)) * (n_fp * cf)
        fv = _pad_to(jnp.asarray(face_vertices, jnp.float32), Fp, 1)
        tex = _pad_to(jnp.asarray(textures, jnp.float32), Fp, 1)
        fvalid = jnp.arange(Fp) < F
        return fv, tex, fvalid, B, F, Fp

    @functools.partial(jax.custom_vjp, nondiff_argnums=())
    def render_fn(face_vertices, textures, params):
        out, _ = _fwd_impl(face_vertices, textures, params)
        return out

    def _fwd_impl(face_vertices, textures, params):
        backend_r = _resolve_backend(cfg, backend)
        fv, tex, fvalid, B, F, Fp = _prepare(face_vertices, textures)
        P_loc = is_ * (is_ // n_sp)
        bg = jnp.broadcast_to(
            jnp.asarray(params['background_color'],
                        jnp.float32).reshape(1, 1, 3), (B, is_ * is_, 3))

        def local_fwd(fv_l, tex_l, fvalid_l, bg_l):
            b_l = fv_l.shape[0]
            band = _band(sp_axis, n_sp, is_)
            carry = _local_forward_carry(
                backend_r, fv_l, tex_l, fvalid_l, cfg, params,
                _axis_index(fp_axis) * (Fp // n_fp), P_loc,
                (dp_axis, fp_axis) + ((sp_axis,) if band else ()), band)
            gathered = _gather_carries(carry, fp_axis)
            merged = X.background_carry(b_l, P_loc, bg_l, cfg, params)
            for i in range(n_fp):
                part = jax.tree_util.tree_map(lambda x: x[i], gathered)
                merged = X.merge_carries(merged, part, cfg, params)
            return X.finalize(merged, cfg)

        soft_colors, aggrs = shard_map(
            local_fwd, mesh=mesh,
            in_specs=(P(dp_axis, fp_axis), P(dp_axis, fp_axis), P(fp_axis),
                      P(dp_axis, sp_axis)),
            # the merged carry is identical on every fp shard (all_gather +
            # deterministic fold), which the vma checker cannot infer
            out_specs=(P(dp_axis, None, sp_axis),
                       P(dp_axis, None, sp_axis)), check_vma=False)(
                fv, tex, fvalid, bg)
        return soft_colors, (fv, tex, fvalid, soft_colors, aggrs, params)

    def _fwd(face_vertices, textures, params):
        out, res = _fwd_impl(face_vertices, textures, params)
        return out, (res, face_vertices.shape[1], textures.shape[1])

    def _bwd(resF, g):
        (fv, tex, fvalid, soft_colors, aggrs, params), F, Ft = resF
        # statically re-derivable from cfg; residuals must stay pure JAX
        # types
        backend_r = _resolve_backend(cfg, backend)

        def local_bwd(fv_l, tex_l, fvalid_l, soft_l, aggr_l, g_l):
            fp_local = fv_l.shape[1]
            band = _band(sp_axis, n_sp, is_)
            gf_l, gt_l = _local_backward(
                backend_r, fv_l, tex_l, fvalid_l, soft_l, aggr_l, g_l,
                cfg, params,
                base_offset=_axis_index(fp_axis) * fp_local,
                row_band=band)
            if band is not None:
                # each sp shard saw only its row band's pixels
                gf_l, gt_l = jax.lax.psum((gf_l, gt_l), sp_axis)
            return gf_l, gt_l

        gf, gt = shard_map(
            local_bwd, mesh=mesh,
            in_specs=(P(dp_axis, fp_axis), P(dp_axis, fp_axis), P(fp_axis),
                      P(dp_axis, None, sp_axis), P(dp_axis, None, sp_axis),
                      P(dp_axis, None, sp_axis)),
            out_specs=(P(dp_axis, fp_axis), P(dp_axis, fp_axis)),
            check_vma=False)(fv, tex, fvalid, soft_colors, aggrs, g)
        zero_params = jax.tree_util.tree_map(jnp.zeros_like, params)
        return gf[:, :F], gt[:, :Ft], zero_params

    render_fn.defvjp(_fwd, _bwd)
    return render_fn
