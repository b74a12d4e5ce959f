"""T-conorm zoo: 9 soft OR operators for alpha-channel aggregation.

``fold_step`` is the binary t-conorm used in the streaming fold over faces
(forward); ``aggregate_backward`` is the reference's aggregate-inverse
gradient rule: the derivative of ``A = ⊥(b_1..b_n)`` w.r.t. ``b_i`` is
reconstructed from the *total* aggregate ``A`` and ``b_i`` alone, so no
per-face partial products are ever stored.  This matters: naive autodiff
through a sequential fold would yield prefix-product gradients instead.

Formulas mirror the reference CUDA implementation exactly, including every
``max(..., 1e-6)`` guard (one deliberate reformulation: frank's
``p**(1-a) - 1`` terms are computed as ``_expm1((1-a) * log(p))`` — the
same function, without the powf cancellation at the a -> 1 saturation
edge; see ``_expm1``):

* forward:  ``gendr/cuda/generalized_renderer_cuda_kernel.cu:473-563``
* backward: ``gendr/cuda/generalized_renderer_cuda_kernel.cu:566-614``

All ops are elementwise jnp; the t-conorm id is static so only one branch is
traced.  Folding with ``b = 0`` is the identity for every t-conorm here,
which is what makes masked (culled) faces drop out of the aggregation.
"""

from __future__ import annotations

import jax.numpy as jnp

from gendr_jax import config as C


def _p(v):
    return jnp.asarray(v, jnp.float32)


def _expm1(x):
    """expm1 from exp and a Taylor series (no jnp.expm1 in the kernels).

    frank needs ``p**(1-a) - 1`` with ``a`` exactly/nearly saturated at 1
    (compact-support CDFs saturate exactly), where the naive
    ``jnp.power(p, 1-a) - 1.0`` cancels catastrophically: the ~1-ulp
    rounding of pow near 1 becomes O(1) *relative* error of the difference,
    and — worse for the twin-backend design — two compilers may round pow
    differently, so the two backends disagree by that amplified amount.

    |x| < 0.34: 7-term Taylor in Horner form (f32 relative error a few
    1e-7, measured <= ~3.3e-7 at the branch edge);
    else exp(x) - 1, where the subtraction loses < ~2 ulp.  Both branches
    are well-conditioned, so backend disagreement stays at the ~1e-7
    relative level of their exp implementations.
    """
    x = jnp.asarray(x, jnp.float32)
    taylor = x * (1.0 + x * (0.5 + x * (1.0 / 6.0 + x * (1.0 / 24.0
             + x * (1.0 / 120.0 + x * (1.0 / 720.0 + x * (1.0 / 5040.0)))))))
    return jnp.where(jnp.abs(x) < 0.34, taylor, jnp.exp(x) - 1.0)


def _zero_identity(a, b, res):
    """Exact neutral-element fold: a ⊥ 0 = a and 0 ⊥ b = b, bitwise.

    0 is the neutral element of every t-conorm, but the parametric
    families' arithmetic only reproduces it up to rounding (e.g. frank's
    log1p(expm1(t)) round trip, yager's pow round trip).  Exactness
    matters for backend parity: the Pallas kernels SKIP culled faces via
    per-tile hit lists while the XLA scan folds their zero coverage, and
    the scan's butterfly folds zero-padded lanes — with the exact identity,
    zeros vanish from every fold and both backends aggregate the same
    nonzero values.
    """
    return jnp.where(b == 0.0, a, jnp.where(a == 0.0, b, res))


def fold_step(t_conorm_id: int, a, b, p=0.0):
    """a ⊥ b for the selected t-conorm (cu:473-563)."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)

    if t_conorm_id == C.MAX_TCN:
        return jnp.maximum(a, b)

    if t_conorm_id == C.PROBABILISTIC_TCN:
        return a + b - a * b

    if t_conorm_id == C.EINSTEIN_TCN:
        return (a + b) / (1.0 + a * b)

    if t_conorm_id == C.HAMACHER_TCN:  # p >= 0
        p = _p(p)
        an, bn = 1.0 - a, 1.0 - b
        c = (an * bn) / jnp.maximum(p + (1.0 - p) * (an + bn - an * bn), 1e-6)
        return _zero_identity(a, b, 1.0 - c)

    if t_conorm_id == C.FRANK_TCN:  # p > 0, p != 1
        # cu:506-511 computes (p^(1-a)-1)(p^(1-b)-1)/(p-1) with powf;
        # mathematically identical, this uses expm1((1-a) ln p) instead —
        # see _expm1 for why (saturation-edge conditioning + backend parity)
        p = _p(p)
        lnp = jnp.log(p)
        ea = _expm1((1.0 - a) * lnp)
        eb = _expm1((1.0 - b) * lnp)
        c = jnp.log1p(ea * eb / (p - 1.0)) / lnp
        return _zero_identity(a, b, 1.0 - c)

    if t_conorm_id == C.YAGER_TCN:  # p > 0
        p = _p(p)
        c = jnp.maximum(
            0.0, 1.0 - jnp.power(jnp.power(a, p) + jnp.power(b, p), 1.0 / p))
        return _zero_identity(a, b, 1.0 - c)

    if t_conorm_id == C.ACZEL_ALSINA_TCN:  # p > 0
        p = _p(p)
        an, bn = 1.0 - a, 1.0 - b
        an_s = jnp.maximum(an, 1e-30)
        bn_s = jnp.maximum(bn, 1e-30)
        c = jnp.exp(-jnp.power(
            jnp.power(-jnp.log(an_s), p) + jnp.power(-jnp.log(bn_s), p),
            1.0 / p))
        # cu:528-529: if 1-a < 1e-8 (or 1-b) the result saturates to 1
        res = jnp.where((an < 1e-8) | (bn < 1e-8), 1.0, 1.0 - c)
        return _zero_identity(a, b, res)

    if t_conorm_id == C.DOMBI_TCN:  # p > 0
        p = _p(p)
        an, bn = 1.0 - a, 1.0 - b
        an_s = jnp.maximum(an, 1e-30)
        bn_s = jnp.maximum(bn, 1e-30)
        c = 1.0 / (1.0 + jnp.power(
            jnp.power((1.0 - an_s) / an_s, p)
            + jnp.power((1.0 - bn_s) / bn_s, p), 1.0 / p))
        res = jnp.where((an < 1e-8) | (bn < 1e-8), 1.0, 1.0 - c)
        return _zero_identity(a, b, res)

    if t_conorm_id == C.SCHWEIZER_SKLAR_TCN:  # p < 0
        p = _p(p)
        an = jnp.maximum(1.0 - a, 1e-30)
        bn = jnp.maximum(1.0 - b, 1e-30)
        c = jnp.power(jnp.power(an, p) + jnp.power(bn, p) - 1.0, 1.0 / p)
        return _zero_identity(a, b, 1.0 - c)

    raise ValueError(f'unknown t_conorm id: {t_conorm_id}')


def aggregate_backward(t_conorm_id: int, a_all, b, p=0.0):
    """dA/db_i reconstructed from the total aggregate (cu:566-614)."""
    a_all = jnp.asarray(a_all, jnp.float32)
    b = jnp.asarray(b, jnp.float32)

    if t_conorm_id == C.MAX_TCN:
        # exact float equality, as in the reference (cu:574-575)
        return jnp.where(a_all == b, 1.0, 0.0)

    if t_conorm_id == C.PROBABILISTIC_TCN:
        return (1.0 - a_all) / jnp.maximum(1.0 - b, 1e-6)

    if t_conorm_id == C.EINSTEIN_TCN:
        return (1.0 - a_all * a_all) / jnp.maximum(1.0 - b * b, 1e-6)

    if t_conorm_id == C.HAMACHER_TCN:
        p = _p(p)
        num = (1.0 - a_all) * (-a_all - p * (1.0 - a_all) + p + 1.0)
        den = (1.0 - b) * (-b - p * (1.0 - b) + p + 1.0)
        return num / jnp.maximum(den, 1e-6)

    if t_conorm_id == C.FRANK_TCN:
        # cu:586-589's powf differences, via _expm1 (same guard scale)
        p = _p(p)
        lnp = jnp.log(p)
        d = _expm1((1.0 - b) * lnp)
        d_guard = d + jnp.where(d >= 0, 1e-6, -1e-6)  # copysign(1e-6, d)
        return jnp.exp((a_all - b) * lnp) * _expm1((1.0 - a_all) * lnp) \
            / d_guard

    if t_conorm_id == C.YAGER_TCN:
        p = _p(p)
        b_s = jnp.maximum(b, 1e-30)
        a_s = jnp.maximum(a_all, 1e-30)
        val = jnp.power(b_s, p - 1.0) * jnp.power(a_s, 1.0 - p)
        return jnp.where(a_all == 1.0, 0.0, val)

    if t_conorm_id == C.ACZEL_ALSINA_TCN:
        p = _p(p)
        log_b = -jnp.log1p(jnp.maximum(-b, -1.0 + 1e-6))
        log_a = -jnp.log1p(jnp.maximum(-a_all, -1.0 + 1e-6))
        return (1.0 - a_all) \
            * jnp.power(jnp.maximum(log_b, 1e-30), p - 1.0) \
            * jnp.power(jnp.maximum(log_a, 1e-30), 1.0 - p) \
            / jnp.maximum(1.0 - b, 1e-6)

    if t_conorm_id == C.DOMBI_TCN:
        p = _p(p)
        bn = jnp.maximum(1.0 - b, 1e-6)
        an = jnp.maximum(1.0 - a_all, 1e-6)
        b_s = jnp.maximum(b, 1e-30)
        a_s = jnp.maximum(a_all, 1e-30)
        return (1.0 - a_all) * (1.0 - a_all) \
            * jnp.power(b_s / bn, p - 1.0) \
            * jnp.power(a_s / an, 1.0 - p) \
            / bn / bn

    if t_conorm_id == C.SCHWEIZER_SKLAR_TCN:
        p = _p(p)
        an = jnp.maximum(1.0 - a_all, 1e-6)
        bn = jnp.maximum(1.0 - b, 1e-6)
        bp = jnp.power(bn, p)
        ap = jnp.power(an, p)
        inner = jnp.power(jnp.power(-bp + ap + 1.0, 1.0 / p), p)
        return jnp.power(bn, p - 1.0) \
            * jnp.power(bp + inner - 1.0, (1.0 - p) / p)

    raise ValueError(f'unknown t_conorm id: {t_conorm_id}')


# -- scalar verification seam (mirrors the reference's pybind scalar exports,
#    generalized_renderer_cuda.cpp:211-237) ---------------------------------

def t_conorm_forward(t_conorm_id, a_existing, b_new, face_id=0, t_conorm_p=0.0):
    return float(fold_step(int(t_conorm_id), a_existing, b_new, t_conorm_p))


def t_conorm_backward(t_conorm_id, a_all, b_current, number_of_faces=0,
                      t_conorm_p=0.0):
    return float(aggregate_backward(int(t_conorm_id), a_all, b_current,
                                    t_conorm_p))
