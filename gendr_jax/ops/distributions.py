"""The 18-distribution CDF/PDF zoo of the generalized differentiable renderer.

``cdf`` maps a signed pixel-to-face distance to a per-face coverage
probability ("soft fragment"); ``pdf`` is the derivative used by the custom
VJP.  The function ids and exact formulas (including every guard constant and
early-out threshold) mirror the reference CUDA implementation:

* forward:  ``gendr/cuda/generalized_renderer_cuda_kernel.cu:242-363``
* backward: ``gendr/cuda/generalized_renderer_cuda_kernel.cu:366-459``

All functions are pure elementwise jnp — they fuse into the surrounding
rasterization code (XLA fusion, or inlined in the Pallas kernels).
The distribution id is *static* so only one branch is ever traced.

Conventions (same as the reference):
  * ``x`` is the non-negative distance magnitude; ``sign`` is +1 inside the
    triangle, -1 outside.
  * ``scale`` is tau; ``shape``/``shift`` parametrize gamma/levy/exponential.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from gendr_jax import config as C

_PI = math.pi


def erfc(x):
    """Complementary error function, Abramowitz & Stegun 7.1.26 rational
    approximation (|eps| <= 1.5e-7 — below fp32 noise for the CDF range).

    Written with primitives every kernel lowering supports, and one
    implementation everywhere keeps the forward and the backward's coverage
    recomputation on the same operation sequence in both backends.
    """
    x = jnp.asarray(x, jnp.float32)
    ax = jnp.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    e = poly * jnp.exp(jnp.minimum(-ax * ax, 0.0))
    return jnp.where(x >= 0, e, 2.0 - e)


def _safe_exp(x):
    # exp with clipped input: keeps untaken jnp.where branches finite.
    return jnp.exp(jnp.clip(x, -87.0, 87.0))


def arctan(x):
    """Cephes-style atanf (range reduction + degree-7 odd polynomial,
    ~1 ulp fp32) — the same algorithm class as the CUDA ``atanf`` the
    reference's cauchy CDF calls (cu:258); written with primitives every
    kernel lowering supports."""
    x = jnp.asarray(x, jnp.float32)
    sgn = jnp.where(x < 0, -1.0, 1.0)
    ax = jnp.abs(x)
    big = ax > 2.414213562373095    # tan(3*pi/8)
    mid = (ax > 0.4142135623730950) & (~big)  # tan(pi/8)
    x1 = jnp.where(big, -1.0 / jnp.maximum(ax, 1e-30),
                   jnp.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    y0 = jnp.where(big, _PI / 2, jnp.where(mid, _PI / 4, 0.0))
    z = x1 * x1
    p = ((8.05374449538e-2 * z - 1.38776856032e-1) * z
         + 1.99777106478e-1) * z - 3.33329491539e-1
    return sgn * (y0 + x1 + x1 * z * p)


def arcsin(x):
    """arcsin via arctan(x * rsqrt(1 - x^2)) (clamped input).

    The rsqrt-multiply is deliberate: a compiler may rewrite
    ``x / sqrt(...)`` into a differently rounded form, while an explicit
    rsqrt lowers to the same op everywhere."""
    import jax.lax as lax
    x = jnp.clip(x, -1.0, 1.0)
    out = arctan(x * lax.rsqrt(jnp.maximum(1.0 - x * x, 1e-12)))
    return jnp.where(jnp.abs(x) >= 1.0, jnp.sign(x) * (_PI / 2), out)


def cdf(dist_func: int, sign, x, scale, shape=0.0, shift=0.0,
        gamma_inv1=None):
    """CDF of the selected distribution evaluated at sign*x with scale tau.

    Matches ``sigmoid_forward_cuda`` (cu:242-363) branch by branch.
    ``gamma_inv1`` optionally supplies 1/Gamma(shape+1) precomputed outside
    (the kernels take it as a parameter instead of calling lgamma).

    The u = sign*x/scale divides here stay DIVIDES deliberately: a
    precomputed-reciprocal multiply was tried (perf-neutral — the kernels
    are not slow-op-bound) and it made ``frag`` FMA-contraction-sensitive,
    i.e. no longer bitwise-identical across program variants that fuse
    differently (alpha-only vs rgba, forward vs backward-recompute) — which
    the max t-conorm backward's exact-equality winner detection requires.
    """
    sign = jnp.asarray(sign, jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    u = sign * x / scale

    if dist_func == C.HEAVISIDE:
        return jnp.where(sign > 0, 1.0, 0.0)

    if dist_func == C.LOGISTIC:
        return 1.0 / (1.0 + _safe_exp(-u))

    if dist_func == C.CAUCHY:
        return arctan(u) / _PI + 0.5

    if dist_func == C.RECIPROCAL:
        # cu:261 computes u/(1 + x/scale)/2 + 0.5 (denominator uses x, the
        # non-negative magnitude, not sign*x).  Algebraically identical with
        # ONE divide: 0.5*sign*x/(scale + x) + 0.5.  A multi-divide chain
        # leaves compilers more room to round differently, which flips
        # max-t-conorm exact-equality winners.
        return 0.5 * sign * x / (scale + x) + 0.5

    if dist_func == C.LAPLACE:
        e = 0.5 * _safe_exp(-x / scale)
        return jnp.where(sign < 0, e, 1.0 - e)

    if dist_func == C.UNIFORM:
        return jnp.clip(0.5 * u + 0.5, 0.0, 1.0)

    if dist_func == C.GUDERMANNIAN:
        return arctan(jnp.tanh(u / 2.0)) * 2.0 / _PI + 0.5

    if dist_func == C.CUBIC_HERMITE:
        y = jnp.clip(0.5 * u + 0.5, 0.0, 1.0)
        return 3.0 * y * y - 2.0 * y * y * y

    if dist_func == C.GAUSSIAN:
        # normcdf(u) = 0.5*erfc(-u/sqrt(2)) (cu:293)
        return 0.5 * erfc(-u / math.sqrt(2.0))

    if dist_func in (C.GAMMA, C.GAMMA_REV):
        return _gamma_cdf(dist_func, sign, x, scale, shape, shift,
                          gamma_inv1)

    if dist_func == C.WIGNER_SEMICIRCLE:
        # cu:320-327; in-branch |x| < scale so the sqrt argument is >= 0
        sq = jnp.sqrt(jnp.maximum(scale * scale - x * x, 0.0))
        mid = 0.5 + (sign * x * sq) / (_PI * scale * scale) \
            + arcsin(jnp.clip(u, -1.0, 1.0)) / _PI
        return jnp.where(u < -1.0, 0.0, jnp.where(u < 1.0, mid, 1.0))

    if dist_func == C.GUMBEL_MAX:
        return _safe_exp(-_safe_exp(-u))

    if dist_func == C.GUMBEL_MIN:
        return 1.0 - _safe_exp(-_safe_exp(u))

    if dist_func in (C.LEVY, C.LEVY_REV):
        if dist_func == C.LEVY:
            xs = sign * x + shift * scale
            lo = xs <= 1e-6
        else:
            xs = -(sign * x - shift * scale)
            lo = xs <= 1e-6  # cu:343: sign*x - shift*scale >= -1e-6
        xs_safe = jnp.maximum(xs, 1e-6)
        y = erfc(jnp.sqrt(scale / 2.0 / xs_safe))
        if dist_func == C.LEVY:
            return jnp.where(lo, 0.0, y)
        return jnp.where(lo, 1.0, 1.0 - y)

    if dist_func in (C.EXPONENTIAL, C.EXPONENTIAL_REV):
        if dist_func == C.EXPONENTIAL:
            xs = sign * x + shift * scale
            lo = xs < 0.0
        else:
            xs = -(sign * x - shift * scale)
            lo = xs < 0.0
        y = 1.0 - _safe_exp(-jnp.maximum(xs, 0.0) / scale)
        if dist_func == C.EXPONENTIAL:
            return jnp.where(lo, 0.0, y)
        return jnp.where(lo, 1.0, 1.0 - y)

    raise ValueError(f'unknown dist_func id: {dist_func}')


def _gamma_cdf(dist_func, sign, x, scale, shape, shift, gamma_inv1=None):
    """Regularized lower incomplete gamma via the same 32-term Kummer
    (confluent hypergeometric) series as the reference (cu:295-318):

        P(p, z) = z^p e^{-z} * sum_{i>=0} z^i / Gamma(p+1+i)
    """
    if dist_func == C.GAMMA:
        xs = sign * x + shift * scale
        zero_out = xs <= 0.0
    else:
        xs = -(sign * x - shift * scale)
        zero_out = xs <= 0.0  # cu:306: sign*x - shift*scale >= 0 -> return 1
    z = jnp.maximum(xs, 1e-30) / scale
    saturate = z > C.GAMMA_THRESHOLD

    shape = jnp.asarray(shape, jnp.float32)
    # 1 / Gamma(p+1) = exp(-lgamma(p+1)); p >= 0 enforced by caller
    inv_gamma_p1 = jnp.exp(-_lgamma(shape + 1.0)) if gamma_inv1 is None \
        else jnp.asarray(gamma_inv1, jnp.float32)
    kummers = inv_gamma_p1
    factor = inv_gamma_p1
    for i in range(1, C.NUM_STEPS_GAMMA):
        factor = factor * z / (shape + i)
        kummers = kummers + factor
    y = jnp.power(z, shape) * _safe_exp(-z) * kummers
    y = jnp.where(saturate, 1.0, y)
    y = jnp.where(zero_out, 0.0, y)
    if dist_func == C.GAMMA:
        return y
    return 1.0 - y


def _lgamma(v):
    import jax.lax as lax
    return lax.lgamma(jnp.asarray(v, jnp.float32))


def pdf(dist_func: int, sign, x, scale, shape=0.0, shift=0.0,
        gamma_inv=None):
    """Derivative of ``cdf`` w.r.t. (sign*x) — ``sigmoid_backward_cuda``
    (cu:366-459) branch by branch, including its asymmetries (several PDFs
    ignore ``sign`` because the kernel always calls with x >= 0).
    ``gamma_inv`` optionally supplies 1/Gamma(shape) precomputed outside."""
    sign = jnp.asarray(sign, jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    u = sign * x / scale

    if dist_func == C.HEAVISIDE:
        return jnp.zeros_like(x)

    if dist_func == C.LOGISTIC:
        y = 1.0 / (1.0 + _safe_exp(-u))
        return y * (1.0 - y) / scale

    if dist_func == C.CAUCHY:
        return 1.0 / (_PI * scale + _PI / scale * x * x)

    if dist_func == C.RECIPROCAL:
        return scale / (2.0 * (scale + x) * (scale + x))

    if dist_func == C.LAPLACE:
        return 0.5 / scale * _safe_exp(-x / scale)

    if dist_func == C.UNIFORM:
        return jnp.where((u > -1.0) & (u < 1.0), 0.5 / scale, 0.0)

    if dist_func == C.GUDERMANNIAN:
        # sech(u) from one exp
        eu = _safe_exp(u)
        return 2.0 / (eu + 1.0 / eu) / _PI / scale

    if dist_func == C.CUBIC_HERMITE:
        inside = (u >= -1.0) & (u <= 1.0)
        return jnp.where(inside, 0.75 / scale - 0.75 * x * x / (scale ** 3), 0.0)

    if dist_func == C.GAUSSIAN:
        return 1.0 / scale / math.sqrt(2.0 * _PI) * _safe_exp(-0.5 * u * u)

    if dist_func in (C.GAMMA, C.GAMMA_REV):
        # reference computes this branch in double (cu:412-423); we use
        # log-space fp32 which is comparably accurate for the kernel's range
        if dist_func == C.GAMMA:
            xs = sign * x + shift * scale
            zero_out = xs <= 0.0
        else:
            xs = -(sign * x - shift * scale)
            zero_out = xs <= 0.0
        xs_safe = jnp.maximum(xs, 1e-30)
        shape_arr = jnp.asarray(shape, jnp.float32)
        if gamma_inv is None:
            log_inv_gamma = -_lgamma(shape_arr)
        else:
            log_inv_gamma = jnp.log(jnp.maximum(
                jnp.asarray(gamma_inv, jnp.float32), 1e-30))
        log_pdf = (log_inv_gamma
                   - shape_arr * jnp.log(jnp.asarray(scale, jnp.float32))
                   + (shape_arr - 1.0) * jnp.log(xs_safe)
                   - xs_safe / scale)
        return jnp.where(zero_out, 0.0, _safe_exp(log_pdf))

    if dist_func == C.WIGNER_SEMICIRCLE:
        # cu:425-427: zero only for x/scale > 1 (no sign)
        sq = jnp.sqrt(jnp.maximum(scale * scale - x * x, 0.0))
        return jnp.where(x / scale > 1.0, 0.0, 2.0 / _PI / (scale * scale) * sq)

    if dist_func == C.GUMBEL_MAX:
        return _safe_exp(-(u + _safe_exp(-u))) / scale

    if dist_func == C.GUMBEL_MIN:
        return _safe_exp(-(-u + _safe_exp(u))) / scale

    if dist_func in (C.LEVY, C.LEVY_REV):
        if dist_func == C.LEVY:
            xs = sign * x + shift * scale
            zero_out = xs <= 1e-6
        else:
            xs = -(sign * x - shift * scale)
            zero_out = xs <= 1e-6
        xs_safe = jnp.maximum(xs, 1e-6)
        val = jnp.sqrt(scale / 2.0 / _PI) * _safe_exp(-scale / 2.0 / xs_safe) \
            / jnp.power(xs_safe, 1.5)
        return jnp.where(zero_out, 0.0, val)

    if dist_func in (C.EXPONENTIAL, C.EXPONENTIAL_REV):
        if dist_func == C.EXPONENTIAL:
            xs = sign * x + shift * scale
            zero_out = xs < 0.0
        else:
            xs = -(sign * x - shift * scale)
            zero_out = xs < 0.0
        val = 1.0 / scale * _safe_exp(-jnp.maximum(xs, 0.0) / scale)
        return jnp.where(zero_out, 0.0, val)

    raise ValueError(f'unknown dist_func id: {dist_func}')


# -- scalar verification seam ------------------------------------------------
# The reference exports CPU-callable scalar bindings used by its plotting /
# validation scripts (generalized_renderer_cuda.cpp:195-237,
# animations/distributions_to_csv.py).  These wrappers are the equivalent.

def sigmoid_forward(function_id, sign, x, scale=1.0, dist_shape=-10.0,
                    dist_shift=-10.0):
    return float(cdf(int(function_id), sign, x, scale, dist_shape, dist_shift))


def sigmoid_backward(function_id, sign, x, scale=1.0, dist_shape=-10.0,
                     dist_shift=-10.0):
    return float(pdf(int(function_id), sign, x, scale, dist_shape, dist_shift))
