"""Golden-value tests for the 18-distribution CDF/PDF zoo.

Oracles: closed forms via scipy.stats where available; elsewhere hand-derived
formulas matching the published distributions.  Also property tests
(monotonicity, CDF limits, PDF == d/dx CDF by finite differences).
"""

import numpy as np
import pytest
import scipy.stats as st
from scipy.special import gammainc, erfc

from gendr_jax import config as C
from gendr_jax.ops import distributions as D


def ref_eval(fid, xs, scale=1.0, shape=0.0, shift=0.0, fn='cdf'):
    """Evaluate our implementation the way the reference scalar harness does
    (animations/distributions_to_csv.py:34-38): sign=copysign(1,x), x=|x|."""
    f = D.cdf if fn == 'cdf' else D.pdf
    out = []
    for x in xs:
        sign = 1.0 if x >= 0 else -1.0
        out.append(float(f(fid, sign, abs(x), scale, shape, shift)))
    return np.array(out)


XS = np.linspace(-4.0, 4.0, 81)
SCALES = [1.0, 0.3]


def check_cdf(fid, oracle, scale=1.0, shape=0.0, shift=0.0, atol=2e-5):
    got = ref_eval(fid, XS, scale, shape, shift, 'cdf')
    want = oracle(XS)
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)


def check_pdf(fid, oracle, scale=1.0, shape=0.0, shift=0.0, atol=2e-5):
    got = ref_eval(fid, XS, scale, shape, shift, 'pdf')
    want = oracle(XS)
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)


class TestAgainstScipy:
    def test_heaviside(self):
        # the scalar harness passes sign=copysign(1, x), so x=0 -> sign=+1 -> 1
        check_cdf(C.HEAVISIDE, lambda x: (x >= 0).astype(float))
        assert D.cdf(C.HEAVISIDE, 1.0, 0.0, 1.0) == 1.0
        assert D.cdf(C.HEAVISIDE, -1.0, 0.0, 1.0) == 0.0

    def test_logistic(self):
        for s in SCALES:
            check_cdf(C.LOGISTIC, lambda x: st.logistic.cdf(x, scale=s), s)
            check_pdf(C.LOGISTIC, lambda x: st.logistic.pdf(x, scale=s), s)

    def test_gaussian(self):
        for s in SCALES:
            check_cdf(C.GAUSSIAN, lambda x: st.norm.cdf(x, scale=s), s)
            check_pdf(C.GAUSSIAN, lambda x: st.norm.pdf(x, scale=s), s)

    def test_laplace(self):
        for s in SCALES:
            check_cdf(C.LAPLACE, lambda x: st.laplace.cdf(x, scale=s), s)
            check_pdf(C.LAPLACE, lambda x: st.laplace.pdf(x, scale=s), s)

    def test_cauchy(self):
        for s in SCALES:
            check_cdf(C.CAUCHY, lambda x: st.cauchy.cdf(x, scale=s), s)
            check_pdf(C.CAUCHY, lambda x: st.cauchy.pdf(x, scale=s), s)

    def test_uniform(self):
        # uniform on [-scale, scale]
        for s in SCALES:
            check_cdf(C.UNIFORM,
                      lambda x: st.uniform.cdf(x, loc=-s, scale=2 * s), s)
            # mask the support boundary (float32 vs float64 tie-breaking)
            xs = XS[np.abs(np.abs(XS) - s) > 1e-6]
            got = ref_eval(C.UNIFORM, xs, s, fn='pdf')
            want = np.where(np.abs(xs) < s, 0.5 / s, 0.0)
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)

    def test_wigner_semicircle(self):
        for s in SCALES:
            check_cdf(C.WIGNER_SEMICIRCLE,
                      lambda x: st.semicircular.cdf(x, scale=s), s)

    def test_gudermannian(self):
        # (2/pi) atan(tanh(x/2)) + 1/2 == (2/pi) atan(e^x) == hypsecant CDF
        check_cdf(C.GUDERMANNIAN, lambda x: st.hypsecant.cdf(x), 1.0)
        check_pdf(C.GUDERMANNIAN, lambda x: st.hypsecant.pdf(x), 1.0)

    def test_gumbel(self):
        for s in SCALES:
            check_cdf(C.GUMBEL_MAX, lambda x: st.gumbel_r.cdf(x, scale=s), s)
            check_pdf(C.GUMBEL_MAX, lambda x: st.gumbel_r.pdf(x, scale=s), s)
            check_cdf(C.GUMBEL_MIN, lambda x: st.gumbel_l.cdf(x, scale=s), s)
            check_pdf(C.GUMBEL_MIN, lambda x: st.gumbel_l.pdf(x, scale=s), s)

    def test_exponential(self):
        for s in SCALES:
            check_cdf(C.EXPONENTIAL, lambda x: st.expon.cdf(x, scale=s), s)
            check_pdf(C.EXPONENTIAL, lambda x: st.expon.pdf(x, scale=s), s)
            # reversed: 1 - F(-x)
            check_cdf(C.EXPONENTIAL_REV,
                      lambda x: 1.0 - st.expon.cdf(-x, scale=s), s)
            check_pdf(C.EXPONENTIAL_REV,
                      lambda x: st.expon.pdf(-x, scale=s), s)

    @pytest.mark.parametrize('p', [0.5, 1.0, 2.0, 5.0])
    def test_gamma(self, p):
        xs = XS[np.abs(XS) > 1e-9]  # reference returns 0 at exactly x=0
        for s in SCALES:
            for fn, oracle in [
                ('cdf', lambda x: gammainc(p, np.maximum(x, 0) / s)),
                ('pdf', lambda x: np.where(x > 0,
                                           st.gamma.pdf(np.maximum(x, 1e-9),
                                                        p, scale=s), 0.0)),
            ]:
                got = ref_eval(C.GAMMA, xs, s, p, 0.0, fn)
                np.testing.assert_allclose(got, oracle(xs), atol=1e-4,
                                           rtol=1e-3)
            got = ref_eval(C.GAMMA_REV, xs, s, p, 0.0, 'cdf')
            np.testing.assert_allclose(
                got, 1.0 - gammainc(p, np.maximum(-xs, 0) / s), atol=1e-4,
                rtol=1e-3)

    def test_gamma_shift(self):
        # dist_shift shifts before scaling: xs = x + shift*scale (cu:302)
        p, s, sh = 2.0, 0.5, 1.5
        check_cdf(C.GAMMA,
                  lambda x: gammainc(p, np.maximum(x + sh * s, 0) / s), s,
                  shape=p, shift=sh, atol=1e-4)

    def test_levy(self):
        for s in SCALES:
            check_cdf(C.LEVY, lambda x: np.where(
                x <= 1e-6, 0.0,
                erfc(np.sqrt(s / 2.0 / np.maximum(x, 1e-6)))), s)
            check_cdf(C.LEVY, lambda x: st.levy.cdf(x, scale=s), s)
            check_pdf(C.LEVY, lambda x: st.levy.pdf(np.maximum(x, 1e-9),
                                                    scale=s) * (x > 1e-6), s)

    def test_reciprocal(self):
        # CDF(x) = x/(2(scale+|x|)) + 1/2
        for s in SCALES:
            check_cdf(C.RECIPROCAL,
                      lambda x: x / (2.0 * (s + np.abs(x))) + 0.5, s)
            check_pdf(C.RECIPROCAL,
                      lambda x: s / (2.0 * (s + np.abs(x)) ** 2), s)

    def test_cubic_hermite(self):
        def cdf(x):
            y = np.clip(x / 2.0 + 0.5, 0, 1)
            return 3 * y ** 2 - 2 * y ** 3
        check_cdf(C.CUBIC_HERMITE, cdf, 1.0)


class TestProperties:
    @pytest.mark.parametrize('fid', sorted(set(C.DIST_FUNC_MAP.values())))
    def test_monotone_and_limits(self, fid):
        shape = 2.0 if fid in (C.GAMMA, C.GAMMA_REV) else 0.0
        ys = ref_eval(fid, np.linspace(-30, 30, 301), 0.7, shape, 0.0)
        assert np.all(np.diff(ys) >= -1e-5), f'{fid} not monotone'
        # heavy-tailed distributions converge slowly to the limits
        tol = 0.15 if fid in (C.CAUCHY, C.RECIPROCAL, C.LEVY,
                              C.LEVY_REV) else 1e-3
        assert ys[0] <= tol and ys[-1] >= 1 - tol
        assert np.all((ys >= 0) & (ys <= 1))

    @pytest.mark.parametrize('fid', sorted(set(C.DIST_FUNC_MAP.values())))
    def test_pdf_matches_fd(self, fid):
        if fid == C.HEAVISIDE:
            return
        shape = 2.0 if fid in (C.GAMMA, C.GAMMA_REV) else 0.0
        shift = 0.5 if fid in (C.LEVY, C.LEVY_REV) else 0.0
        xs = np.linspace(-3, 3, 61)
        h = 1e-3
        f_p = ref_eval(fid, xs + h, 1.0, shape, shift)
        f_m = ref_eval(fid, xs - h, 1.0, shape, shift)
        fd = (f_p - f_m) / (2 * h)
        got = ref_eval(fid, xs, 1.0, shape, shift, 'pdf')
        # mask points near kinks / support boundaries
        mask = np.ones_like(xs, bool)
        if fid in (C.UNIFORM, C.CUBIC_HERMITE, C.WIGNER_SEMICIRCLE):
            mask &= np.abs(np.abs(xs) - 1.0) > 5 * h
        if fid in (C.GAMMA, C.GAMMA_REV, C.EXPONENTIAL, C.EXPONENTIAL_REV,
                   C.LEVY, C.LEVY_REV):
            mask &= np.abs(xs) > 5 * h
        np.testing.assert_allclose(got[mask], fd[mask], atol=5e-3, rtol=2e-2)
