"""T-conorm axioms + aggregate-inverse backward consistency tests."""

import numpy as np
import pytest

from gendr_jax import config as C
from gendr_jax.ops import tconorms as T

# (id, valid p)
CONFIGS = [
    (C.MAX_TCN, 0.0),
    (C.PROBABILISTIC_TCN, 0.0),
    (C.EINSTEIN_TCN, 0.0),
    (C.HAMACHER_TCN, 0.5),
    (C.HAMACHER_TCN, 2.0),
    (C.FRANK_TCN, 0.5),
    (C.FRANK_TCN, 3.0),
    (C.YAGER_TCN, 0.5),
    (C.YAGER_TCN, 2.0),
    (C.ACZEL_ALSINA_TCN, 0.5),
    (C.ACZEL_ALSINA_TCN, 2.0),
    (C.DOMBI_TCN, 2.0),
    (C.SCHWEIZER_SKLAR_TCN, -1.0),
    (C.SCHWEIZER_SKLAR_TCN, -2.5),
]

VALS = np.array([0.0, 0.05, 0.3, 0.5, 0.77, 0.95, 0.999])


@pytest.mark.parametrize('tid,p', CONFIGS)
class TestAxioms:
    def test_commutative(self, tid, p):
        for a in VALS:
            for b in VALS:
                x = T.t_conorm_forward(tid, a, b, 0, p)
                y = T.t_conorm_forward(tid, b, a, 0, p)
                assert abs(x - y) < 1e-5, (a, b)

    def test_neutral_zero(self, tid, p):
        # folding a masked-out face (b=0) must be the identity
        for a in VALS:
            x = T.t_conorm_forward(tid, a, 0.0, 0, p)
            np.testing.assert_allclose(x, a, atol=2e-6)

    def test_bounds_and_monotone(self, tid, p):
        for a in VALS:
            prev = -1.0
            for b in VALS:
                x = T.t_conorm_forward(tid, a, b, 0, p)
                assert -1e-6 <= x <= 1 + 1e-6
                assert x >= max(a, b) - 1e-5  # t-conorm dominates max
                assert x >= prev - 1e-5
                prev = x

    def test_backward_matches_fd(self, tid, p):
        """aggregate_backward(A, b) should approximate dA/db where A is the
        fold of several coverages (exact for these t-conorms by design)."""
        if tid == C.MAX_TCN:
            return  # subgradient, checked separately
        others = [0.2, 0.55, 0.8]
        h = 1e-4
        for b in [0.1, 0.4, 0.7]:
            def agg(bv):
                a = 0.0
                for o in others + [bv]:
                    a = T.t_conorm_forward(tid, a, o, 0, p)
                return a
            A = agg(b)
            fd = (agg(b + h) - agg(b - h)) / (2 * h)
            got = T.t_conorm_backward(tid, A, b, 4, p)
            np.testing.assert_allclose(got, fd, rtol=5e-2, atol=5e-3)


def test_max_backward_tie():
    # reference: exact equality test (cu:574-575)
    assert T.t_conorm_backward(C.MAX_TCN, 0.7, 0.7, 1, 0.0) == 1.0
    assert T.t_conorm_backward(C.MAX_TCN, 0.7, 0.4, 1, 0.0) == 0.0


def test_probabilistic_known_values():
    assert abs(T.t_conorm_forward(C.PROBABILISTIC_TCN, 0.5, 0.5) - 0.75) < 1e-6
    assert abs(T.t_conorm_forward(C.EINSTEIN_TCN, 0.5, 0.5) - 0.8) < 1e-6


def test_frank_saturation_edge_accuracy():
    """frank must stay accurate as the aggregate saturates (a -> 1).

    The naive powf formulation (cu:506-511, 586-589: ``p**(1-a) - 1``)
    amplifies pow's ~1-ulp rounding near 1 into O(1) *relative* error of
    the difference once 1-a is small — which compounds multiplicatively
    through the fold in deeply-covered pixels, so two compilations of it
    disagree visibly.  The expm1 reformulation in tconorms._expm1 must
    track an f64 evaluation at f32 conditioning.
    """
    p = 2.0
    lnp = np.log(np.float64(p))
    for eps in [2e-7, 1e-6, 3e-6, 1e-5, 1e-4, 1e-3]:
        a = np.float32(1.0) - np.float32(eps)
        b = np.float32(0.3)
        a64, b64 = np.float64(a), np.float64(b)
        # f64 ground truth (the naive formula is well-conditioned in f64
        # at these eps)
        ea = np.expm1((1.0 - a64) * lnp)
        eb = np.expm1((1.0 - b64) * lnp)
        ref = 1.0 - np.log1p(ea * eb / (p - 1.0)) / lnp
        got = T.t_conorm_forward(C.FRANK_TCN, a, b, 0, p)
        # error budget: ~1e-7 relative on the (tiny) distance-from-1,
        # i.e. the fold's per-step relative error must NOT blow up as
        # eps -> 0 the way the powf form does
        assert abs(got - ref) <= 4.0 * max(1.0 - ref, 1e-9) * 1e-6 + 1e-7, \
            (eps, got, ref)

        # backward: dA/db_i with the aggregate A saturated near 1
        A, bi = a, b
        A64 = np.float64(A)
        ref_g = p ** (A64 - b64) * np.expm1((1.0 - A64) * lnp) \
            / np.expm1((1.0 - b64) * lnp)
        got_g = T.t_conorm_backward(C.FRANK_TCN, A, bi, 0, p)
        assert abs(got_g - ref_g) <= abs(ref_g) * 1e-4 + 1e-9, \
            (eps, got_g, ref_g)
