"""Checks that need a GPU: the compiled Triton kernels against the XLA scan
(the plain reference) at the widths chip_smoke.py times.  They skip where
JAX sees no GPU; chip_smoke.py's parity phase runs the same comparison
among others.  On a GPU:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.mark.gpu
@pytest.mark.parametrize('case', range(3))
def test_kernels_match_xla_at_timed_widths(gpu, case):
    import chip_smoke
    assert chip_smoke.phase_parity([chip_smoke._timed_cases(False)[case]])
