"""Dump the distribution-CDF zoo over a linspace to CSV.

Counterpart of animations/distributions_to_csv.py — the reference's
golden-value harness for the function zoo, built on its scalar pybind
exports (generalized_renderer_cuda.cpp:195-237).  Ours evaluates the same
functions through gendr_jax.ops.distributions.sigmoid_forward/backward,
with the same per-distribution x rescalings.
"""

import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from gendr_jax import config as C
from gendr_jax.ops.distributions import sigmoid_forward, sigmoid_backward
from animations.common import SIGMOID_FUNCTIONS


def sweep(function_id, xs, scale=1.0, param1=-10.0, param2=-10.0,
          backward=False):
    fn = sigmoid_backward if backward else sigmoid_forward
    return [fn(function_id, math.copysign(1, x), abs(x), scale, param1,
               param2) for x in xs]


def main(out_path='dist_function_values.csv', points=201):
    xs = np.linspace(-5, 5, points)
    results = [xs]
    for name, p in SIGMOID_FUNCTIONS:
        fid = C.DIST_FUNC_MAP[name]
        xs_ = xs
        if name in ['uniform', 'cubic_hermite', 'wigner_semicircle']:
            xs_ = xs_ / 2
        if name in ['levy', 'levy_rev']:
            xs_ = xs_ * 3
            results.append(sweep(fid, xs_, scale=2, param1=p, param2=0))
        else:
            results.append(sweep(fid, xs_, scale=1, param1=p, param2=0))
    results = np.vstack(results).T
    print(results.shape)
    np.savetxt(out_path, results, delimiter=',')


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', type=str, default='dist_function_values.csv')
    ap.add_argument('--points', type=int, default=201)
    a = ap.parse_args()
    main(a.out, a.points)
