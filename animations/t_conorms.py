"""Evaluate/plot t-conorm surfaces over [0,1]^2.

Counterpart of animations/t_conorms.py: wraps the scalar t-conorm in a
differentiable function and dumps surface values (and gradients via the
aggregate-inverse rule) to CSV for plotting.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from gendr_jax import config as C
from gendr_jax.ops import tconorms as T


def surface(name, p=0.0, n=65):
    tid = C.AGGR_ALPHA_FUNC_MAP[name]
    a = jnp.linspace(0.0, 1.0, n)
    A, B = jnp.meshgrid(a, a)
    Z = T.fold_step(tid, A, B, p)
    dZ = T.aggregate_backward(tid, Z, B, p)
    return np.asarray(A), np.asarray(B), np.asarray(Z), np.asarray(dZ)


def main(out_dir='./results/tconorm_surfaces', points=65):
    os.makedirs(out_dir, exist_ok=True)
    configs = [('max', 0.0), ('probabilistic', 0.0), ('einstein', 0.0),
               ('hamacher', 0.5), ('frank', 2.0), ('yager', 2.0),
               ('aczel_alsina', 2.0), ('dombi', 2.0),
               ('schweizer_sklar', -2.0)]
    for name, p in configs:
        A, B, Z, dZ = surface(name, p, points)
        np.savetxt(os.path.join(out_dir, f'{name}_p{p}.csv'), Z,
                   delimiter=',')
        print(f'{name} (p={p}): Z in [{Z.min():.3f}, {Z.max():.3f}]')


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--out-dir', type=str,
                    default='./results/tconorm_surfaces')
    ap.add_argument('--points', type=int, default=65)
    a = ap.parse_args()
    main(a.out_dir, a.points)
