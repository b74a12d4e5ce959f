"""Training metrics utilities.

``AverageMeter`` mirrors the reference's meter
(experiments/train_reconstruction.py:48-63); ``Timer`` times jitted
functions up to ``jax.block_until_ready``.
"""

from __future__ import annotations

import time


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class Timer:
    """Best mean wall-clock of a jitted function, each timed block ending
    when every output is ready on the device."""

    @staticmethod
    def timeit(fn, *args, iters=20, repeats=3):
        import jax
        jax.block_until_ready(fn(*args))
        best = float('inf')
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*args)
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / iters)
        return best
