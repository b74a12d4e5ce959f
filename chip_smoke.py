#!/usr/bin/env python3
"""Smoke test of gendr on one GPU, through the entry points a user calls.

    python chip_smoke.py              # one GPU: phases (a)-(e)
    python chip_smoke.py --rehearse   # every phase at tiny sizes on the CPU,
                                      # kernels interpreted; never prints ok
    python chip_smoke.py --four-gpus  # only the sharded render on 4 GPUs

Phases, each of which must pass:

  (a) device: JAX must see a GPU; prints its kind, the device count and
      nvidia-smi's name and power limit.
  (b) compile: the fwd+bwd step of both backends at the timed widths, with
      compiled.memory_analysis().
  (c) parity: the Pallas/Triton kernels against the XLA streaming scan (the
      plain reference) at real widths: forward image, vertex gradients and
      texture gradients, with the tolerances in TOL; and a second kernel
      run, which must agree bitwise.
  (d) timings: median fwd+bwd step of both backends, block_until_ready,
      profiler off.
  (e) main path: the GenDR API at the 256^2 headline, a few iterations of
      experiments/opt_shape.py and a few steps of
      experiments/train_reconstruction.py --synthetic.

The last line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Parity tolerances (atol, rtol, share of elements allowed outside them).
# Both sides compute in f32 and do no matrix product in the raster path, so
# TF32 never enters; they differ by FMA contraction, Triton's against XLA's
# transcendentals and the fold order (serial per pixel in the kernel, a
# tree per face chunk in the scan).  Images: that rounding only.  Gradients
# also carry isolated flips: a pair within an ulp of a triangle edge or a
# compact-support CDF edge changes its pdf by O(1/tau) between the two
# compilations, so a small share of entries may move by one pair's worth.
TOL = {
    'image': (1e-4, 1e-3, 1e-3),
    'grad': (2e-4, 2e-3, 0.02),
    # parametric t-conorm folds (frank, yager, ...) round their pow/log
    # chains differently in a serial fold than in a tree, and saturate
    'image_param': (1e-3, 1e-2, 0.02),
    'grad_param': (1e-3, 1e-2, 0.02),
}
PARAMETRIC_TCNS = ('hamacher', 'frank', 'yager', 'aczel_alsina', 'dombi',
                   'schweizer_sklar')
# colour is compared, and weighs in the loss, only where alpha exceeds this
# (see phase_parity)
COVERED = 1e-3


def _setup_jax(rehearse, n_cpu_devices=1):
    if rehearse:
        os.environ['JAX_PLATFORMS'] = 'cpu'
        if n_cpu_devices > 1:
            os.environ['XLA_FLAGS'] = (
                os.environ.get('XLA_FLAGS', '') +
                f' --xla_force_host_platform_device_count={n_cpu_devices}')
    import jax
    if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        jax.config.update('jax_compilation_cache_dir',
                          os.path.join(ROOT, '.jax_cache'))
    return jax


def _nvidia_smi():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi unavailable: {e}'


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def _scene(level, B, TS, seed=0, texture_type='surface'):
    """B views of a jittered icosphere (10 * 4^level faces), projected with
    the reference's default camera; random surface (or vertex) colours."""
    import numpy as np
    import jax.numpy as jnp
    from gendr_jax import data
    from gendr_jax.geometry import core, transforms as T
    rng = np.random.RandomState(seed)
    v, f = data.icosphere(level)
    v = v * (0.8 + 0.1 * rng.rand(v.shape[0], 1)).astype(np.float32)
    az = np.linspace(0.0, 360.0, B, endpoint=False).astype(np.float32) + 45
    eyes = T.get_points_from_angles(np.full(B, 2.732, np.float32),
                                    np.full(B, 30.0, np.float32), az)
    verts = T.perspective(T.look_at(jnp.tile(jnp.asarray(v)[None],
                                             (B, 1, 1)), eyes), 30.0)
    fv = core.face_vertices(verts, jnp.tile(jnp.asarray(f)[None], (B, 1, 1)))
    fv = fv.reshape(B, -1, 9)
    nf = fv.shape[1]
    tshape = (B, nf, 3, 3) if texture_type == 'vertex' else (B, nf, TS, 3)
    tex = jnp.asarray(rng.rand(*tshape).astype(np.float32))
    return fv, tex


class Case:
    """One render configuration and its fwd+bwd step."""

    def __init__(self, name, size, level, B=1, TS=1, aa=False,
                 texture_type='surface', **render_kw):
        self.name, self.size, self.aa = name, size, aa
        self.level, self.B, self.TS = level, B, TS
        self.texture_type = texture_type
        self.render_kw = dict(dict(dist_func='uniform', dist_scale=1e-2,
                                   aggr_alpha_func='probabilistic',
                                   aggr_rgb_func='hard'), **render_kw)

    def inputs(self):
        import numpy as np
        import jax.numpy as jnp
        fv, tex = _scene(self.level, self.B, self.TS,
                         texture_type=self.texture_type)
        w = np.random.RandomState(1).randn(self.B, 4, self.size, self.size)
        return fv, tex, jnp.asarray(w.astype(np.float32))

    def step(self, backend):
        """jit(value_and_grad) of a fixed random projection of the image,
        through the public GenDR API (2x supersampled when aa)."""
        import jax
        import jax.numpy as jnp
        from gendr_jax import GenDR
        r = GenDR(image_size=self.size, anti_aliasing=self.aa,
                  texture_type=self.texture_type, backend=backend,
                  double_side=True, **self.render_kw)

        def loss(fv, tex, w):
            img = r.forward_tensors(fv, tex)
            return jnp.sum(img * w), img

        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True))


def _timed_cases(rehearse):
    if rehearse:
        return [Case('hard 32^2 x 80f', 32, 1),
                Case('softmax TS=4 2xAA 16^2 x 80f', 16, 1, TS=4, aa=True,
                     aggr_rgb_func='softmax'),
                Case('hard 64^2 x 320f', 64, 2)]
    return [Case('hard 256^2 x 1280f', 256, 3),
            Case('softmax TS=25 2xAA 256^2 x 1280f', 256, 3, TS=25, aa=True,
                 aggr_rgb_func='softmax'),
            Case('hard 512^2 x 20480f', 512, 5)]


def _parity_cases(rehearse):
    """The timed cases, every distribution and t-conorm at least once at
    256^2 (a stratified slice of the 18 x 10 matrix), vertex colours, and
    an odd image size."""
    size, level = (32, 1) if rehearse else (256, 3)
    dists = ['hard', 'uniform', 'cubic_hermite', 'wigner_semicircle',
             'gaussian', 'laplace', 'logistic', 'gudermannian', 'cauchy',
             'reciprocal', 'gumbel_max', 'gumbel_min', 'exponential',
             'exponential_rev', 'gamma', 'gamma_rev', 'levy', 'levy_rev']
    tcns = [('probabilistic', 0.0), ('hard', 0.0), ('max', 0.0),
            ('einstein', 0.0), ('hamacher', 0.5), ('frank', 2.0),
            ('yager', 2.0), ('aczel_alsina', 2.0), ('dombi', 2.0),
            ('schweizer_sklar', -2.0)]
    extra = {'gamma': dict(dist_shape=2.0), 'gamma_rev': dict(dist_shape=2.0),
             'levy': dict(dist_shift=0.1), 'levy_rev': dict(dist_shift=0.1),
             'exponential': dict(dist_shift=0.05),
             'gumbel_max': dict(dist_shift=0.05)}
    cases = list(_timed_cases(rehearse))
    for i, d in enumerate(dists):
        tcn, p = tcns[i % len(tcns)]
        rgb = 'softmax' if i % 2 else 'hard'
        # softmax at gamma 1e-2: at the default 1e-3 a front face whose
        # coverage sits at the 1e-6 validity threshold (cu:784) outweighs
        # the rest by exp(dz / gamma), so a heavy-tailed CDF's last-bit
        # rounding flips whole pixel colours between any two compilations
        # (gudermannian at 32^2: the XLA scan jitted against itself eager
        # differs by 0.95 on the CPU)
        kw = dict(dist_func=d, dist_scale=2e-2, aggr_alpha_func=tcn,
                  aggr_alpha_t_conorm_p=p, aggr_rgb_func=rgb,
                  aggr_rgb_gamma=1e-2, **extra.get(d, {}))
        cases.append(Case(f'{d} x {tcn} {rgb} {size}^2', size, level, **kw))
    for rgb in ('softmax', 'hard'):
        cases.append(Case(f'vertex colours {rgb} {size}^2', size, level,
                          texture_type='vertex', aggr_rgb_func=rgb,
                          dist_func='logistic'))
    # odd sizes: vertex colours for softmax (a surface texel index from
    # clipped barycentrics is decided by rounding at soft outside pixels,
    # cu:178-185), surface texels for hard RGB (winners are inside)
    odd = 25 if rehearse else 250
    cases.append(Case(f'odd size softmax vertex colours {odd}^2', odd, level,
                      texture_type='vertex', aggr_rgb_func='softmax',
                      dist_func='logistic'))
    cases.append(Case(f'odd size hard TS=4 {odd}^2', odd, level, TS=4,
                      dist_func='logistic'))
    return cases


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def compare(label, got, want, kind):
    """Report and judge one got-vs-reference pair under TOL[kind]."""
    import numpy as np
    atol, rtol, budget = TOL[kind]
    got, want = np.asarray(got), np.asarray(want)
    finite = bool(np.isfinite(got).all() and np.isfinite(want).all())
    close = np.isclose(got, want, atol=atol, rtol=rtol)
    out = float(1.0 - close.mean())
    scale = float(np.abs(want).max()) or 1.0
    worst = float(np.abs(got - want).max()) / scale
    ok = finite and out <= budget
    print(f'  parity {label}: outside {out:.2e} (budget {budget:g}), '
          f'worst/scale {worst:.2e}, atol {atol:g} rtol {rtol:g}, '
          f'finite {finite} -> {"PASS" if ok else "FAIL"}')
    return ok


def _median_time(fn, args, reps):
    import jax
    import numpy as np
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.min(ts)), float(np.max(ts))


def phase_compile(cases):
    for c in cases:
        args = c.inputs()
        for backend in ('pallas', 'xla'):
            t0 = time.perf_counter()
            compiled = c.step(backend).lower(*args).compile()
            dt = time.perf_counter() - t0
            print(f'  compile [{backend}] {c.name}: {dt:.1f} s; '
                  f'memory_analysis: {compiled.memory_analysis()}')
    return True


def phase_parity(cases):
    """Kernels against the XLA scan on each case.  Colour is compared, and
    enters the loss, only at pixels with alpha > COVERED: at an almost
    uncovered pixel the softmax colour is decided by which tail pairs pass
    the 1e-6 validity threshold (cu:784), since the background's weight is
    exp((eps - z) / gamma) ~ 0, so it differs between any two
    compilations; alpha is compared everywhere."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    ok = True
    for c in cases:
        fv, tex, w = c.inputs()
        xla, pallas = c.step('xla'), c.step('pallas')
        with jax.default_matmul_precision('highest'):
            (_, img_x), _ = xla(fv, tex, w)
        covered = np.asarray(img_x)[:, 3:4] > COVERED
        keep = np.concatenate([np.repeat(covered, 3, axis=1),
                               np.ones_like(covered)], axis=1)
        w = jnp.asarray(np.where(keep, np.asarray(w), 0.0), jnp.float32)
        (_, img_p), (gf_p, gt_p) = pallas(fv, tex, w)
        with jax.default_matmul_precision('highest'):
            (_, img_x), (gf_x, gt_x) = xla(fv, tex, w)
        sfx = '_param' if c.render_kw['aggr_alpha_func'] in \
            PARAMETRIC_TCNS else ''
        gk = 'grad' + sfx
        print(f' {c.name}: alpha coverage '
              f'{float(np.asarray(img_x)[:, 3].mean()):.3f}, '
              f'{float(covered.mean()):.3f} of pixels above {COVERED:g}')
        ok &= compare(f'{c.name} image', np.where(keep, img_p, 0.0),
                      np.where(keep, img_x, 0.0), 'image' + sfx)
        ok &= compare(f'{c.name} vertex grads', gf_p, gf_x, gk)
        ok &= compare(f'{c.name} texture grads', gt_p, gt_x, gk)
        # each face's gradients are summed by one program, in a fixed order
        (_, img_q), (gf_q, gt_q) = pallas(fv, tex, w)
        same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                   ((img_p, img_q), (gf_p, gf_q), (gt_p, gt_q)))
        print(f'  determinism {c.name}: a second run is bitwise equal '
              f'-> {"PASS" if same else "FAIL"}')
        ok &= same
    return ok


def phase_timings(cases, card, reps):
    import numpy as np
    ok = True
    for c in cases:
        args = c.inputs()
        res = {}
        for backend in ('pallas', 'xla', 'xla', 'pallas'):
            med, lo, hi = _median_time(c.step(backend), args, reps)
            res.setdefault(backend, []).append((med, lo, hi))
        for backend, runs in res.items():
            desc = '; '.join(f'median {m * 1e3:.4f} ms (min {lo * 1e3:.4f}, '
                             f'max {hi * 1e3:.4f})' for m, lo, hi in runs)
            print(f'  time [{backend}] {c.name} fwd+bwd, {reps} warm steps '
                  f'x2 runs: {desc} | {card}')
        ok &= all(np.isfinite(m) for m, _, _ in sum(res.values(), []))
    return ok


def phase_main_path(rehearse):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import gendr_jax
    ok = True
    size, level = (32, 1) if rehearse else (256, 3)
    backend = 'pallas' if rehearse else None  # GPU: the platform default
    fv, tex = _scene(level, 1, 1)
    renderer = gendr_jax.GenDR(image_size=size, dist_func='uniform',
                               dist_scale=1e-2, aggr_rgb_func='hard',
                               backend=backend)
    loss = jax.jit(jax.value_and_grad(
        lambda v, t: jnp.mean(renderer.forward_tensors(v, t) ** 2),
        argnums=(0, 1)))
    val, (gv, gt) = loss(fv, tex)
    fin = bool(np.isfinite(float(val)) and np.isfinite(np.asarray(gv)).all()
               and np.isfinite(np.asarray(gt)).all())
    print(f'  GenDR {size}^2 x {fv.shape[1]}f hard RGB: loss {float(val):.6f}'
          f', |grad| {float(jnp.abs(gv).max()):.4g}, finite {fin}')
    ok &= fin

    sys.path.insert(0, ROOT)
    out_dir = os.path.join(ROOT, 'results', 'smoke')  # git-ignored
    from experiments import opt_shape, train_reconstruction
    argv = ['opt_shape.py', '--quick', '-ni', '4', '--chain', '2',
            '--views', '24@30', '--out-dir', out_dir]
    if rehearse:
        argv += ['-is', '16', '--backend', 'pallas']
    sys.argv = argv
    t0 = time.perf_counter()
    res = opt_shape.main()
    loss_os = float(res['24@30'][2])
    fin = bool(np.isfinite(loss_os))
    print(f'  opt_shape {" ".join(argv[1:])}: best hard IoU loss '
          f'{loss_os:.4f} in {time.perf_counter() - t0:.1f} s, finite {fin}')
    ok &= fin

    argv = ['train_reconstruction.py', '--synthetic', '-ni', '4',
            '--print_freq', '2', '--eval_freq', '4', '--max-eval-batches',
            '1', '--class_ids', 'synthetic']
    argv += (['--batch_size', '4', '--image_size', '16', '--quick',
              '--backend', 'pallas'] if rehearse else ['--batch_size', '64'])
    sys.argv = argv
    t0 = time.perf_counter()
    iou, loss_tr = train_reconstruction.main()
    fin = bool(np.isfinite(loss_tr) and np.isfinite(iou))
    print(f'  train_reconstruction {" ".join(argv[1:])}: loss {loss_tr:.4f}, '
          f'voxel IoU {iou:.2f} in {time.perf_counter() - t0:.1f} s, '
          f'finite {fin}')
    ok &= fin
    return ok


def phase_four_gpus(rehearse):
    """make_sharded_render over 4 devices vs a one-device render."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from gendr_jax import config as C
    from gendr_jax.parallel import sharding as S
    from gendr_jax.raster.render import render
    ok = True
    size, level = (16, 1) if rehearse else (256, 4)
    backend = 'pallas'
    modes = [('hard', 1, False), ('softmax', 4, True)]
    for axes in ({'fp': 4}, {'dp': 2, 'sp': 2}, {'dp': 2, 'fp': 2}):
        mesh = S.make_mesh(axes)
        for rgb, TS, aa in modes:
            is_ = size * (2 if aa else 1)
            fv, tex = _scene(level, 2, TS)
            kw = dict(dist_func='uniform', aggr_alpha_func='probabilistic',
                      aggr_rgb_func=rgb,
                      face_chunk=16 if rehearse else 128)
            cfg = C.RenderConfig.create(image_size=is_, backend=backend,
                                        **kw)
            params = dict(
                dist_scale=jnp.float32(1e-2), dist_shape=jnp.float32(0.0),
                dist_shift=jnp.float32(0.0), dist_eps=jnp.float32(1e4),
                aggr_alpha_t_conorm_p=jnp.float32(0.0),
                aggr_rgb_eps=jnp.float32(1e-3),
                aggr_rgb_gamma=jnp.float32(1e-3), near=jnp.float32(1.0),
                far=jnp.float32(100.0),
                background_color=jnp.zeros(3, jnp.float32))
            w = jnp.asarray(np.random.RandomState(2).randn(
                2, 4, size, size).astype(np.float32))

            def pool(img):
                if not aa:
                    return img
                b, c, h, w_ = img.shape
                return img.reshape(b, c, h // 2, 2, w_ // 2, 2).mean((3, 5))

            fn = S.make_sharded_render(
                cfg, mesh, dp_axis='dp' if 'dp' in axes else None,
                fp_axis='fp' if 'fp' in axes else None,
                sp_axis='sp' if 'sp' in axes else None)

            def loss_sh(v, t):
                img = pool(fn(v, t, params))
                return jnp.sum(img * w), img

            def loss_one(v, t):
                img = pool(render(v, t, image_size=is_, backend=backend,
                                  dist_scale=1e-2, **kw))
                return jnp.sum(img * w), img

            def step(loss):
                return jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                  has_aux=True))

            (_, img_s), (gf_s, gt_s) = step(loss_sh)(fv, tex)
            (_, img_1), (gf_1, gt_1) = step(loss_one)(fv, tex)
            tag = 'x'.join(f'{k}={v}' for k, v in axes.items())
            name = f'[{tag}] {rgb} TS={TS} aa={aa} {size}^2 x {fv.shape[1]}f'
            ok &= compare(f'{name} image', img_s, img_1, 'image')
            ok &= compare(f'{name} vertex grads', gf_s, gf_1, 'grad')
            ok &= compare(f'{name} texture grads', gt_s, gt_1, 'grad')
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--rehearse', action='store_true',
                    help='tiny sizes on the CPU, kernels interpreted')
    ap.add_argument('--four-gpus', action='store_true',
                    help='run only the 4-device sharded render phase')
    args = ap.parse_args(argv)
    n_dev = 4 if args.four_gpus else 1
    jax = _setup_jax(args.rehearse, n_dev)

    # (a) device
    dev = jax.devices()
    platform = dev[0].platform
    want = 'cpu' if args.rehearse else 'gpu'
    if platform != want:
        print(f'no {want} found: JAX platform is {platform!r}',
              file=sys.stderr)
        return 2
    if len(dev) < n_dev:
        print(f'need {n_dev} devices, found {len(dev)}', file=sys.stderr)
        return 2
    smi = 'none (CPU)' if args.rehearse else _nvidia_smi()
    card = ('CPU rehearsal: wall time of the interpreter, not a device time'
            if args.rehearse else f'card {smi}')
    print(f'(a) device: platform {platform}, kind {dev[0].device_kind}, '
          f'count {len(dev)}')
    print(f'    nvidia-smi name, power.limit: {smi}')
    sys.path.insert(0, ROOT)
    from gendr_jax.raster.render import platform_backend
    print(f'    default raster backend: {platform_backend()}')

    phases = []
    if args.four_gpus:
        phases.append(('(f) four devices', lambda: phase_four_gpus(
            args.rehearse)))
    else:
        timed = _timed_cases(args.rehearse)
        reps = 3 if args.rehearse else 20
        phases += [
            ('(b) compile', lambda: phase_compile(timed)),
            ('(c) parity', lambda: phase_parity(_parity_cases(
                args.rehearse))),
            ('(d) timings', lambda: phase_timings(timed, card, reps)),
            ('(e) main path', lambda: phase_main_path(args.rehearse)),
        ]
    failed = []
    for name, fn in phases:
        print(name, flush=True)
        t0 = time.perf_counter()
        ok = fn()
        print(f'{name}: {"PASS" if ok else "FAIL"} '
              f'({time.perf_counter() - t0:.1f} s)', flush=True)
        if not ok:
            failed.append(name)
    if failed:
        print(f'FAILED phases: {", ".join(failed)}', file=sys.stderr)
        return 1
    if args.rehearse:
        print('rehearsal passed (CPU; no device result)')
        return 0
    print(json.dumps({'ok': True, 'device': {
        'platform': platform, 'kind': dev[0].device_kind,
        'count': len(dev)}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
