"""Test harness configuration.

Tests run on the CPU (JAX_PLATFORMS=cpu unless set otherwise) with a
virtual 8-device mesh, so that multi-device sharding (`gendr_jax.parallel`)
is exercised without a GPU and the Pallas kernels run in interpret mode.
Tests marked ``gpu`` need a GPU and skip elsewhere; run them on one with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

import pytest

xla_flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in xla_flags:
    xla_flags += ' --xla_force_host_platform_device_count=8'
# Compile-time trim for the CPU test backend: the interpret-mode Pallas
# kernels lower to very large HLO graphs whose cold jit compile dominates
# the suite's wall time on a small CPU box (~2/3 of a cold run).  Dropping
# the backend optimization level + expensive LLVM passes cuts that compile
# ~2x; execution stays in the low-ms range at test shapes.  Tests assert
# parity between two backends compiled the same way, so the lower opt
# level does not weaken any oracle.
if 'xla_backend_optimization_level' not in xla_flags:
    xla_flags += (' --xla_backend_optimization_level=0'
                  ' --xla_llvm_disable_expensive_passes=true'
                  ' --xla_cpu_enable_concurrency_optimized_scheduler=false')
os.environ['XLA_FLAGS'] = xla_flags.strip()
os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import jax  # noqa: E402

# Persistent XLA compilation cache, so reruns skip recompiles: kept where
# JAX_COMPILATION_CACHE_DIR says (JAX reads it itself), else in the
# checkout's .jax_cache/.
if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
    jax.config.update('jax_compilation_cache_dir', os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        '.jax_cache'))
# GENDR_CACHE_READONLY=1 serves existing cache entries but suppresses new
# writes (threshold no compile can reach).  The write path serializes the
# executable through zstandard in-process and has segfaulted on this
# small box under memory pressure during long exhaustive runs; reads have
# never crashed.  Use it for marathon tiers where losing the process costs
# more than re-compiling the few uncached programs.
if os.environ.get('GENDR_CACHE_READONLY'):
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1e9)
else:
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs a GPU (compiled Triton kernels); skips '
        'elsewhere through the `gpu` fixture')
    config.addinivalue_line(
        'markers', 'slow: long-running experiment smoke tests '
        '(deselect with -m "not slow")')
    config.addinivalue_line(
        'markers', 'exhaustive: full cross-product parity sweeps; skipped '
        'by default to keep iteration fast — run with GENDR_EXHAUSTIVE=1 '
        '(a stratified subset of every code path stays in the default '
        'suite)')


def pytest_collection_modifyitems(config, items):
    if os.environ.get('GENDR_EXHAUSTIVE'):
        return
    skip = pytest.mark.skip(
        reason='exhaustive tier: set GENDR_EXHAUSTIVE=1 to run')
    for item in items:
        if 'exhaustive' in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none.  Decided
    here, at run time, never while test modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        pytest.skip(f'needs a GPU; JAX platform is {dev.platform!r}')
    return dev
