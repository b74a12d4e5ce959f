from gendr_jax.utils.metrics import AverageMeter, Timer  # noqa: F401
from gendr_jax.utils.profiling import trace  # noqa: F401
