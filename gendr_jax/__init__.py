"""gendr_jax — a generalized differentiable renderer in JAX.

A from-scratch JAX / XLA / Pallas re-design of the capabilities of
Felix-Petersen/gendr (CVPR 2022, arXiv 2204.13845): a generalized soft
rasterizer with an 18-distribution occlusion-test zoo and a 9-t-conorm
alpha-aggregation zoo, plus mesh/camera/lighting utilities, mesh
regularization losses, OBJ I/O, a solid voxelizer, and the reference's three
research experiments — built for accelerators (static shapes, culled
per-pixel folds in Pallas/Triton kernels on a GPU, a streaming face-chunk
scan in plain XLA, deterministic gradient reductions, `jax.sharding`
multi-device scaling).
"""

from gendr_jax.config import RenderConfig, RenderParams  # noqa: F401
from gendr_jax.geometry.mesh import Mesh  # noqa: F401
from gendr_jax.geometry.transforms import (  # noqa: F401
    LookAt, Look, Projection)
from gendr_jax.geometry.lighting import (  # noqa: F401
    AmbientLighting, DirectionalLighting, Lighting)
from gendr_jax.geometry.losses import LaplacianLoss, FlattenLoss  # noqa: F401
from gendr_jax.renderer import GenDR  # noqa: F401
from gendr_jax import functional  # noqa: F401

__version__ = '0.1.0'
