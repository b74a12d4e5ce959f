"""Functional (stateless) API, mirroring ``gendr.functional``
(gendr/functional/__init__.py:6-15)."""

from gendr_jax.geometry.transforms import (  # noqa: F401
    get_points_from_angles, look, look_at, perspective, orthogonal,
    projection)
from gendr_jax.geometry.lighting import (  # noqa: F401
    ambient_lighting, directional_lighting)
from gendr_jax.geometry.core import (  # noqa: F401
    face_vertices, vertex_normals, surface_normals)
from gendr_jax.geometry.obj_io import (  # noqa: F401
    load_obj, save_obj, save_voxel, load_mtl, load_textures,
    create_texture_image)
from gendr_jax.raster.render import render  # noqa: F401
from gendr_jax.geometry.voxelize import voxelization  # noqa: F401
