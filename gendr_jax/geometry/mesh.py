"""Mesh: a pytree triangle-mesh container.

API parity with the reference's ``gendr.Mesh`` (gendr/mesh.py:13-126), but as
a JAX pytree: ``vertices``/``faces``/``textures`` are leaves, texture
metadata is static aux data — so a Mesh can flow through ``jit``/``vmap``/
``grad`` and across ``shard_map`` boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from gendr_jax.geometry import core


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Mesh:
    vertices: jnp.ndarray                 # [B, nv, 3] float32
    faces: jnp.ndarray                    # [B, nf, 3] int32
    textures: Optional[jnp.ndarray] = None
    texture_res: int = dataclasses.field(default=1, metadata=dict(static=True))
    texture_type: str = dataclasses.field(default='surface',
                                          metadata=dict(static=True))

    # -- construction -------------------------------------------------------

    @staticmethod
    def create(vertices, faces, textures=None, texture_res=1,
               texture_type='surface') -> 'Mesh':
        """Normalizing constructor (mirrors gendr/mesh.py:17-58): promotes
        numpy inputs and unbatched 2D tensors, and fills default white
        textures when none are given."""
        vertices = jnp.asarray(vertices, jnp.float32)
        faces = jnp.asarray(faces, jnp.int32)
        if vertices.ndim == 2:
            vertices = vertices[None]
        if faces.ndim == 2:
            faces = faces[None]
        b, nv = vertices.shape[:2]
        nf = faces.shape[1]

        if textures is None:
            if texture_type == 'surface':
                textures = jnp.ones((b, nf, texture_res ** 2, 3), jnp.float32)
            elif texture_type == 'vertex':
                textures = jnp.ones((b, nv, 3), jnp.float32)
                texture_res = 1
            else:
                raise ValueError(texture_type)
        else:
            textures = jnp.asarray(textures, jnp.float32)
            if textures.ndim == 3 and texture_type == 'surface':
                textures = textures[None]
            if textures.ndim == 2 and texture_type == 'vertex':
                textures = textures[None]
            if texture_type == 'surface':
                texture_res = int(np.sqrt(textures.shape[2]))
        return Mesh(vertices, faces, textures, texture_res, texture_type)

    @classmethod
    def from_obj(cls, filename_obj, normalization=False, load_texture=False,
                 texture_res=1, texture_type='surface') -> 'Mesh':
        """Load a Wavefront .obj (mesh.py:60-77)."""
        from gendr_jax.geometry import obj_io
        if load_texture:
            vertices, faces, textures = obj_io.load_obj(
                filename_obj, normalization=normalization,
                texture_res=texture_res, load_texture=True,
                texture_type=texture_type)
        else:
            vertices, faces = obj_io.load_obj(
                filename_obj, normalization=normalization,
                texture_res=texture_res, load_texture=False)
            textures = None
        return cls.create(vertices, faces, textures, texture_res,
                          texture_type)

    def save_obj(self, filename_obj, save_texture=False, texture_res_out=16):
        from gendr_jax.geometry import obj_io
        if self.batch_size != 1:
            raise ValueError('Could not save when batch size > 1')
        if save_texture:
            obj_io.save_obj(filename_obj, self.vertices[0], self.faces[0],
                            textures=self.textures[0],
                            texture_res=texture_res_out,
                            texture_type=self.texture_type)
        else:
            obj_io.save_obj(filename_obj, self.vertices[0], self.faces[0],
                            textures=None)

    # -- derived quantities --------------------------------------------------

    @property
    def batch_size(self):
        return self.vertices.shape[0]

    @property
    def num_vertices(self):
        return self.vertices.shape[1]

    @property
    def num_faces(self):
        return self.faces.shape[1]

    @property
    def face_vertices(self):
        return core.face_vertices(self.vertices, self.faces)

    @property
    def surface_normals(self):
        return core.surface_normals(self.vertices, self.faces)

    @property
    def vertex_normals(self):
        return core.vertex_normals(self.vertices, self.faces)

    @property
    def face_textures(self):
        """Per-face textures as consumed by the rasterizer (mesh.py:115-122):
        surface textures pass through; vertex colors are gathered per face."""
        if self.texture_type == 'surface':
            return self.textures
        if self.texture_type == 'vertex':
            return core.face_vertices(self.textures, self.faces)
        raise ValueError('texture type not applicable')

    def voxelize(self, voxel_size=32):
        """Solid-voxelize into [B, vs, vs, vs] occupancy (mesh.py:124-126)."""
        from gendr_jax.geometry import voxelize
        fv = self.face_vertices * voxel_size / (voxel_size - 1) + 0.5
        return voxelize.voxelization(fv, voxel_size, False)

    # -- functional updates ---------------------------------------------------

    def with_vertices(self, vertices) -> 'Mesh':
        return dataclasses.replace(self, vertices=vertices)

    def with_textures(self, textures) -> 'Mesh':
        return dataclasses.replace(self, textures=textures)

    def repeat(self, n) -> 'Mesh':
        """Tile the batch dimension n times (replaces the reference pattern
        ``Mesh(mesh.vertices.repeat(n,1,1), mesh.faces.repeat(n,1,1))``)."""
        return dataclasses.replace(
            self,
            vertices=jnp.tile(self.vertices, (n, 1, 1)),
            faces=jnp.tile(self.faces, (n, 1, 1)),
            textures=None if self.textures is None
            else jnp.tile(self.textures,
                          (n,) + (1,) * (self.textures.ndim - 1)))
