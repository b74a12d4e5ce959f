"""Wavefront OBJ / MTL I/O and texture (un)baking.

Replaces the reference's CPU parsers (gendr/functional/load_obj.py,
save_obj.py) and its two small CUDA kernels:

* ``load_textures`` (load_textures_cuda_kernel.cu:14-72) — bilinear sampling
  of the .mtl texture image at per-face-texel UV coordinates — here a
  vectorized jnp gather (the barycentric texel-center and bilinear math is
  identical).
* ``create_texture_image`` (create_texture_image_cuda_kernel.cu:16-75) —
  baking per-face textures into a tiled atlas for ``save_obj`` — here pure
  numpy (save-time only, not performance-critical).

Parsing itself prefers the native C++ tokenizer in ``gendr_jax.native`` and
falls back to a pure-Python parser.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

def _parse_obj_python(lines):
    """Parse v / f statements (load_obj.py:117-142 semantics: triangle-fan
    splitting of polygons, 1-based indices, optional texture indices)."""
    vertices = []
    faces = []
    tex_faces = []  # vt indices per face corner (0 where missing)
    vt = []
    vertex_colors = []
    mtllib = None
    face_materials = []
    material = ''
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        tag = parts[0]
        if tag == 'v':
            vertices.append([float(x) for x in parts[1:4]])
            if len(parts) >= 7:
                vertex_colors.append([float(x) for x in parts[4:7]])
        elif tag == 'vt':
            vt.append([float(x) for x in parts[1:3]])
        elif tag == 'f':
            vs = parts[1:]
            def vidx(tok):
                return int(tok.split('/')[0])
            def tidx(tok):
                if '/' in tok and '//' not in tok:
                    return int(tok.split('/')[1])
                return 0
            v0, t0 = vidx(vs[0]), tidx(vs[0])
            for i in range(len(vs) - 2):
                faces.append((v0, vidx(vs[i + 1]), vidx(vs[i + 2])))
                tex_faces.append((t0, tidx(vs[i + 1]), tidx(vs[i + 2])))
                face_materials.append(material)
        elif tag == 'usemtl':
            material = parts[1]
        elif tag == 'mtllib':
            mtllib = parts[1]
    return dict(
        vertices=np.array(vertices, np.float32),
        faces=np.array(faces, np.int32) - 1,
        tex_faces=np.array(tex_faces, np.int32) - 1,
        vt=np.array(vt, np.float32) if vt else np.zeros((0, 2), np.float32),
        vertex_colors=np.array(vertex_colors, np.float32)
        if vertex_colors else None,
        mtllib=mtllib,
        face_materials=face_materials,
    )


def parse_obj(filename_obj):
    with open(filename_obj) as f:
        lines = f.readlines()
    try:
        from gendr_jax.native import objparse
        parsed = objparse.parse_obj_native(''.join(lines))
        if parsed is not None:
            return parsed
    except Exception:
        pass
    return _parse_obj_python(lines)


def load_mtl(filename_mtl):
    """Kd colors and map_Kd texture filenames (load_obj.py:14-30)."""
    texture_filenames = {}
    colors = {}
    material_name = ''
    with open(filename_mtl) as f:
        for line in f.readlines():
            parts = line.split()
            if not parts:
                continue
            if parts[0] == 'newmtl':
                material_name = parts[1]
            elif parts[0] == 'map_Kd':
                texture_filenames[material_name] = parts[1]
            elif parts[0] == 'Kd':
                colors[material_name] = np.array(
                    [float(v) for v in parts[1:4]], np.float32)
    return colors, texture_filenames


def _read_image(path):
    """Read an image as float32 [H, W, 3] in [0, 1]."""
    try:
        import imageio.v2 as imageio
        img = imageio.imread(path)
    except ImportError:
        from skimage.io import imread
        img = imread(path)
    img = np.asarray(img).astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.ndim == 2:
        img = np.stack((img,) * 3, -1)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return img


# ---------------------------------------------------------------------------
# Texture texel-grid sampling (replaces load_textures CUDA kernel)
# ---------------------------------------------------------------------------

def texel_barycentrics(texture_res):
    """Barycentric centers of the R x R texel grid folded into two triangles
    (load_textures_cuda_kernel.cu:33-41). Returns [R*R, 3]."""
    R = texture_res
    idx = np.arange(R * R)
    w_y = (idx // R).astype(np.float32)
    w_x = (idx % R).astype(np.float32)
    lower = (w_x + w_y) < R
    w0 = np.where(lower, (w_x + 1.0 / 3.0) / R,
                  ((R - 1.0 - w_x) + 2.0 / 3.0) / R)
    w1 = np.where(lower, (w_y + 1.0 / 3.0) / R,
                  ((R - 1.0 - w_y) + 2.0 / 3.0) / R)
    w2 = 1.0 - w0 - w1
    return np.stack([w0, w1, w2], axis=-1)


def sample_textures_from_image(image, face_uvs, texture_res):
    """Bilinear-sample per-face-texel colors from a texture image.

    image: [H, W, 3] (v=0 at the bottom, i.e. already flipped like the
    reference does with ``image[::-1]``, load_obj.py:102);
    face_uvs: [nf, 3, 2] UV coords per face corner; -> [nf, R^2, 3].

    Bilinear weights match load_textures_cuda_kernel.cu:51-63 (truncation
    indexing, no clamping of the +1 neighbors — callers must pad if UVs touch
    the last row/column; we clamp instead, which only differs for
    out-of-range UVs).
    """
    H, W = image.shape[:2]
    bary = jnp.asarray(texel_barycentrics(texture_res))  # [R2, 3]
    uv = jnp.einsum('tk,fkc->ftc', bary, jnp.asarray(face_uvs))  # [nf,R2,2]
    pos_x = uv[..., 0] * (W - 1)
    pos_y = uv[..., 1] * (H - 1)
    x0 = jnp.clip(jnp.floor(pos_x).astype(jnp.int32), 0, W - 1)
    y0 = jnp.clip(jnp.floor(pos_y).astype(jnp.int32), 0, H - 1)
    x1 = jnp.clip(x0 + 1, 0, W - 1)
    y1 = jnp.clip(y0 + 1, 0, H - 1)
    wx1 = pos_x - jnp.floor(pos_x)
    wx0 = 1.0 - wx1
    wy1 = pos_y - jnp.floor(pos_y)
    wy0 = 1.0 - wy1
    img = jnp.asarray(image)
    c = (img[y0, x0] * (wx0 * wy0)[..., None]
         + img[y1, x0] * (wx0 * wy1)[..., None]
         + img[y0, x1] * (wx1 * wy0)[..., None]
         + img[y1, x1] * (wx1 * wy1)[..., None])
    return c


def load_textures(filename_obj, filename_mtl, texture_res):
    """Build [nf, R^2, 3] per-face textures from an OBJ+MTL pair
    (load_obj.py:33-106)."""
    parsed = parse_obj(filename_obj)
    vt = parsed['vt']
    tex_faces = np.maximum(parsed['tex_faces'], 0)
    face_uvs = vt[tex_faces] if len(vt) else np.zeros(
        (len(tex_faces), 3, 2), np.float32)
    # wrap UVs > 1 (load_obj.py:76)
    face_uvs = np.where(face_uvs > 1, face_uvs % 1, face_uvs)
    material_names = parsed['face_materials']

    colors, texture_filenames = load_mtl(filename_mtl)

    nf = len(face_uvs)
    textures = np.ones((nf, texture_res ** 2, 3), np.float32)
    for material_name, color in colors.items():
        sel = np.array([m == material_name for m in material_names])
        textures[sel] = color[None, None, :]

    for material_name, filename_texture in texture_filenames.items():
        path = os.path.join(os.path.dirname(filename_obj), filename_texture)
        image = _read_image(path)[::-1]  # flip v axis (load_obj.py:102)
        sel = np.array([m == material_name for m in material_names])
        if not sel.any():
            continue
        sampled = np.asarray(sample_textures_from_image(
            image, face_uvs[sel], texture_res))
        textures[sel] = sampled
    return jnp.asarray(textures)


def load_obj(filename_obj, normalization=False, load_texture=False,
             texture_res=4, texture_type='surface'):
    """Load a Wavefront .obj (load_obj.py:109-172)."""
    assert texture_type in ['surface', 'vertex']
    parsed = parse_obj(filename_obj)
    vertices = parsed['vertices']
    faces = parsed['faces']

    textures = None
    if load_texture and texture_type == 'surface':
        if parsed['mtllib'] is None:
            raise Exception('Failed to load textures.')
        filename_mtl = os.path.join(os.path.dirname(filename_obj),
                                    parsed['mtllib'])
        textures = load_textures(filename_obj, filename_mtl, texture_res)
    elif load_texture and texture_type == 'vertex':
        if parsed['vertex_colors'] is None:
            raise Exception('Failed to load vertex colors.')
        textures = jnp.asarray(parsed['vertex_colors'])

    if normalization:
        # unit-cube normalization (load_obj.py:162-167)
        vertices = vertices - vertices.min(0)[None, :]
        vertices = vertices / np.abs(vertices).max()
        vertices = vertices * 2
        vertices = vertices - vertices.max(0)[None, :] / 2

    vertices = jnp.asarray(vertices)
    faces = jnp.asarray(faces)
    if load_texture:
        return vertices, faces, textures
    return vertices, faces


# ---------------------------------------------------------------------------
# Saving (replaces create_texture_image CUDA kernel with numpy)
# ---------------------------------------------------------------------------

def create_texture_image(textures, texture_res=16):
    """Bake [nf, R_in^2, 3] per-face textures into a tiled atlas image +
    per-face UV vertices (functional/save_obj.py:13-40 and
    create_texture_image_cuda_kernel.cu:16-75)."""
    textures = np.asarray(textures)
    num_faces = textures.shape[0]
    R_in = int(np.sqrt(textures.shape[1]))
    tile_width = int((num_faces - 1.0) ** 0.5) + 1
    tile_height = int((num_faces - 1.0) / tile_width) + 1
    image = np.ones((tile_height * texture_res, tile_width * texture_res, 3),
                    np.float32)
    vertices = np.zeros((num_faces, 3, 2), np.float32)
    face_nums = np.arange(num_faces)
    column = face_nums % tile_width
    row = face_nums // tile_width
    vertices[:, 0, 0] = column * texture_res + texture_res / 2.0
    vertices[:, 0, 1] = row * texture_res + 1
    vertices[:, 1, 0] = column * texture_res + 1
    vertices[:, 1, 1] = (row + 1) * texture_res - 1 - 1
    vertices[:, 2, 0] = (column + 1) * texture_res - 1 - 1
    vertices[:, 2, 1] = (row + 1) * texture_res - 1 - 1

    eps = 1e-5
    H, W = image.shape[:2]
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    fn = (xs // texture_res) + (ys // texture_res) * tile_width
    valid = fn < num_faces
    fn_c = np.minimum(fn, num_faces - 1)

    p0, p1, p2 = vertices[fn_c, 0], vertices[fn_c, 1], vertices[fn_c, 2]
    det = (p2[..., 0] * (p0[..., 1] - p1[..., 1])
           + p0[..., 0] * (p1[..., 1] - p2[..., 1])
           + p1[..., 0] * (p2[..., 1] - p0[..., 1])) + eps
    w0 = ((p1[..., 1] - p2[..., 1]) * xs + (p2[..., 0] - p1[..., 0]) * ys
          + p1[..., 0] * p2[..., 1] - p2[..., 0] * p1[..., 1]) / det
    w1 = ((p2[..., 1] - p0[..., 1]) * xs + (p0[..., 0] - p2[..., 0]) * ys
          + p2[..., 0] * p0[..., 1] - p0[..., 0] * p2[..., 1]) / det
    w2 = ((p0[..., 1] - p1[..., 1]) * xs + (p1[..., 0] - p0[..., 0]) * ys
          + p0[..., 0] * p1[..., 1] - p1[..., 0] * p0[..., 1]) / det
    w = np.stack([w0, w1, w2], -1)
    w = np.clip(w, 0.0, 1.0)
    w = w / (w.sum(-1, keepdims=True) + eps)

    R = R_in
    w_x = (w[..., 0] * R).astype(np.int32)
    w_y = (w[..., 1] * R).astype(np.int32)
    lower = (w[..., 0] + w[..., 1]) * R - w_x - w_y <= 1
    texel = np.where(lower, w_y * R + w_x,
                     (R - 1 - w_y) * R + (R - 1 - w_x))
    texel = np.clip(texel, 0, R * R - 1)
    baked = textures[fn_c, texel]
    image = np.where(valid[..., None], baked, image)

    vertices[:, :, 0] /= (W - 1)
    vertices[:, :, 1] /= (H - 1)
    image = image[::-1, ::1]
    return image, vertices


def save_obj(filename, vertices, faces, textures=None, texture_res=16,
             texture_type='surface'):
    """Write an OBJ (+MTL+PNG when textured) (functional/save_obj.py:43-96)."""
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    assert vertices.ndim == 2
    assert faces.ndim == 2
    assert texture_type in ['surface', 'vertex']

    filename_mtl = filename[:-4] + '.mtl'
    filename_texture = filename[:-4] + '.png'
    material_name = 'material_1'
    vertices_textures = None
    if textures is not None and texture_type == 'surface':
        assert texture_res >= 2
        texture_image, vertices_textures = create_texture_image(
            textures, texture_res)
        texture_image = (np.clip(texture_image, 0, 1) * 255).astype('uint8')
        try:
            import imageio.v2 as imageio
            imageio.imsave(filename_texture, texture_image)
        except ImportError:
            from skimage.io import imsave
            imsave(filename_texture, texture_image)

    with open(filename, 'w') as f:
        f.write('# %s\n#\n\n' % os.path.basename(filename))
        if textures is not None:
            f.write('mtllib %s\n\n' % os.path.basename(filename_mtl))
        if textures is not None and texture_type == 'vertex':
            for vertex, color in zip(vertices, np.asarray(textures)):
                f.write('v %.8f %.8f %.8f %.8f %.8f %.8f\n' % (
                    vertex[0], vertex[1], vertex[2],
                    color[0], color[1], color[2]))
            f.write('\n')
        else:
            for vertex in vertices:
                f.write('v %.8f %.8f %.8f\n' % (vertex[0], vertex[1],
                                                vertex[2]))
            f.write('\n')
        if textures is not None and texture_type == 'surface':
            for vertex in vertices_textures.reshape((-1, 2)):
                f.write('vt %.8f %.8f\n' % (vertex[0], vertex[1]))
            f.write('\n')
            f.write('usemtl %s\n' % material_name)
            for i, face in enumerate(faces):
                f.write('f %d/%d %d/%d %d/%d\n' % (
                    face[0] + 1, 3 * i + 1, face[1] + 1, 3 * i + 2,
                    face[2] + 1, 3 * i + 3))
            f.write('\n')
        else:
            for face in faces:
                f.write('f %d %d %d\n' % (face[0] + 1, face[1] + 1,
                                          face[2] + 1))

    if textures is not None and texture_type == 'surface':
        with open(filename_mtl, 'w') as f:
            f.write('newmtl %s\n' % material_name)
            f.write('map_Kd %s\n' % os.path.basename(filename_texture))


def save_voxel(filename, voxel):
    """Write occupied voxel centers as OBJ vertices
    (functional/save_obj.py:98-106)."""
    voxel = np.asarray(voxel)
    idx = np.argwhere(voxel == 1)
    vertices = idx.astype(np.float32) / np.array(voxel.shape, np.float32)
    return save_obj(filename, vertices, np.zeros((0, 3), np.int32))
