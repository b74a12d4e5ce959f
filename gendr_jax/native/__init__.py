"""Native (C++) accelerators with pure-Python fallbacks.

The reference keeps its CPU-side hot paths (OBJ tokenization feeding the
texture pipeline) in Python; here the parser has a C++ fast path built via
ctypes (see ``objparse.cpp`` / ``build.sh``), used opportunistically by
``gendr_jax.geometry.obj_io.parse_obj``.
"""
