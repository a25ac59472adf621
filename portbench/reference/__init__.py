"""The plain reference the benchmark holds the port against.

``render.py`` is a path tracer in plain PyTorch, vectorised over the lanes
of a sample of pixels, with the semantics of the numpy scalar oracle
``tests/reference_cpu.py`` (the same wang-hash RNG streams a pixel and a
frame, the same transport) over instanced meshes and spheres.  It takes
the configuration's scene as arrays (``portbench.scenes.scene_data``) and
works out for itself what the port derives from them: the world-space
triangles and the material tables; it tests every primitive, with no
acceleration structure.  It imports nothing of the port, of JAX or of the
JAX package.
"""
