"""The benchmark's plain reference: its own TET10 box meshes (mesh.py) and
f64 neo-Hookean internal force and tangent action (fem.py), in NumPy and
PyTorch. It imports nothing of the program under test and takes no array
the program made."""
