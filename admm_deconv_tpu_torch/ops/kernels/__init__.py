"""Hand-written CUDA kernels, their plain-torch twins, and their build.

Importing this package builds nothing: a kernel compiles at its first
launch on a CUDA tensor.
"""
