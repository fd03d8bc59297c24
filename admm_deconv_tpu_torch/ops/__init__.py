"""Solver core: FFT precompute, difference stencils, prox library, ADMM loop."""
