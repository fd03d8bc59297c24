"""Helpers around the solver."""
