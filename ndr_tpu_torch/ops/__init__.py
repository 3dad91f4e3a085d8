"""Differentiable TO operators: filters and the volume constraint."""
