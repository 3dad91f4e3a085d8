"""Evaluation: compliance of densities and trained fields at a test resolution."""
