"""End-to-end drivers (classic SIMP-OC)."""
