"""Utilities: device/precision setup and timers."""
