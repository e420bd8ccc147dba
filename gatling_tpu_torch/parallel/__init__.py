"""Rendering one frame over several devices (parallel/sharding.py)."""
