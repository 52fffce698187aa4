"""Sharding specs and their placement on a device mesh."""
