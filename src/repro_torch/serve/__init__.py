"""Continuous-batching serving over a fixed-size KV cache."""
