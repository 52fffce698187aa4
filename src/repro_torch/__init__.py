"""PyTorch/CUDA port of the bufferless-NoC multicore simulator.

A package beside the JAX package ``repro``: it imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.  The main path is one
simulator run on one device — :func:`repro_torch.core.sim.run` — with
the Phase-2 router arbitration as a hand-written CUDA kernel for Hopper
(:mod:`repro_torch.kernels.router_phase`).  Entry points run on the GPU
unless the caller passes ``device="cpu"``.
"""
