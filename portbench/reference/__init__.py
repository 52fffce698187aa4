"""A plain PyTorch simulator frozen for the benchmark's check: the same
semantics as the port's ``core`` (phases 1a, 1b, 2, 3 and the driver's
monitors and statistics), Phase 2 by plain ops, importing nothing of the
port.  ``sim.run`` steps one scenario."""
