"""Hand-written Hopper kernels of the port, their plain PyTorch versions
and the dispatch between them (:mod:`.ops`)."""
