"""The LM stack of the port: configuration, parameter trees, layers, the
model zoo and its public API (the dense family; the others are later
slices, see ``ROADMAP.md``)."""
