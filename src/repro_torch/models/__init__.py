"""The LM stack of the port: configuration, parameter trees, layers
(attention, MoE, Mamba-2 SSD), the model zoo of all six families and its
public API."""
