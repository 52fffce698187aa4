"""Step functions over the model API (serving and prefill steps)."""
