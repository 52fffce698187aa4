"""Published model configurations, one module per architecture, and the
registry over them (:mod:`.registry`); copies of the JAX package's
``repro.configs``."""
