"""Models of the port (``repro/models``): xDeepFM scoring and the
decoder-only LM (``transformer``, ``attention``, ``moe``, ``common``)."""
