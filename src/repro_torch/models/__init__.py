"""Models of the port (``repro/models``): xDeepFM scoring, the
decoder-only LM (``transformer``, ``attention``, ``moe``, ``common``) and
the GNNs (``gnn``)."""
