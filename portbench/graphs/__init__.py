"""Graph generators, one module a family, named by a configuration's
``generator`` key.  Each has ``make(config, seed, device)``, returning
``(n, src, dst, w)``: int64 endpoints and float32 weights on ``device``,
drawn by a ``torch.Generator`` there."""
