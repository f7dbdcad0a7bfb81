"""SSSP engine, backends, solver facade and the numpy reference oracle."""
