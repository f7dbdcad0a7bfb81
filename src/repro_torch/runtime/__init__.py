"""Drivers of the port that run over its solvers and models (the SSSP
service and fleet replay, the LM serving loop)."""
