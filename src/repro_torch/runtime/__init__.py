"""Drivers of the port that run over its solvers."""
