"""Seeded synthetic data of the port (``repro/data``)."""
