"""Fault-tolerance hooks of the port."""
