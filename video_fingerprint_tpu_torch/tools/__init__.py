"""Probes and measurement scripts of the port, run with `python -m`."""
