"""Measurement entry points of the port on the card (probe.py)."""
