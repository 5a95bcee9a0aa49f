"""Measurement scripts that run on the card beside ``chip_smoke.py``."""
