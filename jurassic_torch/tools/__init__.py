"""Measurement tools of the port."""
