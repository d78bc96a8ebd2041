"""Measurement tools for the port."""
