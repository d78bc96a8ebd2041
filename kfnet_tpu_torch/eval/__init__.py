"""Serving surfaces."""
