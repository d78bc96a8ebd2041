"""Functional layer toolkit (conv, group norm, space-to-depth)."""
