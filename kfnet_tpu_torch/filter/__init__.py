"""Sequence-level recursive filtering."""
