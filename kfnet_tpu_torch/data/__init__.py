"""Synthetic scenes and scene-coordinate labels."""
