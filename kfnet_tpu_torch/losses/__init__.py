"""Training losses."""
