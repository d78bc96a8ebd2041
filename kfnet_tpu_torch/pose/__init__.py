"""Batched DLT PnP-RANSAC."""
