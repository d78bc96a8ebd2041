"""Training: the stage objectives, the Adam trainer and its loops."""
