"""Reconstruction losses of the codec head's training."""
