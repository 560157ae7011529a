"""Parallel-training pieces that run on one device (cross entropy)."""
