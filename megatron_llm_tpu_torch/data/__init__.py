"""Samplers and the batch iterator (the port's own copy)."""
