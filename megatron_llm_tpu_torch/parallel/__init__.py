"""Parallel training: the mesh of process groups, the collectives and
the vocab-parallel cross entropy."""
