"""Parallel training: the mesh of process groups, the collectives (and
``ppermute``), the pipeline schedule, ring attention and the
vocab-parallel cross entropy."""
