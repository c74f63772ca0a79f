"""Kernels and tensor ops: each hand-written kernel beside its plain version."""
