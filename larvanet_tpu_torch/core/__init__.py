"""Registries and cascaded flag parsing (counterparts of larvanet_tpu/core)."""
