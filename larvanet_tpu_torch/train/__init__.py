"""Training pieces of the port (larvanet_tpu/train)."""
