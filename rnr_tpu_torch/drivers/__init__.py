"""Entry scripts of the port (the per-view pieces of rnr_tpu.drivers)."""
