"""Models of the port (nn.Modules mirroring rnr_tpu.models)."""
