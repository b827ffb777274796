"""Training and inference steps of the port."""
