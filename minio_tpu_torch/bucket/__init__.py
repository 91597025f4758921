"""Per-bucket configuration of the port."""
