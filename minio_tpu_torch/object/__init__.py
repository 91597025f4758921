"""Object layer of the port: ErasureObjects and ErasureSets."""
