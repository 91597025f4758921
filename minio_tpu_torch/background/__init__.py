"""Background work of the port: admin heal sequences."""
