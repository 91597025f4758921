"""Identity of the port: the root credential only."""
