"""Training steps of the port (``trainer``)."""
