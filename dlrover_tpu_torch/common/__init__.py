"""Process-level helpers shared by the port's modules."""
