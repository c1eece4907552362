"""Library usage examples of the port (counterparts of examples/*.py)."""
