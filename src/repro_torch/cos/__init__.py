"""The object store of the port (no simulator yet)."""
