"""The optimizer of the port."""
