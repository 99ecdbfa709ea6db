"""The input pipeline of the port."""
