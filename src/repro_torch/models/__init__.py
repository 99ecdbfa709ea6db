"""Models of the port: layers, the dense LM and the model registry."""
