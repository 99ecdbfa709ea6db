"""The train steps and the serving steps of the port."""
