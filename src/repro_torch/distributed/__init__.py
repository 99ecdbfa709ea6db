"""Collectives of the port: the tier-boundary transfer and the compressed
all-reduce, on ``torch.distributed``."""
