"""PyTorch and CUDA port of the HAPI reproduction in ``repro``.

The package imports ``torch`` and never ``jax``, and nothing of ``repro``.
Its entry points run on the card unless the caller passes ``device="cpu"``.
"""
