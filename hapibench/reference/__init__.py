"""The benchmark's plain reference: float32 PyTorch, TF32 off, importing
nothing of the program."""
