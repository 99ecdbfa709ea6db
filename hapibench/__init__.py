"""The benchmark of ``repro_torch``: HAPI's fine-tune step and its
storage-tier pushdown on one NVIDIA H100, driven by ``BENCHMARK.json``."""
