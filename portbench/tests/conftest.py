"""The benchmark's own tests (CPU; `cuda` ones skip without a card)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel on an NVIDIA GPU; skipped without one")
