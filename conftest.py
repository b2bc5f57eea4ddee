"""Repository-wide pytest settings: the marker of tests that need a CUDA card.

Such tests skip on a machine without one (the test itself checks, at run
time); run them on the card with ``python -m pytest tests -m cuda``.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (Triton/CUDA kernels); skips without one"
    )
