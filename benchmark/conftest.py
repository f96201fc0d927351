"""Pytest settings of the benchmark's own tests (``benchmark/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
