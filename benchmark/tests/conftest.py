"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.
Tests marked ``cuda`` need a CUDA card and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")
