"""The benchmark's tests: CPU tests at small sizes, and tests marked
``card`` that need the CUDA card and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped on a machine without "
        "one (run them there with python -m pytest perfbench/tests -m card)")
