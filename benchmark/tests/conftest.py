"""The benchmark's own tests: ``pytest benchmark/tests`` from the root of
the repository. Tests marked ``card`` need a CUDA card and skip without one
(decided inside the test)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs on a CUDA card; skipped where there is none")
