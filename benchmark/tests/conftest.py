"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests marked ``card`` run the benchmark on an NVIDIA card and skip, from
inside the test, where there is none.
"""

import os

# the whole suite holds torch to one thread, as the repository's CPU tests do
os.environ.setdefault("OMP_NUM_THREADS", "1")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: runs on an NVIDIA card; skips without one")
