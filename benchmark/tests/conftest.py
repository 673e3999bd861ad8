"""pytest settings of the benchmark's own tests: the `cuda` marker of the
tests that need a CUDA card (each decides inside the test and skips
without one)."""


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")
