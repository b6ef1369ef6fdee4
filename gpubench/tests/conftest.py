"""The benchmark's own tests: ``python -m pytest gpubench/tests`` from
the root of the repository (on the card: ``-m cuda``).  Nothing here
imports JAX; whether a card is present is decided inside the fixtures."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card; skips inside its fixture where there "
        "is none")
