def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; skips (inside the test) where none is "
        "available — run on the card with `python -m pytest -m cuda`")
