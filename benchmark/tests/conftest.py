def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips inside the test when none is present)")
