def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")
