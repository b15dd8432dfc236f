def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device and nvcc; skips elsewhere")
