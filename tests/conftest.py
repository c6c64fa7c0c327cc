def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none "
        "(run on the card with: python -m pytest -q -m cuda "
        "tests/test_torch_cuda.py)")
