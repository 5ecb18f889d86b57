"""The benchmark's own tests (run them with `python -m pytest portbench/tests`;
the repository's `pytest tests/` does not collect them). Tests marked `card`
need a CUDA card and skip without one; the fixture decides, never an import."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control at a cell's own size runs on the chip")
    return torch.device("cuda", 0)
