"""CPU tests of the benchmark at small sizes; tests that need the card are
marked `card` and skip, inside the test, where there is none:

    python -m pytest portbench/tests -q
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips "
                            "without one)")


def small(name: str):
    """The cell `name` at a size the CPU runs in a second or two: blocks of
    2^16 samples (2^18 wideband), 16 frames or PDUs a block, 32 slots."""
    from portbench import cells

    c = cells.cell(name)
    wide = c.traffic["path"] == "wideband"
    c.config["stream"]["block_size"] = 1 << (18 if wide else 16)
    c.config["stream"]["max_frames_per_block"] = 4 if wide else 32
    for k in ("frames_per_block", "pdus_per_push"):
        if k in c.traffic:
            c.traffic[k] = 16
    c.traffic["trace_pushes"] = 3
    return c


@pytest.fixture
def small_cell():
    return small
