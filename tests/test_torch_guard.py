"""Guards for the PyTorch port `tpu_ofdm_torch/`:

- it must import without JAX: the GPU machine has no JAX, so a stray
  import would break the port there while every CPU test still passed;
  nor any module of the JAX package, numpy-only ones included;
- its entry points go to the card unless the caller names the CPU;
- the rule of tests/test_docs_drift.py, applied to the port: a rate or
  bandwidth figure in its source must carry a date and the card it was
  measured on (H100) within the 3 lines above it.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_ofdm_torch import config as tconfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "tpu_ofdm_torch"

UNIT = re.compile(r"\d[\d.]*\s*x?\s*(?:G|M)samp(?:les)?/s|\d[\d.]*\s*[GT]B/s"
                  r"|\d[\d.]*\s*TFLOP")
DATE = re.compile(r"20\d\d-\d\d(-\d\d)?")
CONTEXT = 3


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_ofdm_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "tpu_ofdm_torch.__path__, 'tpu_ofdm_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') or "
        "m == 'orbax' or m.startswith('orbax.'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 66, names\n"
        "assert {'tpu_ofdm_torch.grc', 'tpu_ofdm_torch.io.sources', "
        "'tpu_ofdm_torch.apps.run_flowgraph', 'tpu_ofdm_torch.stream.graph', "
        "'tpu_ofdm_torch.runtime', 'tpu_ofdm_torch.io.feed', "
        "'tpu_ofdm_torch.stream.checkpoint', 'tpu_ofdm_torch.shard', "
        "'tpu_ofdm_torch.shard.mesh', 'tpu_ofdm_torch.shard.halo', "
        "'tpu_ofdm_torch.shard.rx', 'tpu_ofdm_torch.shard.wideband', "
        "'tpu_ofdm_torch.shard.distributed', 'tpu_ofdm_torch.shard.dryrun'} "
        "<= set(names), names\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_port_imports_nothing_of_the_jax_package():
    """Not even a numpy-only module of tpu_ofdm: the port keeps its own
    copies (tpu_ofdm_torch/config.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_ofdm_torch\n"
        "for m in pkgutil.walk_packages(tpu_ofdm_torch.__path__, "
        "'tpu_ofdm_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'tpu_ofdm' or "
        "m.startswith('tpu_ofdm.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _executor():
    from tpu_ofdm_torch.modem.rx_stream import rx_stream_block
    from tpu_ofdm_torch.stream.executor import StreamExecutor
    spec = tconfig.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
    sc = tconfig.StreamConfig(block_size=1024, max_frames_per_block=2)
    return StreamExecutor(rx_stream_block(spec, sc), 1024).device


def _empty_tx_in():
    from tpu_ofdm_torch.modem.tx_stream import empty_tx_in
    spec = tconfig.OfdmConfig(modulation="qpsk").spec
    return empty_tx_in(spec, 2).valid.device


def _queue_tx_in():
    from tpu_ofdm_torch.modem.tx_stream import queue_tx_in
    spec = tconfig.OfdmConfig(modulation="qpsk").spec
    return queue_tx_in(spec, 2, [b"to the card"])[0].valid.device


def _apps():
    import argparse

    from tpu_ofdm_torch.apps.common import add_device_arg
    p = argparse.ArgumentParser()
    add_device_arg(p)
    return torch.empty(0, device=p.parse_args([]).device).device


def _device_feed():
    from tpu_ofdm_torch.io import DeviceFeed
    feed = DeviceFeed(iter([np.zeros(8, np.complex64)]))
    (block,) = feed
    return block.device


def _make_mesh():
    from tpu_ofdm_torch.shard import make_mesh
    return make_mesh().devices[0, 0]


def _dryrun():
    """The device the dry run names for its mesh, with none asked for."""
    from tpu_ofdm_torch.shard.dryrun import dryrun_multichip
    line = dryrun_multichip(2)
    return torch.device(re.search(r"shards on (\S+),", line).group(1))


def _global_mesh():
    """global_mesh over a group the caller brought up itself (gloo, one
    rank), which initialize() never saw."""
    import tempfile

    import torch.distributed as dist

    from tpu_ofdm_torch.shard import distributed as D
    saved = dict(D._RUNTIME)
    D._RUNTIME.clear()
    try:
        with tempfile.TemporaryDirectory() as d:
            dist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                                    world_size=1, rank=0)
            try:
                return D.global_mesh().devices[0, 0]
            finally:
                dist.destroy_process_group()
    finally:
        D._RUNTIME.clear()
        D._RUNTIME.update(saved)


def _scan_blocks():
    """A stateless block, whose init names no device, over numpy blocks."""
    from tpu_ofdm_torch.stream import block as B
    from tpu_ofdm_torch.stream.executor import scan_blocks
    b = B.multiply_const(2.0)
    _, y = scan_blocks(b, b.init("cuda"), np.ones((3, 8), np.complex64))
    return y.device


@pytest.mark.parametrize("entry", [_executor, _empty_tx_in, _queue_tx_in,
                                   _apps, _scan_blocks, _device_feed,
                                   _make_mesh, _dryrun, _global_mesh],
                         ids=["StreamExecutor", "empty_tx_in", "queue_tx_in",
                              "apps", "scan_blocks", "DeviceFeed",
                              "make_mesh", "dryrun_multichip",
                              "global_mesh"])
def test_entry_points_default_to_the_card(entry):
    """With no device named, an entry point goes to cuda: where torch has
    no card it raises torch's own error, never falls back to the CPU."""
    if torch.cuda.is_available():
        assert entry().type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            entry()


def test_io_package_imports_no_feed():
    """Importing tpu_ofdm_torch.io starts no feed and touches no CUDA
    state (no thread, no initialized CUDA context: the feed makes its
    stream and pinned buffers when it is constructed), and it exports
    exactly the JAX package's io names."""
    code = (
        "import sys, threading\n"
        "import torch\n"
        "import tpu_ofdm_torch.io as io\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not torch.cuda.is_initialized()\n"
        "names = sorted(n for n in vars(io) if not n.startswith('_'))\n"
        "import tpu_ofdm.io as jio\n"
        "want = sorted(n for n in vars(jio) if not n.startswith('_'))\n"
        "assert names == want, (names, want)\n"
        "assert {'DeviceFeed', 'pmt', 'Pdu', 'PduQueue', 'UdpPduLink', "
        "'UdpSampleLink', 'file_source', 'SpectrumPublisher', "
        "'SpectrumSubscriber', 'pack_spectrum'} <= set(names), names\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|orbax|tpu_ofdm)\b", src, re.M)


@pytest.mark.parametrize("script", ["profile_paths.py", "kernel_ab.py"])
def test_card_scripts_import_no_jax(script):
    """The other scripts that run on the card's machine, which has no
    JAX."""
    src = (ROOT / script).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|orbax|tpu_ofdm)\b", src, re.M)


def test_no_undated_perf_figures_in_port():
    offenders = []
    files = sorted(PKG.rglob("*.py")) + sorted((PKG / "csrc").glob("*.cu*"))
    for path in files:
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if not UNIT.search(line):
                continue
            window = lines[max(0, i - CONTEXT): i + 1]
            if not (any(DATE.search(w) for w in window)
                    and any("H100" in w for w in window)):
                offenders.append(f"{path.relative_to(ROOT)}:{i + 1}: "
                                 f"{line.strip()}")
    assert not offenders, (
        "perf figures in the port's source need a date and 'H100' within "
        f"{CONTEXT} lines (or belong in PERF.md):\n" + "\n".join(offenders))
