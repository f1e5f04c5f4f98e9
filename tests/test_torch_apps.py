"""The port's apps (tpu_ofdm_torch/apps/) against the JAX package's, run in
process on the same arguments (the port's with --device cpu): the frames
each prints (status, frame number, start and payload exactly; EVM and
fine CFO, printed to 4 decimals, within 2e-4), the spectrum logger's
snapshots (linear power at 1e-4 * max, the psd kernel's bar; frame counts
and peak bins exactly), the scanner's per-channel powers (printed to 0.1
dB, within 0.1) and flags, and run_flowgraph's printed shapes and saved
output.  With --snr the channel's noise differs by construction
(torch.Generator against jax.random): the frames recovered must still be
the same, their starts within 2 samples.  ofdm_chat and the spectrum
analyzer's local and remote modes run over loopback UDP (ports bound to 0)
in every pairing of the two packages."""

import contextlib
import io
import json
import pathlib
import re
import threading
import time

import numpy as np
import pytest

import tests.golden.golden_ofdm as G
from tpu_ofdm.apps import ofdm_chat as j_chat
from tpu_ofdm.apps import ofdm_loopback as j_loopback
from tpu_ofdm.apps import run_flowgraph as j_run
from tpu_ofdm.apps import spectrum_analyzer as j_analyzer
from tpu_ofdm.apps import spectrum_logger as j_logger
from tpu_ofdm.apps import wideband_scanner as j_scanner
from tpu_ofdm.io import SpectrumSubscriber, UdpSampleLink
from tpu_ofdm_torch.apps import ofdm_chat as t_chat
from tpu_ofdm_torch.apps import ofdm_loopback as t_loopback
from tpu_ofdm_torch.apps import run_flowgraph as t_run
from tpu_ofdm_torch.apps import spectrum_analyzer as t_analyzer
from tpu_ofdm_torch.apps import spectrum_logger as t_logger
from tpu_ofdm_torch.apps import wideband_scanner as t_scanner
from tpu_ofdm_torch.io import file_sink
from tpu_ofdm_torch.spectrum.channelizer import synthesize_bursts

CPU = ["--device", "cpu"]
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
FRAME = re.compile(r"(OK |CRC-FAIL) #\s*(\d+) start=\s*(-?\d+) "
                   r"evm=([-\d.]+) cfo=([-+\d.]+) payload=(.*)")


def _both(capsys, jax_main, port_main, args):
    """(rc, stdout) of the JAX app, then of the port's, on `args`."""
    rc_j = jax_main(list(args))
    out_j = capsys.readouterr().out
    rc_t = port_main(list(args) + CPU)
    out_t = capsys.readouterr().out
    return (rc_j, out_j), (rc_t, out_t)


def _frames(out):
    return [FRAME.match(line).groups() for line in out.splitlines()
            if FRAME.match(line)]


@pytest.mark.parametrize("args,rc,exact_start", [
    (["--frames", "3", "--gap", "300"], 0, True),
    (["--frames", "2", "--snr", "25", "--cfo", "0.1", "--multipath",
      "--modulation", "qam16"], 0, False),
    (["--frames", "2", "--snr", "0", "--modulation", "qam64"], 1, False),
], ids=["clean", "impaired", "low_snr_fails"])
def test_ofdm_loopback_prints_the_jax_frames(capsys, args, rc, exact_start):
    (rc_j, out_j), (rc_t, out_t) = _both(capsys, j_loopback.main,
                                         t_loopback.main, args)
    assert rc_j == rc_t == rc
    fj, ft = _frames(out_j), _frames(out_t)
    if rc:
        # 0 dB: frames are lost in both; which detections survive is noise
        assert sum(f[0] == "OK " for f in ft) < int(args[1])
        return
    assert len(fj) == len(ft) == int(args[1])
    for a, b in zip(fj, ft):
        assert (a[0], a[1], a[5]) == (b[0], b[1], b[5])
        if exact_start:
            assert a[2] == b[2]
            assert abs(float(a[3]) - float(b[3])) <= 2e-4
            assert abs(float(a[4]) - float(b[4])) <= 2e-4
        else:
            assert abs(int(a[2]) - int(b[2])) <= 2


def test_spectrum_logger_writes_the_jax_spectra(tmp_path, capsys):
    args = ["--tone", "0.125", "--fft-len", "256", "--block-size", "8192",
            "--blocks-per-snapshot", "2", "--snapshots", "3",
            "--sample-rate", "1e6"]
    assert j_logger.main(args + ["--out", str(tmp_path / "j")]) == 0
    assert t_logger.main(args + ["--out", str(tmp_path / "t")] + CPU) == 0
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert zt["avg_db"].shape == (3, 256)
    np.testing.assert_array_equal(zt["n_frames"], zj["n_frames"])
    for k in ("avg_db", "max_db"):
        pj, pt = 10.0 ** (zj[k] / 10.0), 10.0 ** (zt[k] / 10.0)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4 * pj.max())
    lj = [json.loads(s) for s in open(tmp_path / "j.jsonl")]
    lt = [json.loads(s) for s in open(tmp_path / "t.jsonl")]
    assert len(lt) == 3
    for a, b in zip(lj, lt):
        assert a["peak_bin"] == b["peak_bin"] == 32      # 0.125 * 256
        assert a["n_frames"] == b["n_frames"]
        assert abs(a["peak_db"] - b["peak_db"]) < 1e-3


def _scan_lines(out):
    return [line.split() for line in out.splitlines()
            if line.startswith("ch ")]


def test_wideband_scanner_power_mode_matches_jax(tmp_path, capsys):
    n_chan = 8
    n = np.arange(n_chan * 4096)
    x = (np.exp(2j * np.pi * 3 / n_chan * n)
         + 0.3 * np.exp(2j * np.pi * 6 / n_chan * n)).astype(np.complex64)
    path = str(tmp_path / "wide.c64")
    w, c = file_sink(path)
    w(x)
    c()
    args = ["--file", path, "--channels", str(n_chan), "--blocks", "4",
            "--block-size", str(n_chan * 1024), "--threshold", "-20"]
    (rc_j, out_j), (rc_t, out_t) = _both(capsys, j_scanner.main,
                                         t_scanner.main, args)
    assert rc_j == rc_t == 0
    lj, lt = _scan_lines(out_j), _scan_lines(out_t)
    assert len(lt) == n_chan
    for a, b in zip(lj, lt):
        assert a[1] == b[1] and a[3:] == b[3:]           # channel and flag
        assert abs(float(a[2]) - float(b[2])) <= 0.1
    assert [b[1] for b in lt if b[-1] == "*"] == ["3", "6"]


def test_wideband_scanner_demod_mode_matches_jax(tmp_path, capsys):
    """Frames on channels 2 and 5 of an 8-channel capture, through both
    scanners' demod mode: the same frames printed."""
    n_chan, per_chan = 8, 8192
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    frame = G.tx_frame(gp, bytes(range(40)), 7).astype(np.complex64)
    wide = synthesize_bursts(n_chan * per_chan, n_chan, [
        (2, 300, frame * n_chan), (5, 4000, frame * n_chan)])
    rng = np.random.RandomState(1)
    wide = wide + 0.01 * (rng.randn(len(wide)) + 1j * rng.randn(len(wide)))
    path = str(tmp_path / "frames.c64")
    w, c = file_sink(path)
    w(wide.astype(np.complex64))
    c()
    args = ["--file", path, "--channels", str(n_chan), "--blocks", "8",
            "--demod"]
    (rc_j, out_j), (rc_t, out_t) = _both(capsys, j_scanner.main,
                                         t_scanner.main, args)
    assert rc_j == rc_t == 0
    lj = [line for line in out_j.splitlines() if line.startswith("ch ")]
    lt = [line for line in out_t.splitlines() if line.startswith("ch ")]
    assert len(lt) == 2 and lt[0].startswith("ch   2 frame    7")
    assert lt[1].startswith("ch   5 frame    7")
    for a, b in zip(lj, lt):
        pa, pb = a.split("evm="), b.split("evm=")
        assert pa[0] == pb[0] and pa[1][7:] == pb[1][7:]
        assert abs(float(pa[1][:6]) - float(pb[1][:6])) <= 2e-4


@pytest.mark.parametrize("example,args,db", [
    ("psd_probe", ["--tone", "0.125", "--block-size", "2048"], [0, 1, 2]),
    ("decimate_and_measure", ["--tone", "0.25", "--block-size", "4096"],
     [0]),
], ids=["psd_probe", "decimate_and_measure"])
def test_run_flowgraph_matches_jax(tmp_path, capsys, example, args, db):
    """The printed lines (less the rate) and the saved final output: dB
    leaves as linear power at 1e-4 * max; the DDC at 1e-3 (its float32
    mixer phase)."""
    spec = str(EXAMPLES / f"{example}.json")
    common = [spec, *args, "--steps", "3", "--print-output"]
    assert j_run.main(common + ["--save-output", str(tmp_path / "j.npz")]) \
        == 0
    out_j = capsys.readouterr().out
    assert t_run.main(common + ["--save-output", str(tmp_path / "t.npz")]
                      + CPU) == 0
    out_t = capsys.readouterr().out
    lj, lt = out_j.splitlines(), out_t.splitlines()
    assert lt[0] == lj[0] and "compiled" in lt[0]
    assert lt[1].split(", ")[:2] == lj[1].split(", ")[:2]    # not the rate
    assert lt[2] == lj[2]                                # shapes and dtypes
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(zj.files) == sorted(zt.files)
    tol = 1e-3 if example == "decimate_and_measure" else 1e-4
    for i in range(len(zj.files)):
        a, b = zt[f"out_{i}"], zj[f"out_{i}"]
        assert a.dtype == b.dtype and a.shape == b.shape
        if i in db:
            a, b = 10.0 ** (a / 10.0), 10.0 ** (b / 10.0)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(1.0, np.abs(b).max()))


def _free_port() -> int:
    probe = UdpSampleLink(0)
    port = probe.port
    probe.close()
    return port


def _in_thread(fn, args):
    box = {}
    t = threading.Thread(target=lambda: box.update(rc=fn(args)), daemon=True)
    t.start()
    return t, box


CHAT = ["hello over the air", "second message"]


@pytest.mark.parametrize("sender,listener", [
    ("jax", "jax"), ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_ofdm_chat_over_udp_as_jax(capsys, sender, listener):
    """ofdm_chat send -> listen over loopback UDP (tests/test_apps.py's
    arguments; the port's with --device cpu): every pairing of the two
    packages prints both messages with their frame numbers, as the JAX
    pair does."""
    apps = {"jax": (j_chat.main, []), "port": (t_chat.main, CPU)}
    port = _free_port()
    listen_main, listen_dev = apps[listener]
    t, box = _in_thread(listen_main, [
        "listen", "--port", str(port), "--messages", "2", "--timeout", "30",
        "--block-size", "8192", *listen_dev])
    time.sleep(1.0)                                  # listener socket up
    send_main, send_dev = apps[sender]
    args = ["send", "--remote-host", "127.0.0.1", "--port", str(port)]
    for m in CHAT:
        args += ["-m", m]
    assert send_main(args + send_dev) == 0
    t.join(timeout=60)
    assert not t.is_alive() and box.get("rc") == 0
    lines = [s for s in capsys.readouterr().out.splitlines()
             if s.startswith("[")]
    assert lines == [f"[{i}] {m}" for i, m in enumerate(CHAT)]


ANALYZER = ["--tone", "0.25", "--fft-len", "128", "--block-size", "8192",
            "--blocks", "40", "--frame-rate", "1000", "--center-freq", "1e6",
            "--sample-rate", "4e6"]


def _published(local_main, extra):
    """The first 3 spectrum frames a local worker publishes, received by a
    SpectrumSubscriber of the JAX package."""
    sub = SpectrumSubscriber(bind_port=0)
    t, box = _in_thread(local_main, ["local", *ANALYZER, "--port",
                                     str(sub.port), *extra])
    try:
        frames = [sub.receive(timeout=20) for _ in range(3)]
    finally:
        t.join(timeout=60)
        sub.close()
    assert not t.is_alive() and box.get("rc") == 0
    assert all(fr is not None for fr in frames)
    return frames


def test_spectrum_analyzer_local_publishes_the_jax_spectra():
    """Both local workers on the same tone: the first frame (one push of
    64 frames) equal in linear power at 1e-4 * max (the psd kernel's
    bar), the same frame counts and peak bin (0.25 * 128), max-hold at or
    above the average."""
    want = _published(j_analyzer.main, [])
    got = _published(t_analyzer.main, CPU)
    g, w = got[0], want[0]
    assert (g.seq, g.n_frames, g.center_freq, g.sample_rate) == \
        (w.seq, w.n_frames, w.center_freq, w.sample_rate) == (0, 64, 1e6, 4e6)
    for a, b in ((g.avg_db, w.avg_db), (g.max_db, w.max_db)):
        pa, pb = 10.0 ** (a / 10.0), 10.0 ** (b / 10.0)
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-4 * pb.max())
    for fr in got:
        assert int(np.argmax(fr.avg_db)) == 32
        assert (fr.max_db >= fr.avg_db - 1e-3).all()


@pytest.mark.parametrize("worker,client", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_spectrum_analyzer_local_remote_pair(capsys, worker, client):
    """tests/test_apps.py's local/remote pair, in every pairing with the
    port: the client renders 3 frames and returns 0."""
    apps = {"jax": (j_analyzer.main, []), "port": (t_analyzer.main, CPU)}
    port = _free_port()
    local_main, local_dev = apps[worker]
    t, box = _in_thread(local_main, ["local", *ANALYZER, "--port", str(port),
                                     *local_dev])
    try:
        rc = apps[client][0](["remote", "--port", str(port), "--frames", "3",
                              "--timeout", "20", "--width", "40"])
    finally:
        t.join(timeout=60)
    assert rc == 0 and box.get("rc") == 0
    lines = [s for s in capsys.readouterr().out.splitlines() if "MHz" in s]
    assert len(lines) >= 3
    assert all("-1.000..    3.000 MHz" in s for s in lines), lines


def _announced_port(err, t, timeout=30.0) -> int:
    """The port that an app run with --port 0 names on stderr once bound."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and t.is_alive():
        m = re.search(r"on udp port (\d+)", err.getvalue())
        if m:
            return int(m.group(1))
        time.sleep(0.01)
    raise AssertionError(f"no port announced: {err.getvalue()!r}")


@pytest.mark.parametrize("app", ["ofdm_chat", "spectrum_analyzer"])
def test_port_zero_receiver_announces_its_port(capsys, app):
    """The port's receiving apps (chat listen, analyzer remote) bind a free
    port with --port 0 and name it on stderr once bound; the JAX sender
    started after the announcement reaches them with nothing lost."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        if app == "ofdm_chat":
            t, box = _in_thread(t_chat.main, [
                "listen", "--port", "0", "--messages", "2", "--timeout", "30",
                "--block-size", "8192", *CPU])
            port = _announced_port(err, t)
            args = ["send", "--remote-host", "127.0.0.1", "--port", str(port)]
            for m in CHAT:
                args += ["-m", m]
            assert j_chat.main(args) == 0
        else:
            t, box = _in_thread(t_analyzer.main, [
                "remote", "--port", "0", "--frames", "3", "--timeout", "20",
                "--width", "40"])
            port = _announced_port(err, t)
            assert j_analyzer.main(["local", *ANALYZER, "--port",
                                    str(port)]) == 0
        t.join(timeout=60)
    assert not t.is_alive() and box.get("rc") == 0
    out = capsys.readouterr().out.splitlines()
    if app == "ofdm_chat":
        assert [s for s in out if s.startswith("[")] == \
            [f"[{i}] {m}" for i, m in enumerate(CHAT)]
    else:
        assert len([s for s in out if "MHz" in s]) == 3


MESH_CHAN, MESH_BINS = 16, 32
MESH = ["mesh", "--tone", "0.25", "--noise", "0.01", "--n-chan",
        str(MESH_CHAN), "--chan-fft-len", str(MESH_BINS), "--block-size",
        str(MESH_CHAN * MESH_BINS * 8), "--blocks", "30", "--frame-rate",
        "1000", "--center-freq", "1e6", "--sample-rate", "4e6"]


def _mesh_published(main, extra):
    """The first 2 consensus frames a mesh worker publishes, received by a
    SpectrumSubscriber of the JAX package (tests/test_apps.py:83-119)."""
    sub = SpectrumSubscriber(bind_port=0)
    t, box = _in_thread(main, [*MESH, "--port", str(sub.port), *extra])
    try:
        frames = [sub.receive(timeout=30) for _ in range(2)]
    finally:
        t.join(timeout=60)
        sub.close()
    assert not t.is_alive() and box.get("rc") == 0
    assert all(fr is not None for fr in frames)
    return frames


@pytest.mark.parametrize("mesh", ["4x2", "1x1"])
def test_spectrum_analyzer_mesh_publishes_the_jax_consensus(mesh):
    """mesh -> remote: the JAX app on its 4x2 virtual mesh and the port's
    on a 4x2 (or 1x1) mesh laid on the CPU (--mesh, --device cpu) publish
    the same full-band consensus: the first frame (one step, deterministic
    where the later ones depend on the publish clock) equal in linear power
    at 1e-4 * max (the psd kernel's bar); the 0.25 fs tone within one bin
    of 3/4 across the band in every frame; max-hold at or above the
    average."""
    want = _mesh_published(j_analyzer.main, [])
    got = _mesh_published(t_analyzer.main, ["--mesh", mesh, *CPU])
    g, w = got[0], want[0]
    assert g.avg_db.shape == w.avg_db.shape == (MESH_CHAN * MESH_BINS,)
    assert (g.seq, g.n_frames, g.center_freq, g.sample_rate) == \
        (w.seq, w.n_frames, w.center_freq, w.sample_rate)
    pg, pw = 10.0 ** (g.avg_db / 10.0), 10.0 ** (w.avg_db / 10.0)
    np.testing.assert_allclose(pg, pw, rtol=0, atol=1e-4 * pw.max())
    for fr in got:
        peak = int(np.argmax(fr.avg_db))
        assert abs(peak - int(0.75 * MESH_CHAN * MESH_BINS)) <= 1
        assert peak == int(np.argmax(w.avg_db))
        assert fr.max_db[peak] >= fr.avg_db[peak] - 1e-3


def test_spectrum_analyzer_mesh_to_port_remote(capsys):
    """The port's remote client (--port 0, named on stderr once bound) fed
    by the port's mesh worker (2x2 on the CPU): it renders 3 frames, and
    both return 0."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        t, box = _in_thread(t_analyzer.main, [
            "remote", "--port", "0", "--frames", "3", "--timeout", "20",
            "--width", "40"])
        port = _announced_port(err, t)
        assert t_analyzer.main([*MESH, "--port", str(port), "--mesh", "2x2",
                                *CPU]) == 0
        t.join(timeout=60)
    assert not t.is_alive() and box.get("rc") == 0
    assert "consensus frames from a 2x2 mesh" in err.getvalue()
    lines = [s for s in capsys.readouterr().out.splitlines() if "MHz" in s]
    assert len(lines) == 3
