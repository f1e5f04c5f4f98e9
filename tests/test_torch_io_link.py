"""The port's host IO (tpu_ofdm_torch/io) against the JAX package's: the
spectrum transport's datagrams are byte-identical, a JAX SpectrumPublisher
reaches a port SpectrumSubscriber and the reverse (control messages back
too), UdpSampleLink carries a sample block from either package to the
other, and the PDU queue behaves as the JAX one.  Sockets bind port 0."""

import time

import numpy as np
import pytest

import tpu_ofdm.io as jio
import tpu_ofdm_torch.io as tio


def test_pack_is_the_jax_bytes():
    avg = np.linspace(-100, -20, 256).astype(np.float32)
    mx = avg + 5
    wire = tio.pack_spectrum(7, 2.4e9, 10e6, avg, mx, 42, timestamp=123.5)
    assert wire == jio.pack_spectrum(7, 2.4e9, 10e6, avg, mx, 42,
                                     timestamp=123.5)
    fr = tio.unpack_spectrum(wire)
    assert (fr.seq, fr.n_frames, fr.timestamp) == (7, 42, 123.5)
    assert fr.center_freq == 2.4e9 and fr.sample_rate == 10e6
    np.testing.assert_array_equal(fr.avg_db, avg)
    np.testing.assert_array_equal(fr.max_db, mx)
    with pytest.raises(ValueError):
        tio.unpack_spectrum(b"\x00" * 64)


def _poll(pub, tries=40):
    for _ in range(tries):
        msgs = pub.poll_control()
        if msgs:
            return msgs
        time.sleep(0.05)
    return []


@pytest.mark.parametrize("pub_pkg,sub_pkg", [(jio, tio), (tio, jio)],
                         ids=["jax_to_port", "port_to_jax"])
def test_spectrum_transport_interoperates(pub_pkg, sub_pkg):
    sub = sub_pkg.SpectrumSubscriber(bind_port=0)
    pub = pub_pkg.SpectrumPublisher(("127.0.0.1", sub.port))
    try:
        avg = np.full(128, -60.0, np.float32)
        pub.publish(1e9, 5e6, avg, avg + 3, 10)
        fr = sub.receive(timeout=2.0)
        assert fr is not None and fr.center_freq == 1e9 and fr.n_frames == 10
        np.testing.assert_array_equal(fr.max_db, avg + 3)
        sub.send_control({"cmd": "retune", "freq": 1.1e9})
        assert _poll(pub) == [{"cmd": "retune", "freq": 1.1e9}]
    finally:
        pub.close()
        sub.close()


@pytest.mark.parametrize("tx_pkg,rx_pkg", [(jio, tio), (tio, jio), (tio, tio)],
                         ids=["jax_to_port", "port_to_jax", "port_to_port"])
def test_udp_sample_link_interoperates(tx_pkg, rx_pkg):
    rxl = rx_pkg.UdpSampleLink(bind_port=0)
    txl = tx_pkg.UdpSampleLink(bind_port=0, remote=("127.0.0.1", rxl.port))
    try:
        rng = np.random.RandomState(2)
        x = (rng.randn(5000) + 1j * rng.randn(5000)).astype(np.complex64)
        txl.send(x)
        got = rxl.receive(5000, timeout=2.0)
        assert got is not None and got.dtype == np.complex64
        np.testing.assert_array_equal(got, x)
        assert rxl.receive(10, timeout=0.05) is None
    finally:
        txl.close()
        rxl.close()


def test_pdu_queue_as_jax():
    queues = [tio.PduQueue(), jio.PduQueue()]
    for q, Pdu in zip(queues, (tio.Pdu, jio.Pdu)):
        q.post(b"hello", channel=3)
        q.post(Pdu(b"world", {"x": 1}))
        assert len(q) == 2
    got, want = (q.drain() for q in queues)
    assert [(p.payload, p.meta) for p in got] == \
        [(p.payload, p.meta) for p in want]
    assert got[0].meta == {"channel": 3}
    assert queues[0].get(timeout=0.01) is None


def test_bad_arguments_raise():
    """A link with no remote address and a spectrum whose planes differ
    raise (the JAX package's asserts, which -O strips)."""
    for link, payload in ((tio.UdpSampleLink(0), np.zeros(4, np.complex64)),
                          (tio.UdpPduLink(0), b"x")):
        try:
            with pytest.raises(RuntimeError, match="no remote"):
                link.send(payload)
        finally:
            link.close()
    with pytest.raises(ValueError, match="1-D of one length"):
        tio.pack_spectrum(0, 0.0, 1.0, np.zeros(4), np.zeros(5), 1)
