"""The port's PMT wire format (tpu_ofdm_torch/io/pmt.py) and PDUs
(io/pdu.py) against the JAX package's: `dumps` is byte-identical for every
case of tests/test_pmt.py and every ndarray dtype, each package reads the
other's bytes, and a JAX UdpPduLink reaches a port link and the reverse
(ports bound to 0)."""

import numpy as np
import pytest

from tests.test_pmt import CASES
from tpu_ofdm.io import pmt as jpmt
from tpu_ofdm.io.pdu import Pdu as JaxPdu
from tpu_ofdm.io.pdu import UdpPduLink as JaxPduLink
from tpu_ofdm_torch.io import pmt
from tpu_ofdm_torch.io.pdu import Pdu, UdpPduLink

DTYPES = [np.uint8, np.int16, np.int32, np.float32, np.float64, np.complex64,
          np.complex128, np.bool_]


@pytest.mark.parametrize("v", CASES, ids=[repr(c)[:30] for c in CASES])
def test_dumps_is_the_jax_bytes(v):
    wire = pmt.dumps(v)
    assert wire == jpmt.dumps(v)
    got = pmt.loads(wire)
    assert got == v and type(got) is type(v)
    assert jpmt.loads(wire) == v


@pytest.mark.parametrize("dtype", DTYPES, ids=[np.dtype(d).name
                                               for d in DTYPES])
def test_ndarray_is_the_jax_bytes(dtype):
    rng = np.random.RandomState(0)
    a = rng.randn(3, 5)
    a = (a + 1j * a if np.issubdtype(dtype, np.complexfloating) else a)
    a = a.astype(dtype)
    wire = pmt.dumps({"psd": a, "meta": {"n": 15}})
    assert wire == jpmt.dumps({"psd": a, "meta": {"n": 15}})
    got = pmt.loads(wire)["psd"]
    assert got.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(got, a)


def test_errors_as_jax():
    with pytest.raises(ValueError, match="trailing"):
        pmt.loads(pmt.dumps(1) + b"x")
    with pytest.raises(TypeError):
        pmt.dumps(object())
    with pytest.raises(TypeError, match="keys must be str"):
        pmt.dumps({1: 2})
    with pytest.raises(ValueError, match="bad pmt type byte"):
        pmt.loads(b"\x7f")


def test_pdu_wire_is_the_jax_bytes():
    p = Pdu(b"payload bytes", {"src": "nodeA", "seq": 7})
    wire = p.to_bytes()
    assert wire == JaxPdu(b"payload bytes", {"src": "nodeA", "seq": 7}) \
        .to_bytes()
    q = Pdu.from_bytes(wire)
    assert q.payload == p.payload and q.meta == p.meta
    assert pmt.loads_pdu(pmt.dumps_pdu({"a": 1}, b"xy")) == ({"a": 1}, b"xy")


@pytest.mark.parametrize("sender,receiver", [(UdpPduLink, JaxPduLink),
                                             (JaxPduLink, UdpPduLink),
                                             (UdpPduLink, UdpPduLink)],
                         ids=["port_to_jax", "jax_to_port", "port_to_port"])
def test_udp_pdu_link_interoperates(sender, receiver):
    rx = receiver(0)
    tx = sender(0, remote=("127.0.0.1", rx.port))
    try:
        tx.send(b"hello", kind="chat", n=1)
        got = rx.receive(timeout=2.0)
        assert got is not None
        assert got.payload == b"hello" and got.meta == {"kind": "chat", "n": 1}
        assert rx.receive(timeout=0.05) is None
    finally:
        tx.close()
        rx.close()
