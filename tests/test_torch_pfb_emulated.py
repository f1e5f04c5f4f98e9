"""csrc/pfb.cu itself, run on the CPU: the CUDA source compiled with g++
against the emulation of tests/helpers/cuda_emu.py (a block's 256 threads
as coroutines, a warp's lanes in lockstep at every shuffle, every warp at
each __syncthreads before any goes on).  At every channel count the kernel
covers, with a zero tail and with a carried one, over two whole tiles of
the channel-major form and a ragged third (an odd number of rows, so that
runs of odd channels start off 16-byte alignment): the row form against
the plain version at the bar of tests/test_kernels_pfb.py, and the
channel-major form equal to the row form's output transposed, bit for bit.
It checks the index arithmetic of the staging, the stage's swizzle and the
stores, not the card's rounding or speed; chip_smoke.py's check_pfb runs
the same comparisons on the card."""

import subprocess

import numpy as np
import pytest
import torch

from tests.helpers import cuda_emu
from tpu_ofdm_torch.kernels import pfb as tpfb
from tpu_ofdm_torch.spectrum import channelizer as tch

DRIVER_CC = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
extern "C" int pfb_launch(const void*, long long, const void*, long long,
                          const void*, int, int, void*, void*);
extern "C" int pfb_chan_launch(const void*, long long, const void*,
                               long long, const void*, int, int, void*,
                               void*);
// IN OUT N J h n chan: IN holds h tail samples, n samples of x, then the
// (J, N) taps; OUT gets the n output samples
int main(int argc, char** argv) {
  const int N = atoi(argv[3]), J = atoi(argv[4]), chan = atoi(argv[7]);
  const long long h = atoll(argv[5]), n = atoll(argv[6]);
  std::vector<float> head(2 * h + 4), x(2 * n + 4), poly(J * N),
      out(2 * n + 4);
  FILE* f = fopen(argv[1], "rb");
  if (fread(head.data(), 8, h, f) != size_t(h) ||
      fread(x.data(), 8, n, f) != size_t(n) ||
      fread(poly.data(), 4, J * N, f) != size_t(J * N))
    return 2;
  fclose(f);
  const int rc = (chan ? pfb_chan_launch : pfb_launch)(
      h ? head.data() : nullptr, h, x.data(), n, poly.data(), J, N,
      out.data(), nullptr);
  f = fopen(argv[2], "wb");
  fwrite(out.data(), 8, n, f);
  fclose(f);
  return rc;
}
"""

CHANNELS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 384, 512]


def chan_tile_samples(n_chan: int) -> int:
    """csrc/pfb.cu chan_tile_samples<N>: a channel-major CTA's output."""
    return 4096 if n_chan <= 128 else 8192


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated csrc/pfb.cu as an executable."""
    exe = cuda_emu.build(tmp_path_factory.mktemp("pfb_emu"), "pfb.cu",
                         DRIVER_CC)
    if exe is None:
        pytest.skip("no g++ to build the emulated kernels")
    return exe


def _run(exe, x, poly, tail, layout):
    """The emulated channelize_fused(x, poly, tail, layout)."""
    J, N = poly.shape
    h = 0 if tail is None else tail.shape[0]
    path = exe.parent / f"io_{N}_{h}_{layout}"
    with open(f"{path}.in", "wb") as f:
        if h:
            f.write(tail.numpy().tobytes())
        f.write(x.numpy().tobytes())
        f.write(poly.numpy().tobytes())
    subprocess.run([str(exe), f"{path}.in", f"{path}.out", str(N), str(J),
                    str(h), str(x.shape[0]), str(int(layout == "chan"))],
                   check=True, timeout=300)
    out = torch.from_numpy(np.fromfile(f"{path}.out", np.complex64))
    rows = x.shape[0] // N
    return out.reshape((N, rows) if layout == "chan" else (rows, N))


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("n_chan", CHANNELS)
def test_emulated_kernel_both_layouts(emulated, n_chan, carried):
    rows = 2 * (chan_tile_samples(n_chan) // n_chan) + 3
    rng = np.random.RandomState(n_chan + carried)
    poly = torch.as_tensor(tch.polyphase_decompose(
        tch.lowpass_taps(n_chan), n_chan))
    C = tpfb.tail_len(n_chan, poly.shape[0])
    v = (rng.randn(C + rows * n_chan) + 1j * rng.randn(C + rows * n_chan))
    v = torch.as_tensor(v.astype(np.complex64))
    x = v[C:].contiguous()
    tail = v[:C].contiguous() if carried else None
    row = _run(emulated, x, poly, tail, "row")
    want = tpfb.channelize_fused_plain(x, poly, tail)
    np.testing.assert_allclose(row.numpy(), want.numpy(), rtol=0,
                               atol=2e-4 * want.abs().max().item())
    chan = _run(emulated, x, poly, tail, "chan")
    assert chan.shape == (n_chan, rows)
    assert torch.equal(chan, row.t().contiguous())
