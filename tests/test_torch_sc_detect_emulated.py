"""csrc/sc_detect.cu itself, run on the CPU: the CUDA source compiled with
g++ against a small emulation of the CUDA surface it uses
(tests/helpers/cuda_emu.py: a warp's 32 lanes take turns at every shuffle
and __syncwarp, cp.async is a plain copy), and held against the plain
version at chip_smoke.py's bars, for each of its three kernels and the
specs that reach their branches.  The emulation runs a warp's lanes as
coroutines of one thread, in lockstep at every shuffle, so it checks the
kernels' index arithmetic, rings and dispatch, not the card's memory
ordering or speed; chip_smoke.py phase 3 runs the same checks on the
card."""

import subprocess

import numpy as np
import pytest
import torch

import tests.golden.golden_ofdm as G
from tests.helpers import cuda_emu
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm_torch.kernels import sc_detect as tk
from tpu_ofdm_torch.ops import sync as tsync

DRIVER_CC = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
extern "C" int sc_detect_launch(const void*, long long, long long,
                                const void*, long long, long long, int, int,
                                int, void*, long long, void*);
// IN OUT B h n L cp: IN holds B rows of h head samples, then B rows of n
int main(int argc, char** argv) {
  const int B = atoi(argv[3]), L = atoi(argv[6]), cp = atoi(argv[7]);
  const long long h = atoll(argv[4]), n = atoll(argv[5]);
  const long long rows = (h + n + 127) / 128;
  std::vector<float> head(2 * B * h + 2), x(2 * B * n), out(6 * B * rows);
  FILE* f = fopen(argv[1], "rb");
  if (fread(head.data(), 8, B * h, f) != size_t(B * h) ||
      fread(x.data(), 8, B * n, f) != size_t(B * n))
    return 2;
  fclose(f);
  const int rc = sc_detect_launch(h ? head.data() : nullptr, h, h, x.data(),
                                  n, n, B, L, cp, out.data(), rows, nullptr);
  f = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
  return rc;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated csrc/sc_detect.cu as an executable."""
    exe = cuda_emu.build(tmp_path_factory.mktemp("sc_detect_emu"),
                         "sc_detect.cu", DRIVER_CC)
    if exe is None:
        pytest.skip("no g++ to build the emulated kernels")
    return exe


def _run(exe, x, head, L, cp):
    """The emulated sc_detect_rows on [head | x] (complex64, (n,) or
    (B, n))."""
    B = x.shape[0] if x.ndim == 2 else 1
    h = 0 if head is None else head.shape[-1]
    path = exe.parent / "io"
    with open(f"{path}.in", "wb") as f:
        if h:
            f.write(head.numpy().tobytes())
        f.write(x.numpy().tobytes())
    subprocess.run([str(exe), f"{path}.in", f"{path}.out", str(B), str(h),
                    str(x.shape[-1]), str(L), str(cp)], check=True,
                   timeout=300)
    rows = -(-(h + x.shape[-1]) // tk.ROW)
    o = torch.from_numpy(np.fromfile(f"{path}.out", np.float32))
    o = o.reshape(6, *x.shape[:-1], rows)
    return (o[0], o[1].view(torch.int32), o[2], o[3], o[4], o[5])


# (fft_len, cp, h, n, B): every kernel and the branches of the segment one
CASES = [
    (64, 16, 3072, 16384, 1),    # the L = 32 kernel
    (96, 24, 0, 16384, 1),       # the any-L kernel (L 48)
    (128, 32, 4096, 16384, 1),   # L 64: a lag of 16 lanes into the last row
    (192, 48, 1001, 16384, 1),   # L 96: one half row between; x unaligned
    (256, 64, 4096, 20000, 1),   # L 128: the last row's registers
    (256, 0, 0, 16384, 1),       # W 1, c 0 (noise alone)
    (256, 64, 1024, 8192, 3),    # a batch
    (320, 80, 5, 20000, 1),      # L 160: shared memory, a lag of 8 lanes
    (512, 128, 4096, 24000, 1),  # L 256: rows between, picks from the ring
    (1024, 256, 0, 32768, 1),    # L 512
    (256, 64, 50, 400, 1),       # shorter than a strip's warm-up
]


@pytest.mark.parametrize("fft_len,cp,h,n,B", CASES)
def test_emulated_kernel_matches_plain(emulated, fft_len, cp, h, n, B):
    """Rows at compare_rows' bars (argmax identical on >= 99% of rows, the
    rest at rtol 1e-4 / atol 1e-5 where it agrees, -inf where the plain
    version has it); where frames lie in the buffer, the selection finds
    each of them, as on the plain rows (a start may sit on a float32 tie
    at fft 1024, as in chip_smoke.check_selection)."""
    L = fft_len // 2
    rng = np.random.RandomState(fft_len + cp + h)
    v = ((rng.randn(B, h + n) + 1j * rng.randn(B, h + n)) * 0.02).astype(
        np.complex64)
    gp = G.GoldenOfdmParams(fft_len=fft_len, cp_len=cp, modulation="qpsk")
    frame = G.tx_frame(gp, bytes(range(40))).astype(np.complex64)
    # no frames at cp 0: a frame's peak there is flat to float32's last
    # bit, and every other row ties it on a 16384-sample buffer
    starts = [] if cp == 0 else list(range(300 + h, h + n - 2 * len(frame),
                                           2 * len(frame)))
    for b in range(B):
        for p in starts:
            v[b, p + b:p + b + len(frame)] += frame
    v = torch.from_numpy(v if B > 1 else v[0])
    x = v[..., h:].contiguous()
    head = v[..., :h].contiguous() if h else None
    got = _run(emulated, x, head, L, cp)
    ref = tk.sc_detect_rows_plain(x, L, cp, head=head)
    same = got[1] == ref[1]
    assert same.float().mean() >= 0.99
    assert torch.equal(torch.isfinite(got[0]), torch.isfinite(ref[0]))
    live = torch.isfinite(ref[0]) & same
    for i in (0, 2, 3, 4, 5):
        m = live if i < 5 else torch.ones_like(live)
        torch.testing.assert_close(got[i][m], ref[i][m], rtol=1e-4,
                                   atol=1e-5)
    if not starts or cp == 0 or B > 1:
        return
    spec = tconfig.OfdmConfig(fft_len=fft_len, cp_len=cp,
                              modulation="qpsk").spec
    n_sm = h + n - fft_len - cp + 1
    sel = [tsync._select_from_rows(spec, *r, n_sm=n_sm,
                                   max_frames=len(starts) + 8,
                                   threshold=spec.cfg.sync_threshold)
           for r in (got, ref)]
    assert torch.equal(sel[0].valid, sel[1].valid)
    ok = sel[1].valid
    assert int(ok.sum()) == len(starts)
    moved = sel[0].start[ok] != sel[1].start[ok]
    assert ((sel[0].start[ok] - sel[1].start[ok]).abs() <= 2).all()
    a, b = sel[0][3][ok][moved], sel[1][3][ok][moved]
    assert ((a - b).abs() <= 2 * torch.finfo(torch.float32).eps
            * b.abs()).all()
