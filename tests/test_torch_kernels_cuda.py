"""Each CUDA kernel of anet_torch against its plain PyTorch version, on the
card. Imports no JAX, so it runs on a machine with a GPU:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

and skips where torch.cuda.is_available() is false."""

import numpy as np
import pytest
import torch

from anet_torch import kernels as tk
from anet_torch import stream as tstream
from anet_torch.dsp.frame import data_symbols_for_payload
from anet_torch.dsp.pipeline import transmit
from anet_torch.dsp.sync import preamble_waveform
from anet_torch.models import get_model

CFG = get_model("mfsk16-fast").config
PAY = 64
CHUNK = 4096


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products
    return torch.device("cuda")


def _frames(rng, b, pay=PAY, noise=0.3):
    """[T, B] f32 time-major frames at operating noise."""
    payload = rng.integers(0, 256, (b, pay), dtype=np.uint8)
    w = transmit(CFG, payload, device="cpu").numpy()
    w = w + noise * rng.standard_normal(w.shape).astype(np.float32)
    return np.ascontiguousarray(w.T)


def _buffer(rng, starts, length, noise=0.02):
    """[B, length] f32 stream buffers with a frame planted at each start."""
    pay = rng.integers(0, 256, (len(starts), PAY), dtype=np.uint8)
    w = transmit(CFG, pay, device="cpu").numpy()
    buf = noise * rng.standard_normal((len(starts), length)).astype(np.float32)
    for i, s in enumerate(starts):
        n = min(w.shape[1], length - s)
        buf[i, s : s + n] += w[i, :n]
    return buf


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda, dtype):
    """Each CUDA kernel against its plain version on the card: decisions,
    words, CRC counts, servo offsets and search lags bit-equal; energies and
    qualities within rtol 1e-3 (float32 sums in another order)."""
    rng = np.random.default_rng(9)
    n_sym = data_symbols_for_payload(CFG, PAY)
    x = torch.from_numpy(_frames(rng, 300)).to(cuda, dtype)
    pre = CFG.preamble_samples
    got = tk.decide_frame_tm(CFG, x, PAY, preamble_offset=pre)
    want = tk.decide_frame_tm_ref(CFG, x, PAY, preamble_offset=pre)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=1e-3)

    starts = np.array([3, 126, 127, 128, 129, 1000, 4000], np.int32)
    length = tstream._buffer_len(CFG, CHUNK, PAY)
    buf = torch.from_numpy(_buffer(rng, starts, length)).to(cuda, dtype)
    st = torch.from_numpy(starts).to(cuda)
    tpl = preamble_waveform(CFG, device=cuda).to(dtype)
    k = tpl.shape[-1]
    te = float((tpl.float() ** 2).sum())
    seg = buf[:, 1 : 1 + CHUNK + k - 1]
    q, i = tk.sync_search_fused(seg, tpl, CHUNK, te)
    rq, ri = tk.sync_search_fused_ref(seg, tpl, CHUNK, te)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(q, rq, rtol=1e-3, atol=1e-6)
    got = tk.demod_at_fused(CFG, buf, st, n_sym)
    want = tk.demod_at_fused_ref(CFG, buf, st, n_sym)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
    got = tk.demod_probe_fused(CFG, buf, st - 2, n_sym, tpl)
    want = tk.demod_probe_fused_ref(CFG, buf, st - 2, n_sym, tpl)
    for j in (1, 3):
        torch.testing.assert_close(got[j], want[j], rtol=0, atol=0)
    for j in (0, 2, 4, 5):
        torch.testing.assert_close(got[j], want[j], rtol=1e-3, atol=1e-3)
