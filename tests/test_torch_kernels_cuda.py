"""Each CUDA kernel of anet_torch against its plain PyTorch version, and the
coded, variable-length and one-shot receivers on the card against the same
calls on the CPU. Imports no
JAX, so it runs on a machine with a GPU:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

and skips where torch.cuda.is_available() is false."""

import dataclasses

import numpy as np
import pytest
import torch

from anet_torch import kernels as tk
from anet_torch import stream as tstream
from anet_torch.dsp.frame import data_symbols_for_payload
from anet_torch.dsp.params import ModemConfig
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


def _key(name: str, dtype: torch.dtype) -> str:
    """The launch-count key of a launch of ``name`` on ``dtype`` data (or
    compute): "<name>:int8", "<name>:f32" for the float32 routes of
    kernels.F32_ROUTES, else the name."""
    if dtype == torch.int8:
        return f"{name}:int8"
    return f"{name}:f32" if dtype == torch.float32 and name in tk.F32_ROUTES else name


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
    qualities within rtol 1e-3 (float32 sums in another order);
    decide_frame_tm's float32 frames (the three-term split) as
    _check_split_frame holds them."""
    rng = np.random.default_rng(9)
    n_sym = data_symbols_for_payload(CFG, PAY)
    x = torch.from_numpy(_frames(rng, 300)).to(cuda, dtype)
    pre = CFG.preamble_samples
    got = tk.decide_frame_tm(CFG, x, PAY, preamble_offset=pre)
    want = tk.decide_frame_tm_ref(CFG, x, PAY, preamble_offset=pre)
    if dtype == torch.float32:  # the three-term split
        _check_split_frame(CFG, got, want, x, pre)
    else:
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


SEARCH_DTYPES = {  # (seg, template): one, two and three bf16 products a tile and step
    "bf16-bf16": (torch.bfloat16, torch.bfloat16),
    "bf16-f32": (torch.bfloat16, torch.float32),
    "f32-f32": (torch.float32, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", list(SEARCH_DTYPES))
@pytest.mark.parametrize("out_len", [128, 4736, 11776, 36352])
@pytest.mark.parametrize("k", [512, 1024, 2047, 2048, 6144])
def test_cuda_search_geometries_match_plain_version(cuda, k, out_len, dtypes):
    """The tensor-core search and block maxima at every template length and
    chunk of the paths (k not a multiple of 16 too), on 37 streams (not a
    multiple of a block's rows) whose segments are strided views starting
    at sample 1: lags equal to the plain version's and to the planted ones
    (each stream's peak unique), qualities within rtol 1e-3 (float32 sums in
    another order), the block maxima's maximum bit-equal to the search's
    best."""
    seg_dtype, tpl_dtype = SEARCH_DTYPES[dtypes]
    rng = np.random.default_rng(k + out_len)
    b = 37
    t = rng.standard_normal(k).astype(np.float32)
    lags = rng.integers(0, out_len, b)
    buf = rng.standard_normal((b, out_len + k + 40)).astype(np.float32)
    for s, lag in enumerate(lags):
        buf[s, 1 + lag : 1 + lag + k] += 3.0 * t
    tpl = torch.from_numpy(t).to(cuda, tpl_dtype)
    te = float((tpl.float() ** 2).sum())
    seg = torch.from_numpy(buf).to(cuda, seg_dtype)[:, 1 : out_len + k]
    assert seg.stride(0) != seg.shape[1] and seg.data_ptr() % 16
    q, i = tk.sync_search_fused(seg, tpl, out_len, te)
    rq, ri = tk.sync_search_fused_ref(seg, tpl, out_len, te)
    assert torch.equal(i, ri) and torch.equal(i.cpu(), torch.from_numpy(lags).int())
    torch.testing.assert_close(q, rq, rtol=1e-3, atol=1e-6)
    bm = tk.sync_search_blockmax(seg, tpl, out_len, te)
    torch.testing.assert_close(bm, tk.sync_search_blockmax_ref(seg, tpl, out_len, te), rtol=1e-3, atol=1e-6)
    assert torch.equal(bm.amax(-1), q)
    assert torch.equal(bm.argmax(-1).int(), i // 128)


CODED = get_model("mfsk4-coded").config


@pytest.mark.cuda
@pytest.mark.parametrize("n,t_steps,noise", [(1, 23, 0.0), (130, 358, 0.7), (37, 2150, 1.0), (5, 9500, 0.8)])
def test_cuda_viterbi_matches_plain_version(cuda, n, t_steps, noise):
    """The trellis kernel against its plain version, every decided bit
    equal: short, frame-length and 9,500 steps (the length that once took a
    separate device-memory path; every length now keeps its decision words
    in device memory, 32 steps to a word)."""
    from anet_torch.dsp import fec

    rng = np.random.default_rng(t_steps)
    data = rng.integers(0, 2, (n, t_steps - fec.CONV_TAIL_BITS), dtype=np.uint8)
    coded = fec.conv_encode(torch.from_numpy(data)).numpy()
    rx = (coded * 2.0 - 1.0 + rng.normal(0, noise, coded.shape)).astype(np.float32)
    rx = torch.from_numpy(rx.reshape(n, t_steps, 2)).to(cuda)
    signs = torch.from_numpy(fec._branch_signs()).to(cuda)
    before = tk.launch_counts["viterbi_trellis"]
    got = tk.viterbi_trellis(signs, rx)
    assert tk.launch_counts["viterbi_trellis"] == before + 1
    torch.cuda.synchronize()
    want = tk.viterbi_trellis_ref(signs, rx)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert torch.equal(tk.viterbi_trellis(signs, torch.zeros_like(rx)), torch.zeros_like(got))  # all ties
    if noise == 0.0:
        assert np.array_equal(got.cpu().numpy()[:, : data.shape[1]], data)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", ["mfsk4-coded", "mfsk16-fast"])
def test_cuda_coded_path_kernels_match_plain_versions(cuda, dtype, model):
    """demod_at_energies_fused and probe_at_fused against their plain
    versions on the card, starts on the row residues 124..127: energies and
    qualities within rtol 1e-3 (float32 sums in another order, fused
    multiply-adds), winning tones and lags equal."""
    cfg = get_model(model).config
    rng = np.random.default_rng(13)
    n_sym = data_symbols_for_payload(cfg, PAY)
    starts = np.array([3, 126, 127, 128, 129, 1000, 4000], np.int32)
    length = tstream._buffer_len(cfg, CHUNK, PAY)
    pay = rng.integers(0, 256, (len(starts), PAY), dtype=np.uint8)
    w = transmit(cfg, pay, device="cpu").numpy()
    buf = 0.1 * rng.standard_normal((len(starts), length)).astype(np.float32)
    for i, s in enumerate(starts):
        buf[i, s : s + w.shape[1]] += w[i]
    buf = torch.from_numpy(buf).to(cuda, dtype)
    st = torch.from_numpy(starts).to(cuda)
    got = tk.demod_at_energies_fused(cfg, buf, st, n_sym)
    want = tk.demod_at_energies_fused_ref(cfg, buf, st, n_sym)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    tpl = preamble_waveform(cfg, device=cuda).to(dtype)
    te = float((tpl.float() ** 2).sum())
    q = tk.probe_at_fused(buf, st - 2, tpl, te)
    rq = tk.probe_at_fused_ref(buf, st - 2, tpl, te)
    torch.testing.assert_close(q, rq, rtol=1e-3, atol=1e-6)
    assert bool((q.argmax(-1) == 2).all()) and float(q.amax(-1).min()) > 0.8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_coded_receivers_match_cpu(cuda, dtype):
    """The coded aligned receiver and the coded locked stream on the card
    (kernels) against the same calls on the CPU (plain versions): payloads
    and verdicts equal at operating noise. The probe kernel serves the
    bfloat16 buffer only; a float32 one takes the plain row-aligned probe,
    as in the reference."""
    from anet_torch.dsp import frame as tframe

    rng = np.random.default_rng(17)
    pay = rng.integers(0, 256, (9, PAY), dtype=np.uint8)
    w = transmit(CODED, pay, device="cpu")
    x = (w + 0.6 * torch.from_numpy(rng.standard_normal(w.shape).astype(np.float32))).T.contiguous()
    on_card = tframe.demodulate_frame_tm(CODED, x.to(cuda), PAY, compute_dtype=dtype, device=cuda)
    on_cpu = tframe.demodulate_frame_tm(CODED, x, PAY, compute_dtype=dtype, device="cpu")
    assert bool(on_card.ok.all()) and np.array_equal(on_card.payload.cpu().numpy(), pay)
    assert torch.equal(on_card.payload.cpu(), on_cpu.payload)
    torch.testing.assert_close(on_card.confidence.cpu(), on_cpu.confidence, rtol=1e-3, atol=1e-5)
    t_frame = w.shape[1]
    cap = torch.zeros(9, -(-(700 + 3 * t_frame + CHUNK) // CHUNK) * CHUNK)
    for i in range(3):
        cap[:, 700 + i * t_frame : 700 + (i + 1) * t_frame] = w
    cap += 0.1 * torch.from_numpy(rng.standard_normal(cap.shape).astype(np.float32))
    before = dict(tk.launch_counts)
    got = tstream.receive_stream(CODED, cap.to(cuda), CHUNK, PAY, lock=True, compute_dtype=dtype, device=cuda)
    n_chunks = cap.shape[1] // CHUNK
    probes = n_chunks if dtype == torch.bfloat16 else 0
    energies = _key("demod_at_energies_fused", dtype)
    for name, n in (("probe_at_fused", probes), (energies, n_chunks), ("viterbi_trellis", n_chunks)):
        assert tk.launch_counts[name] - before[name] == n, name
    assert all(tk.launch_counts[k] == before[k] for k in ("demod_probe_fused", "demod_probe_fused:f32"))
    want = tstream.receive_stream(CODED, cap, CHUNK, PAY, lock=True, compute_dtype=dtype, device="cpu")
    assert int(got.carry.frames_ok.sum()) == 9 * 3
    assert torch.equal(got.steps.detected.cpu(), want.steps.detected)
    det = want.steps.detected
    assert torch.equal(got.steps.frame.payload.cpu()[det], want.steps.frame.payload[det])
    assert torch.equal(got.carry.next_start.cpu(), want.carry.next_start)



@pytest.mark.cuda
@pytest.mark.parametrize("t_steps", [1, 31, 32, 33, 2150, 9500])
def test_cuda_viterbi_step_counts_match_plain_version(cuda, t_steps):
    """Trellis lengths around the kernel's 32-step decision words and the
    paths' lengths, on 37 streams (no multiple of a block's streams): noisy
    soft pairs, all ties (zeros) and a masked tail (zeros past half the
    trellis), every decided bit equal to the plain version's."""
    from anet_torch.dsp import fec

    rng = np.random.default_rng(t_steps)
    noisy = rng.normal(0, 1.0, (37, t_steps, 2)).astype(np.float32)
    masked = noisy.copy()
    masked[:, (t_steps + 1) // 2 :] = 0.0
    signs = torch.from_numpy(fec._branch_signs()).to(cuda)
    for rx in (noisy, np.zeros_like(noisy), masked):
        rx = torch.from_numpy(rx).to(cuda)
        got = tk.viterbi_trellis(signs, rx)
        torch.cuda.synchronize()
        assert got.shape == (37, t_steps) and torch.equal(got, tk.viterbi_trellis_ref(signs, rx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", list(SEARCH_DTYPES))
@pytest.mark.parametrize("out_len", [128, 4736, 11776, 23552, 36352])
@pytest.mark.parametrize("k", [512, 1024, 2047, 2048, 6144])
def test_cuda_correlate_geometries_match_plain_version(cuda, k, out_len, dtypes):
    """correlate_fused on the search's tensor-core core at the search's
    template lengths and chunks (k not a multiple of 16 too) on 37 streams
    whose segments are strided views starting at sample 1: every lag within
    1e-3 of the output's scale (float32 sums of k products in another
    order; float32 operands as bf16 hi + lo), each stream's peak at its
    planted lag."""
    seg_dtype, tpl_dtype = SEARCH_DTYPES[dtypes]
    rng = np.random.default_rng(k + out_len)
    b = 37
    t = rng.standard_normal(k).astype(np.float32)
    lags = rng.integers(0, out_len, b)
    buf = rng.standard_normal((b, out_len + k + 40)).astype(np.float32)
    for s, lag in enumerate(lags):
        buf[s, 1 + lag : 1 + lag + k] += 3.0 * t
    tpl = torch.from_numpy(t).to(cuda, tpl_dtype)
    seg = torch.from_numpy(buf).to(cuda, seg_dtype)[:, 1 : out_len + k]
    assert seg.stride(0) != seg.shape[1] and seg.data_ptr() % 16
    key = _key("correlate_fused", seg_dtype)
    before = tk.launch_counts[key]
    got = tk.correlate_fused(seg, tpl, out_len)
    assert tk.launch_counts[key] == before + 1
    torch.cuda.synchronize()
    want = tk.correlate_fused_ref(seg, tpl, out_len)
    assert got.shape == want.shape == (b, out_len) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * float(want.square().mean().sqrt()))
    assert torch.equal(got.argmax(-1).cpu(), torch.from_numpy(lags))


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", list(SEARCH_DTYPES))
def test_cuda_correlate_reads_zeros_past_a_short_segment(cuda, dtypes):
    """A segment shorter than out_len (so far short of out_len + k - 1), an
    odd out_len and odd rows of out (so no pair store is aligned): the
    samples past the segment read as zeros, as the plain version pads
    them."""
    seg_dtype, tpl_dtype = SEARCH_DTYPES[dtypes]
    rng = np.random.default_rng(11)
    k, out_len = 2048, 4735
    tpl = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(cuda, tpl_dtype)
    buf = torch.from_numpy(rng.standard_normal((5, out_len + k)).astype(np.float32)).to(cuda, seg_dtype)
    seg = buf[:, 1 : out_len - 500]
    got = tk.correlate_fused(seg, tpl, out_len)
    torch.cuda.synchronize()
    want = tk.correlate_fused_ref(seg, tpl, out_len)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * float(want.square().mean().sqrt()))
    assert got[:, : seg.shape[1]].abs().amin() > 0 and not got[:, seg.shape[1] :].any()


# --- templates past the one-shot stage: search_core.cuh's slab route ----------

SEARCH_DTYPES_ALL = {**SEARCH_DTYPES, "f32-bf16": (torch.float32, torch.bfloat16)}


def _one_shot_limit(a_lo: bool, b_lo: bool, out_len: int) -> int:
    """The longest template search_core.cuh's make_geometry stages whole
    for this out_len and dtype pair (its shared-memory sum, mirrored)."""
    n_rows = -(-out_len // 128)
    max_rows = (96 if a_lo or b_lo else 128)
    n_tiles = -(-n_rows // max_rows)
    mt = -(-(-(-n_rows // n_tiles)) // 16) * 16

    def smem(k):
        nks = (k + 127 + 15) // 16
        nb = max(mt - 1 + (16 * nks + 127) // 128, mt + (k + 127) // 128)
        w = 8 * nks + 72
        w += (16 - w) % 32
        return (2 if b_lo else 1) * 2 * w * 4 + (2 if a_lo else 1) * nb * 136 * 2 + (nb + mt) * 4

    k = 1024
    while smem(k + 1) <= 232448:
        k += 1
    return k


@pytest.mark.cuda
@pytest.mark.parametrize("k", ["past", 15360, 61440])
@pytest.mark.parametrize("dtypes", list(SEARCH_DTYPES_ALL))
def test_cuda_search_kernels_past_the_one_shot_stage(cuda, dtypes, k):
    """sync_search_fused, sync_search_blockmax and correlate_fused at
    templates past the one-shot stage's shared memory: one sample past the
    dtype pair's limit, 15,360 (sps 480's preamble) and 61,440 (sps
    1,920's), every (segment, template) dtype pair, on 7 streams whose
    segments are strided views from sample 1 (out_len 4,736: 37 rows,
    not a multiple of a block's): the search's lags equal to the plain
    version's and the planted ones, qualities within rtol 1e-3 (the slab
    route folds its sums every 32 k-steps), the block maxima's maximum
    bit-equal to the search's best, every lag of the correlation within
    1e-3 of its scale, one launch of each."""
    seg_dtype, tpl_dtype = SEARCH_DTYPES_ALL[dtypes]
    out_len, b = 4736, 7
    if k == "past":
        k = _one_shot_limit(seg_dtype == torch.float32, tpl_dtype == torch.float32, out_len) + 1
    rng = np.random.default_rng(k)
    t = rng.standard_normal(k).astype(np.float32)
    lags = rng.integers(0, out_len, b)
    buf = rng.standard_normal((b, out_len + k + 40)).astype(np.float32)
    for i, lag in enumerate(lags):
        buf[i, 1 + lag : 1 + lag + k] += 0.5 * t
    tpl = torch.from_numpy(t).to(cuda, tpl_dtype)
    te = float((tpl.float() ** 2).sum())
    seg = torch.from_numpy(buf).to(cuda, seg_dtype)[:, 1 : out_len + k]
    before = dict(tk.launch_counts)
    q, i = tk.sync_search_fused(seg, tpl, out_len, te)
    bm = tk.sync_search_blockmax(seg, tpl, out_len, te)
    corr = tk.correlate_fused(seg, tpl, out_len)
    assert _launched(before) == {_key(n, seg_dtype): 1 for n in
                                 ("sync_search_fused", "sync_search_blockmax", "correlate_fused")}
    rq, ri = tk.sync_search_fused_ref(seg, tpl, out_len, te)
    assert torch.equal(i, ri) and torch.equal(i.cpu(), torch.from_numpy(lags).int())
    torch.testing.assert_close(q, rq, rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(bm, tk.sync_search_blockmax_ref(seg, tpl, out_len, te), rtol=1e-3, atol=1e-6)
    assert torch.equal(bm.amax(-1), q) and torch.equal(bm.argmax(-1).int(), i // 128)
    want = tk.correlate_fused_ref(seg, tpl, out_len)
    torch.testing.assert_close(corr, want, rtol=1e-3, atol=1e-3 * float(want.square().mean().sqrt()))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [15360, 61440])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_probes_past_shared_memory(cuda, dtype, k):
    """The probes past a block's shared memory (the taps and 8 warps' spans
    of a 15,360- or 61,440-sample preamble), on demod_probe.cu's direct
    kernels: probe_at_fused (float32, bfloat16) within rtol 1e-3 of its
    plain version with every stream's peak at its planted lag, and
    demod_probe_fused's probe (every dtype, a preset's geometry with the
    preamble this long) with the plain version's refined starts."""
    from anet_torch.dsp.sync import preamble_waveform as waveform

    rng = np.random.default_rng(k)
    b, n_lags = 9, 5
    cfg = dataclasses.replace(CFG, preamble_symbols=k // CFG.samples_per_symbol)
    t = waveform(cfg, device="cpu").numpy()
    assert t.shape == (k,)
    n_sym = 4
    length = k + 4096 + n_sym * cfg.samples_per_symbol
    starts = rng.integers(0, 4000, b)
    buf = 0.05 * rng.standard_normal((b, length)).astype(np.float32)
    for i, st in enumerate(starts):
        buf[i, st : st + k] += t
    if dtype == torch.int8:
        buf_t = torch.from_numpy(np.round(buf * 32).clip(-127, 127).astype(np.int8)).to(cuda)
    else:
        buf_t = torch.from_numpy(buf).to(cuda, dtype)
    st0 = torch.from_numpy(starts - 2).int().to(cuda)
    tpl = torch.from_numpy(t).to(cuda, torch.bfloat16 if dtype == torch.bfloat16 else torch.float32)
    if dtype != torch.int8:
        te = float((tpl.float() ** 2).sum())
        q = tk.probe_at_fused(buf_t, st0, tpl, te, n_lags=n_lags)
        torch.testing.assert_close(q, tk.probe_at_fused_ref(buf_t, st0, tpl, te, n_lags=n_lags), rtol=1e-3, atol=1e-6)
        assert bool((q.argmax(-1) == 2).all())
    got = tk.demod_probe_fused(cfg, buf_t, st0, n_sym, tpl, n_lags=n_lags)
    want = tk.demod_probe_fused_ref(cfg, buf_t, st0, n_sym, tpl, n_lags=n_lags)
    assert torch.equal(got[1], want[1]) and bool((got[1] == 2).all())
    torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=1e-3)


LONG_SYMBOL_CONFIGS = {  # 100 and 25 baud: preambles of 15,360 and 61,440 samples
    "sps480": ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=100, num_tones=16, base_freq_hz=600.0),
    "sps1920": ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=25, num_tones=16, base_freq_hz=1000.0),
}
LONG_SYMBOL_MODES = ("lock-f32", "lock-bf16", "search-int8", "dynamic", "dynamic-lock")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", LONG_SYMBOL_MODES)
@pytest.mark.parametrize("geometry", list(LONG_SYMBOL_CONFIGS))
def test_cuda_stream_receivers_at_long_symbols(cuda, geometry, mode):
    """Every stream receiver at sps 480 and 1,920, whose preambles pass the
    one-shot search stage: receive_stream locked on a float32 carry
    (receive_stream's defaults) and on a bfloat16 one (probe_at_fused past
    shared memory), searching on an int8 carry, receive_stream_dynamic
    searching two candidates a chunk (correlate_fused) and locked; 3
    streams of 2 frames each,
    every frame ok with the payload sent, the search (or the correlation)
    launched. The capture-resident scan refuses these geometries, as the
    reference's does (128 % sps != 0)."""
    from anet_torch.dsp.family import frame_samples

    cfg = LONG_SYMBOL_CONFIGS[geometry]
    rng = np.random.default_rng(cfg.samples_per_symbol + len(mode))
    pay_len, b = 16, 3
    chunk = frame_samples(cfg, pay_len) // 128 * 128
    pays = rng.integers(0, 256, (2, b, pay_len), dtype=np.uint8)
    gap0 = 700
    t_frame = frame_samples(cfg, pay_len)
    cap = torch.zeros(b, gap0 + 3 * t_frame + chunk)
    for f in range(2):
        cap[:, gap0 + f * t_frame : gap0 + (f + 1) * t_frame] = transmit(cfg, pays[f], device="cpu")
    cap = torch.nn.functional.pad(cap, (0, -cap.shape[1] % chunk))
    cap += 0.05 * torch.from_numpy(rng.standard_normal(cap.shape).astype(np.float32))
    before = dict(tk.launch_counts)
    if mode.startswith("dynamic"):  # searching: two candidates a chunk, the correlation at every lag
        res = tstream.receive_stream_dynamic(cfg, cap.to(cuda, torch.bfloat16), chunk, pay_len,
                                             compute_dtype=torch.bfloat16, lock=mode == "dynamic-lock",
                                             max_frames_per_chunk=1 if mode == "dynamic-lock" else 2, device=cuda)
    else:
        dtype = {"lock-f32": torch.float32, "lock-bf16": torch.bfloat16, "search-int8": torch.int8}[mode]
        compute = torch.float32 if dtype == torch.float32 else torch.bfloat16
        carry = tstream.init_carry(cfg, chunk, pay_len, (b,), dtype=dtype, device=cuda)
        res = tstream.receive_stream(cfg, cap.to(cuda), chunk, pay_len, carry=carry, compute_dtype=compute,
                                     lock=mode.startswith("lock"), device=cuda)
    launched = _launched(before)
    assert res.carry.frames_ok.tolist() == [2] * b
    det = res.steps.detected.cpu().reshape(-1, b)  # [chunks (x candidates), B]
    payload = res.steps.frame.payload.cpu().reshape(det.shape[0], b, -1)[..., :pay_len]
    for i in range(b):  # each stream's two frames, in either order within a chunk's candidates
        got = sorted(map(bytes, payload[:, i][det[:, i]].numpy()))
        assert got == sorted(map(bytes, pays[:, i])), i
    search = "correlate_fused" if mode == "dynamic" else "sync_search_fused"
    assert launched.get(search, 0) + launched.get(f"{search}:f32", 0) > 0
    if mode == "lock-bf16":
        assert launched.get("probe_at_fused", 0) > 0
    if mode == "lock-f32":
        with pytest.raises(ValueError, match="resident=True"):
            tstream.receive_stream(cfg, cap.to(cuda), chunk, pay_len, lock=True, resident=True, device=cuda)


# --- the variable-length slice's three kernels and its paths ------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dynamic_slice_kernels_match_plain_versions(cuda, dtype):
    """correlate_fused (a strided view, lag counts that are no multiple of
    the 2,048-lag tile, a segment shorter than out_len + k - 1, which reads
    zeros), decide_tones_tm (odd symbol count and batch, a trailing partial
    symbol) and gather_rows_fused (starts at residues 0, 1, 63, 127 mod 128,
    and outside the buffer) against their plain versions on the card.
    Correlations within 1e-3 of the output's scale (float32 sums of k
    products in another order), gathered samples bit-equal, bfloat16 tones
    bit-equal and float32 ones (the three-term split) as
    _check_split_decisions holds them."""
    g = torch.Generator(device=cuda).manual_seed(3)
    tpl = preamble_waveform(CFG, device=cuda).to(dtype)
    k = tpl.shape[-1]
    big = torch.randn(9, 9000, generator=g, device=cuda).to(dtype)
    for seg, out_len in ((big[:, 1 : 1 + 5000 + k - 1], 5000), (big[:, :3000], 2953), (big[:3, 7:2600], 2048)):
        key = _key("correlate_fused", dtype)
        before = tk.launch_counts[key]
        got = tk.correlate_fused(seg, tpl, out_len)
        assert tk.launch_counts[key] == before + 1
        torch.cuda.synchronize()
        want = tk.correlate_fused_ref(seg, tpl, out_len)
        assert got.shape == want.shape == (seg.shape[0], out_len) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * float(want.square().mean().sqrt()))
    x = torch.randn(21 * CFG.samples_per_symbol + 17, 131, generator=g, device=cuda).to(dtype)
    got = tk.decide_tones_tm(CFG, x)
    want = tk.decide_tones_tm_ref(CFG, x)
    assert got[0].shape == (21, 131)
    if dtype == torch.float32:  # the three-term split
        _check_split_decisions([v.T for v in got], _tm_energies(CFG, x, 0, 21))
    else:
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
    assert not tk.decide_tones_tm(CFG, torch.zeros_like(x))[0].any()  # ties: the first tone
    buf = torch.randn(2, 6, 3000, generator=g, device=cuda).to(dtype)
    starts = torch.tensor([[0, 1, 63, 127, 128, 2000], [255, 256, 1000, 1999, -3, 2500]], device=cuda)
    before = tk.launch_counts["gather_rows_fused"]
    got = tk.gather_rows_fused(buf, starts, 1000)
    assert tk.launch_counts["gather_rows_fused"] == before + 1
    want = tk.gather_rows_fused_ref(buf, starts, 1000)
    assert got.dtype == dtype and torch.equal(got, want)
    assert not got[1, 4, :3].any() and not got[1, 5, 500:].any()  # zeros outside the buffer
    with pytest.raises(ValueError):
        tk.gather_rows_fused(buf.transpose(0, 1), starts.T, 10)  # not contiguous
    half = buf.to(torch.float16)  # any 2-byte element moves as it is
    assert torch.equal(tk.gather_rows_fused(half, starts, 1000).view(torch.int16),
                       tk.gather_rows_fused_ref(half, starts, 1000).view(torch.int16))
    with pytest.raises(TypeError):
        tk.gather_rows_fused(buf.to(torch.float64), starts, 10)  # 8-byte elements
    with pytest.raises(ValueError):
        tk.decide_tones_tm(CFG, x.T)


@pytest.mark.cuda
def test_cuda_viterbi_masked_tail_and_header_probe(cuda):
    """The variable-length coded parse's two trellises on the card: a
    max-length trellis whose LLRs past the real tail are zero (hundreds of
    exact ties) and the 102-step unflushed header probe, every bit equal to
    the plain version's."""
    from anet_torch.dsp import fec

    rng = np.random.default_rng(5)
    signs = torch.from_numpy(fec._branch_signs()).to(cuda)
    for n_data, real, noise in ((2144, 8 * 76, 0.7), (2144, 8 * 12, 1.0), (96, 96, 0.5)):
        t_steps = n_data + fec.CONV_TAIL_BITS
        # real < n_data: a shorter frame, tail-flushed, then zeros; else a
        # longer section cut off unflushed (the header probe)
        data = rng.integers(0, 2, (33, real if real < n_data else 400), dtype=np.uint8)
        coded = fec.conv_encode(torch.from_numpy(data)).numpy()
        rx = np.zeros((33, 2 * t_steps), np.float32)
        n = min(coded.shape[1], 2 * t_steps)
        rx[:, :n] = coded[:, :n] * 2.0 - 1.0 + rng.normal(0, noise, (33, n))
        rx = torch.from_numpy(rx.reshape(33, t_steps, 2)).to(cuda)
        got = tk.viterbi_trellis(signs, rx)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.viterbi_trellis_ref(signs, rx))
        if noise < 1.0:
            assert np.array_equal(got.cpu().numpy()[:, : min(real, 64)], data[:, : min(real, 64)])


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mfsk16-fast", "mfsk4-coded-stream"])
def test_cuda_dynamic_receivers_match_cpu(cuda, model):
    """The variable-length streams on the card (kernels) against the same
    calls on the CPU (plain versions): two candidates a chunk and frame
    lock, bf16; detections, declared lengths, payloads, starts and counters
    equal, each path's kernels launched."""
    from anet_torch.dsp import frame as tframe

    cfg = get_model(model).config
    rng = np.random.default_rng(23)
    mx = 48
    t_max = tframe.frame_num_samples(cfg, mx)
    for lens, k, lock in (((8, 8, 48, 24, 8, 8), 2, False), ((8, 48, 24, 8, 48, 24), 1, True)):
        chunk = k * tframe.frame_num_samples(cfg, min(lens)) // 128 * 128
        parts = [torch.zeros(5, 1000)]
        parts += [transmit(cfg, rng.integers(0, 256, (5, n), dtype=np.uint8), device="cpu") for n in lens]
        cap = torch.cat(parts + [torch.zeros(5, t_max + 300)], -1)
        cap = torch.nn.functional.pad(cap, (0, -cap.shape[1] % chunk))
        cap = (cap + 0.05 * torch.from_numpy(rng.standard_normal(cap.shape).astype(np.float32))).to(torch.bfloat16)
        kw = dict(compute_dtype=torch.bfloat16, max_frames_per_chunk=k, lock=lock)
        before = dict(tk.launch_counts)
        got = tstream.receive_stream_dynamic(cfg, cap.to(cuda), chunk, mx, device=cuda, **kw)
        n_chunks = cap.shape[1] // chunk
        launched = {name: tk.launch_counts[name] - before[name] for name in before}
        demod = "demod_at_energies_fused" if cfg.fec == "conv" else "demod_at_fused"
        assert launched[demod] == k * n_chunks
        assert launched["correlate_fused"] == (0 if lock else n_chunks)
        assert launched["probe_at_fused"] == (n_chunks if lock else 0)
        assert launched["viterbi_trellis"] == (2 * k * n_chunks if cfg.fec == "conv" else 0)
        want = tstream.receive_stream_dynamic(cfg, cap, chunk, mx, device="cpu", **kw)
        assert got.carry.frames_ok.tolist() == [len(lens)] * 5
        assert torch.equal(got.steps.detected.cpu(), want.steps.detected)
        det = want.steps.detected
        assert torch.equal(got.steps.frame.payload.cpu()[det], want.steps.frame.payload[det])
        assert torch.equal(got.steps.frame.payload_len.cpu()[det], want.steps.frame.payload_len[det])
        assert torch.equal(got.steps.frame_start.cpu()[det], want.steps.frame_start[det])
        assert torch.equal(got.carry.next_start.cpu(), want.carry.next_start)
        assert torch.equal(got.carry.last_frame_end.cpu(), want.carry.last_frame_end)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_window_and_oneshot_receivers_match_cpu(cuda, dtype):
    """The oversized time-major window (decide_tones_tm) and the one-shot
    receivers on the card against the CPU; aligned_gather(mode="roll")
    launches the gather kernel and equals the default gather bit for bit."""
    from anet_torch.dsp import frame as tframe
    from anet_torch.dsp import pipeline as tpipeline
    from anet_torch.dsp import sync as tsync

    rng = np.random.default_rng(29)
    pay = rng.integers(0, 256, (7, PAY), dtype=np.uint8)
    w = transmit(CFG, pay, device="cpu")
    x = torch.cat([w, torch.zeros(7, 5 * CFG.samples_per_symbol)], -1)
    x = (x + 0.3 * torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))).T.contiguous()
    key = _key("decide_tones_tm", dtype)
    before = tk.launch_counts[key]
    on_card = tframe.demodulate_frame_tm(CFG, x.to(cuda), PAY, compute_dtype=dtype, device=cuda)
    assert tk.launch_counts[key] == before + 1
    on_cpu = tframe.demodulate_frame_tm(CFG, x, PAY, compute_dtype=dtype, device="cpu")
    assert bool(on_card.ok.all()) and np.array_equal(on_card.payload.cpu().numpy(), pay)
    torch.testing.assert_close(on_card.confidence.cpu(), on_cpu.confidence, rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(on_card.snr_db.cpu(), on_cpu.snr_db, rtol=1e-3, atol=1e-3)

    starts = torch.tensor([0, 1, 63, 127, 128, 777, 1999])
    cap = 0.2 * torch.from_numpy(rng.standard_normal((7, w.shape[1] + 7000)).astype(np.float32))
    cap.scatter_add_(1, starts[:, None] + torch.arange(w.shape[1]), w)
    cap = cap.to(dtype)
    got = tpipeline.receive_frame(CFG, cap.to(cuda), PAY, device=cuda)
    want = tpipeline.receive_frame(CFG, cap, PAY, device="cpu")
    assert torch.equal(got.sync.offset.cpu(), starts.int()) and torch.equal(want.sync.offset, starts.int())
    assert bool(got.frame.ok.all()) and torch.equal(got.frame.payload.cpu(), want.frame.payload)
    torch.testing.assert_close(got.sync.quality.cpu(), want.sync.quality, rtol=1e-3, atol=1e-5)
    dyn = tpipeline.receive_frame_dynamic(CFG, cap.to(cuda), 100, device=cuda)
    dyn_cpu = tpipeline.receive_frame_dynamic(CFG, cap, 100, device="cpu")
    assert torch.equal(dyn.offset.cpu(), starts.int()) and bool((dyn.frame.payload_len == PAY).all())
    assert bool(dyn.frame.ok.all()) and torch.equal(dyn.frame.payload.cpu(), dyn_cpu.frame.payload)
    before = tk.launch_counts["gather_rows_fused"]
    rolled = tsync.aligned_gather(cap.to(cuda), starts.to(cuda), w.shape[1], mode="roll")
    assert tk.launch_counts["gather_rows_fused"] == before + 1
    assert torch.equal(rolled, tsync.aligned_gather(cap.to(cuda), starts.to(cuda), w.shape[1]))
    assert tk.launch_counts["gather_rows_fused"] == before + 1  # the default gather launches none
    cap8 = tstream.quantize_int8(cap.float()).to(cuda)  # an int8 carry's samples, moved as they are
    before8 = tk.launch_counts["gather_rows_fused:int8"]
    rolled8 = tsync.aligned_gather(cap8, starts.to(cuda), w.shape[1], mode="roll")
    assert tk.launch_counts["gather_rows_fused:int8"] == before8 + 1
    assert rolled8.dtype == torch.int8 and torch.equal(rolled8, tsync.aligned_gather(cap8, starts.to(cuda), w.shape[1]))


def _resample_ppm(x, ppm):
    """Band-limited resample of a waveform to a receiver clock ``ppm`` parts
    per million off (the DFT interpolant at t * (1 + ppm 1e-6)), cut or
    padded to the input's length."""
    n = len(x)
    coef = np.fft.rfft(np.asarray(x, np.float64))
    coef[1:-1] *= 2
    t = np.arange(n) * (1 + ppm * 1e-6)
    out = (np.exp(2j * np.pi * np.outer(t, np.arange(len(coef))) / n) @ coef).real / n
    return np.where(t < n, out, 0.0).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["ofdm-fast", "ofdm-turbo", "ofdm-max"])
def test_cuda_ofdm_kernel_and_receivers_match_cpu(cuda, model):
    """ofdm_track_decide_fused on the card against its plain version on
    drifted frames (+-150 ppm) and clean-clock ones, tracked and untracked:
    LLRs rtol 1e-4 of their scale wherever the identity gate agrees, gates
    parting only within 1e-4 of a tie and never on a drifted frame, evm2
    rtol 1e-4; then the batch- and time-major receivers on the card, which
    launch it once each, decode the payloads the CPU decodes."""
    import dataclasses

    from anet_torch.dsp import ofdm

    cfg = get_model(model).config
    rng = np.random.default_rng(41)
    pay = rng.integers(0, 256, (6, 128), dtype=np.uint8)
    ppms = np.array([150, -150, 120, 0, 0, -100])
    w = ofdm.transmit(cfg, pay, device="cpu").numpy()
    x = np.stack([_resample_ppm(r, p) for r, p in zip(w, ppms)])
    x = x + 0.01 * rng.standard_normal(x.shape).astype(np.float32)
    s_data = cfg.data_symbols_for_payload(128)
    for c in (cfg, dataclasses.replace(cfg, clock_tracking=False)):
        xt = torch.from_numpy(x)
        carriers = ofdm._extract_carriers(c, xt[:, c.preamble_samples :], 1 + s_data)
        z_eq, h_pow = ofdm._equalize(c, carriers)
        slope0 = ofdm.preamble_phase_slope(c, xt)
        before = tk.launch_counts["ofdm_track_decide_fused"]
        got = tk.ofdm_track_decide_fused(c, z_eq.to(cuda), h_pow.to(cuda), slope0.to(cuda), with_coherence=True)
        assert tk.launch_counts["ofdm_track_decide_fused"] == before + 1
        want = tk.ofdm_track_decide_fused_ref(c, z_eq, h_pow, slope0, with_coherence=True)
        llrs, ref = got[0].cpu().numpy(), want[0].numpy()
        close = np.isclose(llrs, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max()).all(-1)
        coh, parted = want[2].numpy(), ~close
        assert not parted[np.abs(ppms) >= 100].any()
        if c.clock_tracking:
            assert (np.abs(coh[parted, 0] - coh[parted, 1]) < 1e-4).all()
        else:
            assert close.all()
        np.testing.assert_allclose(got[1].cpu().numpy()[close], want[1].numpy()[close], rtol=1e-4)
        np.testing.assert_allclose(got[2].cpu().numpy(), coh, rtol=1e-4, atol=1e-6)
    before = tk.launch_counts["ofdm_track_decide_fused"]
    on_card = ofdm.demodulate_frame(cfg, torch.from_numpy(x).to(cuda), 128, device=cuda)
    tm = ofdm.demodulate_frame_tm(cfg, torch.from_numpy(x).T.contiguous().to(cuda), 128, device=cuda)
    assert tk.launch_counts["ofdm_track_decide_fused"] == before + 2
    on_cpu = ofdm.demodulate_frame(cfg, x, 128, device="cpu")
    assert bool(on_cpu.ok.all()) and bool(on_card.ok.all()) and bool(tm.ok.all())
    assert np.array_equal(on_card.payload.cpu().numpy(), pay) and np.array_equal(tm.payload.cpu().numpy(), pay)
    torch.testing.assert_close(on_card.confidence.cpu(), on_cpu.confidence, rtol=1e-4, atol=0)


# --- the fifth slice: int8 instantiations, the batch-major filterbank, the ----
# --- block maxima ---------------------------------------------------------------


def _quantized(x):
    from anet_torch.stream import quantize_int8

    return quantize_int8(torch.as_tensor(x))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mfsk16-fast", "mfsk4-coded"])
def test_cuda_int8_kernels_match_plain_versions(cuda, model):
    """The int8 instantiations against their plain versions on the card:
    the I/Q sums are exact integers in both and I*I + Q*Q is rounded
    after each operation in both, so words, CRC counts, tones, offsets,
    energies, best and cmax are bit-equal; sums over tones and symbols in
    another order within rtol 1e-5. int8 launches count under their own
    keys."""
    cfg = get_model(model).config
    rng = np.random.default_rng(81)
    n_sym = data_symbols_for_payload(cfg, PAY)
    before = dict(tk.launch_counts)
    if cfg.fec == "none":
        pay = rng.integers(0, 256, (300, PAY), dtype=np.uint8)
        w = transmit(cfg, pay, device="cpu").numpy()
        w = w + 0.3 * rng.standard_normal(w.shape).astype(np.float32)
        x8 = torch.from_numpy(np.round(w.T * (127.0 / np.abs(w).max())).astype(np.int8)).to(cuda).contiguous()
        pre = cfg.preamble_samples
        got = tk.decide_frame_tm(cfg, x8, PAY, preamble_offset=pre)
        want = tk.decide_frame_tm_ref(cfg, x8, PAY, preamble_offset=pre)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    starts = np.array([3, 126, 127, 128, 129, 1000, 4000], np.int32)
    length = tstream._buffer_len(cfg, CHUNK, PAY)
    pay = rng.integers(0, 256, (len(starts), PAY), dtype=np.uint8)
    w = transmit(cfg, pay, device="cpu").numpy()
    buf = 0.05 * rng.standard_normal((len(starts), length)).astype(np.float32)
    for i, s in enumerate(starts):
        buf[i, s : s + w.shape[1]] += w[i]
    buf8 = _quantized(buf).to(cuda)
    st = torch.from_numpy(starts).to(cuda)
    got = tk.demod_at_fused(cfg, buf8, st, n_sym)
    want = tk.demod_at_fused_ref(cfg, buf8, st, n_sym)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    e = tk.demod_at_energies_fused(cfg, buf8, st, n_sym)
    assert torch.equal(e, tk.demod_at_energies_fused_ref(cfg, buf8, st, n_sym))
    assert torch.equal(e.argmax(-1).int(), got[0])
    tpl = preamble_waveform(cfg, device=cuda).to(torch.bfloat16)
    got = tk.demod_probe_fused(cfg, buf8, st - 2, n_sym, tpl)
    want = tk.demod_probe_fused_ref(cfg, buf8, st - 2, n_sym, tpl)
    assert bool((got[1] == 2).all())
    for j in (0, 1, 3, 4):
        assert torch.equal(got[j], want[j]), j
    for j in (2, 5):
        torch.testing.assert_close(got[j], want[j], rtol=1e-5, atol=0)
    torch.cuda.synchronize()
    launched = {k: tk.launch_counts[k] - before[k] for k in before if tk.launch_counts[k] != before[k]}
    expect = {"demod_at_fused:int8": 1, "demod_at_energies_fused:int8": 1, "demod_probe_fused:int8": 1}
    if cfg.fec == "none":
        expect["decide_frame_tm:int8"] = 1
    assert launched == expect


def _bm_config(name):
    """A preset, or a custom config "sps<S>-m<M>" off every walk (_custom)."""
    if name.startswith("sps"):
        sps, m = name.removeprefix("sps").split("-m")
        return _custom(int(sps), int(m))
    return get_model(name).config


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", ["mfsk16-fast", "mfsk4-coded", "mfsk32-dense", "mfsk8-audible", "sps40-m4",
                                   "sps96-m8"])
def test_cuda_batch_major_filterbank_matches_plain_versions(cuda, dtype, model):
    """tone_energies_fused and decide_tones_fused on the data sections of
    whole batch-major frames (a strided view past the preamble): bfloat16
    compute with tones and argmaxes equal, energies within rtol 1e-5
    (float32 sums in another order); float32 compute within the stated
    tolerance of its route (_check_split); then demodulate_frame on the card
    against the CPU. The presets take the tensor cores (mfsk32-dense's 32
    tones and mfsk8-audible's 48 samples a symbol too); the
    custom sps-40 and sps-96 configs filterbank_any.cu's runtime-geometry
    walk, on the tensor cores too, whose launches count under
    filterbank_any. Launches under each route's key."""
    from anet_torch.dsp import frame as tframe

    cfg = _bm_config(model)
    rng = np.random.default_rng(83)
    pay = rng.integers(0, 256, (257, PAY), dtype=np.uint8)
    w = transmit(cfg, pay, device="cpu")
    x = (w + 0.3 * torch.from_numpy(rng.standard_normal(w.shape).astype(np.float32))).to(cuda)
    data = x[:, cfg.preamble_samples :]
    if tk._filterbank_tensor_core_geometry(cfg):
        keys = (_key("tone_energies_fused", dtype), _key("decide_tones_fused", dtype))
    else:
        keys = (_key("filterbank_any", dtype),) * 2
    before = dict(tk.launch_counts)
    if dtype == torch.float32:  # the stated tolerance of the float32-compute route
        _check_split(cfg, data)
    else:
        e = tk.tone_energies_fused(cfg, data, compute_dtype=dtype)
        want = tk.tone_energies_fused_ref(cfg, data, compute_dtype=dtype)
        assert torch.equal(e.argmax(-1), want.argmax(-1))
        torch.testing.assert_close(e, want, rtol=1e-5, atol=1e-5 * float(want.max()))
        got = tk.decide_tones_fused(cfg, data, compute_dtype=dtype)
        ref = tk.decide_tones_fused_ref(cfg, data, compute_dtype=dtype)
        assert torch.equal(got[0], ref[0])
        for a, b in zip(got[1:], ref[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    on_card = tframe.demodulate_frame(cfg, x, PAY, compute_dtype=dtype, device=cuda)
    on_cpu = tframe.demodulate_frame(cfg, x.cpu(), PAY, compute_dtype=dtype, device="cpu")
    assert bool(on_card.ok.all()) and torch.equal(on_card.payload.cpu(), on_cpu.payload)
    torch.cuda.synchronize()
    if keys[0] == keys[1]:
        assert tk.launch_counts[keys[0]] - before[keys[0]] == 3
    else:
        assert tk.launch_counts[keys[0]] - before[keys[0]] == 2
        assert tk.launch_counts[keys[1]] - before[keys[1]] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_search_blockmax_matches_plain_version(cuda, dtype):
    """The block maxima against the plain version (rtol 1e-3: float32 sums
    in another order over bf16 or float32 inputs), and against the search
    kernel: the maximum over blocks is its best quality, the winning block
    holds its lag."""
    rng = np.random.default_rng(85)
    starts = np.array([3, 126, 127, 128, 129, 1000, 4000], np.int32)
    length = tstream._buffer_len(CFG, CHUNK, PAY)
    buf = torch.from_numpy(_buffer(rng, starts, length)).to(cuda, dtype)
    tpl = preamble_waveform(CFG, device=cuda).to(dtype)
    k = tpl.shape[-1]
    te = float((tpl.float() ** 2).sum())
    seg = buf[:, 1 : 1 + CHUNK + k - 1]
    key = _key("sync_search_blockmax", dtype)
    before = tk.launch_counts[key]
    got = tk.sync_search_blockmax(seg, tpl, CHUNK, te)
    assert tk.launch_counts[key] == before + 1
    want = tk.sync_search_blockmax_ref(seg, tpl, CHUNK, te)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-6)
    q, i = tk.sync_search_fused(seg, tpl, CHUNK, te)
    torch.testing.assert_close(got.amax(-1), q, rtol=1e-6, atol=0)
    assert torch.equal(got.argmax(-1).int(), i // 128)
    assert torch.equal(i.cpu(), torch.from_numpy(starts - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_search_reads_no_template_energy_to_the_host(cuda, dtype):
    """Both searches with the template energy as the stream passes it (a
    float32 scalar on the card, summed there) under
    torch.cuda.set_sync_debug_mode("error"), for the stream's template and
    for a fresh one (its words made on this call): no value read to the
    host, no wait for the card, and bits equal to the float form's."""
    rng = np.random.default_rng(86)
    starts = np.array([3, 126, 127, 128, 129, 1000, 4000], np.int32)
    length = tstream._buffer_len(CFG, CHUNK, PAY)
    buf = torch.from_numpy(_buffer(rng, starts, length)).to(cuda, dtype)
    template, t_c = tstream._templates(CFG, dtype, cuda)
    fresh = t_c.clone()
    k = t_c.shape[-1]
    seg = buf[:, 1 : 1 + CHUNK + k - 1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [(tk.sync_search_fused(seg, t, CHUNK, (template * template).sum()),
                tk.sync_search_blockmax(seg, t, CHUNK, (template * template).sum()))
               for t in (t_c, fresh)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    te = float((template * template).sum())
    want_q, want_i = tk.sync_search_fused(seg, t_c, CHUNK, te)
    want_bm = tk.sync_search_blockmax(seg, t_c, CHUNK, te)
    for (q, i), bm in got:
        assert torch.equal(q, want_q) and torch.equal(i, want_i) and torch.equal(bm, want_bm)
    assert torch.equal(want_i.cpu(), torch.from_numpy(starts - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mfsk16-fast", "mfsk4-coded"])
def test_cuda_int8_receivers_match_cpu(cuda, model):
    """The int8 locked stream on the card (mfsk16-fast: the merged kernel's
    int8 instantiation, and the search; mfsk4-coded: the plain row-aligned
    probe, as the reference probes an int8 buffer, and the int8 energies) and the int8 aligned receiver, against the
    same calls on the CPU: payloads, detections and lock state equal."""
    from anet_torch.dsp import frame as tframe

    cfg = get_model(model).config
    rng = np.random.default_rng(87)
    pay = rng.integers(0, 256, (9, PAY), dtype=np.uint8)
    w = transmit(cfg, pay, device="cpu")
    if cfg.fec == "none":
        x = (w + 0.3 * torch.from_numpy(rng.standard_normal(w.shape).astype(np.float32))).T.contiguous()
        x8 = torch.round(x * (127.0 / x.abs().max())).to(torch.int8)
        on_card = tframe.demodulate_frame_tm(cfg, x8.to(cuda), PAY, compute_dtype=torch.int8, device=cuda)
        on_cpu = tframe.demodulate_frame_tm(cfg, x8, PAY, compute_dtype=torch.int8, device="cpu")
        assert bool(on_card.ok.all()) and np.array_equal(on_card.payload.cpu().numpy(), pay)
        torch.testing.assert_close(on_card.confidence.cpu(), on_cpu.confidence, rtol=1e-5, atol=0)
    t_frame = w.shape[1]
    cap = torch.zeros(9, -(-(700 + 3 * t_frame + CHUNK) // CHUNK) * CHUNK)
    for i in range(3):
        cap[:, 700 + i * t_frame : 700 + (i + 1) * t_frame] = w
    cap += 0.1 * torch.from_numpy(rng.standard_normal(cap.shape).astype(np.float32))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        carry = tstream.init_carry(cfg, CHUNK, PAY, (9,), dtype=torch.int8, device=dev)
        runs.append(tstream.receive_stream(
            cfg, cap.to(dev), CHUNK, PAY, carry=carry, lock=True, compute_dtype=torch.bfloat16, device=dev
        ))
    got, want = runs
    assert int(got.carry.frames_ok.sum()) == 9 * 3
    assert torch.equal(got.carry.buffer.cpu(), want.carry.buffer)
    assert torch.equal(got.steps.detected.cpu(), want.steps.detected)
    det = want.steps.detected
    assert torch.equal(got.steps.frame.payload.cpu()[det], want.steps.frame.payload[det])
    assert torch.equal(got.carry.next_start.cpu(), want.carry.next_start)


# --- the align+demod kernels on the tensor cores ------------------------------

DEMOD_CONFIGS = {  # sps and tone count of each n-tile count and k-step count
    "fsk2-robust": get_model("fsk2-robust").config,  # sps 128, 2 tones
    "mfsk4-coded": get_model("mfsk4-coded").config,  # sps 32, 4 tones
    "mfsk8-sps64": dataclasses.replace(CFG, num_tones=8),
    "mfsk16-fast": CFG,  # sps 64, 16 tones
    "mfsk16-ultra": get_model("mfsk16-ultra").config,  # sps 32, 16 tones
    "mfsk16-sps128": dataclasses.replace(CFG, symbol_rate_hz=375),
}


def _demod_buffer(cfg, rng, n_sym, length, dtype, device):
    """A [B, length] buffer (noise 0.3, a frame at each start) whose rows
    start one element past a 16-byte boundary, and the starts: the data
    section at every residue mod 16, one span half past the buffer's end,
    one wholly past it and one beginning before the row's start."""
    sps, pre = cfg.samples_per_symbol, cfg.preamble_samples
    starts = [200 + r for r in range(16)]
    starts += [length - pre - (n_sym * sps) // 2 - 3, length, -pre - 2 * sps - 5]
    pay = rng.integers(0, 256, (len(starts), PAY), dtype=np.uint8)
    w = transmit(cfg, pay, device="cpu").numpy()
    x = 0.3 * rng.standard_normal((len(starts), length)).astype(np.float32)
    for i, s in enumerate(starts):
        lo, hi = max(s, 0), min(s + w.shape[1], length)
        if lo < hi:
            x[i, lo:hi] += w[i, lo - s : hi - s]
    x = torch.from_numpy(x)
    x = _quantized(x) if dtype == torch.int8 else x.to(dtype)
    flat = torch.zeros(x.numel() + 1, dtype=dtype, device=device)
    flat[1:] = x.reshape(-1).to(device)
    return flat[1:].view(x.shape), torch.tensor(starts, dtype=torch.int32, device=device)


def _split_tol(w, scale):
    """The three-term split's stated tolerance: kernels.F32_SPLIT_RTOL of the
    plain value plus F32_SPLIT_ATOL of its symbol's largest plain energy."""
    return tk.F32_SPLIT_RTOL * w.abs() + tk.F32_SPLIT_ATOL * scale


def _check_split_decisions(got, energies):
    """Decisions (tone, best, total) of demod_at.cu's float32 route (the
    three-term bf16 split) against the plain energies [B, S, M] of the same
    spans, with the split's stated tolerance: best and total within
    kernels.F32_SPLIT_RTOL of themselves plus F32_SPLIT_ATOL of the
    symbol's largest plain energy, tones equal but where the plain
    version's two largest energies lie that close. Returns the count of
    such near-ties among symbols with energy."""
    tone, best, total = got
    scale, total_w = energies.amax(-1), energies.sum(-1)
    top2 = energies.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= _split_tol(top2[..., 0], top2[..., 0])
    assert bool(((tone == energies.argmax(-1).int()) | near).all())
    assert bool(((best - scale).abs() <= _split_tol(scale, scale)).all())
    assert bool(((total - total_w).abs() <= _split_tol(total_w, scale)).all())
    return int((near & (scale > 0)).sum())


def _check_split_energies(got, energies):
    """Energies [B, S, M] of demod_at_energies.cu's float32 route (the
    three-term bf16 split) against the plain ones of the same spans: each
    within kernels.F32_SPLIT_RTOL of itself plus F32_SPLIT_ATOL of its
    symbol's largest plain energy, the argmax equal but where the plain
    version's two largest energies lie that close."""
    scale = energies.amax(-1, keepdim=True)
    assert bool(((got - energies).abs() <= _split_tol(energies, scale)).all())
    top2 = energies.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= _split_tol(top2[..., 0], top2[..., 0])
    assert bool(((got.argmax(-1) == energies.argmax(-1)) | near).all())


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("n_sym", [1, 15, 17, 67])
@pytest.mark.parametrize("geometry", list(DEMOD_CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_demod_at_kernels_at_every_residue(cuda, dtype, geometry, n_sym, ragged):
    """demod_at_fused and demod_at_energies_fused against their plain
    versions at data starts of every residue mod 16 (the tensor-core span
    read's funnel shifts), a span past the buffer's end, one wholly past it,
    one before the row's start, rows that start off a 16-byte boundary and,
    ``ragged``, a row length that leaves every other row off one too;
    n_symbols not a multiple of the kernels' tiles; every sps (32, 64,
    128) and n-tile count (2, 4, 8, 16 tones). Tones and argmaxes equal;
    int8 (exact int32 I/Q, energies rounded after each operation): best and
    energies bit-equal, total within rtol 1e-5; bfloat16: best, total and
    energies within rtol 1e-3 (float32 sums in another order); float32
    (both kernels the three-term split): demod_at_fused's best and total
    and demod_at_energies_fused's energies within the split's stated
    tolerance, tones and argmaxes equal but at near-ties
    (_check_split_decisions, _check_split_energies). One launch each, int8
    and float32 under their own keys."""
    cfg = DEMOD_CONFIGS[geometry]
    rng = np.random.default_rng(n_sym + 7 * len(geometry))
    length = 4096 + (5 if ragged else 0)
    buf, st = _demod_buffer(cfg, rng, n_sym, length, dtype, cuda)
    keys = (_key("demod_at_fused", dtype), _key("demod_at_energies_fused", dtype))
    before = dict(tk.launch_counts)
    got = tk.demod_at_fused(cfg, buf, st, n_sym)
    energies = tk.demod_at_energies_fused(cfg, buf, st, n_sym)
    torch.cuda.synchronize()
    assert all(tk.launch_counts[k] == before[k] + 1 for k in keys)
    want = tk.demod_at_fused_ref(cfg, buf, st, n_sym)
    want_e = tk.demod_at_energies_fused_ref(cfg, buf, st, n_sym)
    if dtype == torch.float32:
        _check_split_decisions(got, want_e)
        _check_split_energies(energies, want_e)
    else:
        assert torch.equal(energies.argmax(-1).int(), want[0])
        assert torch.equal(got[0], want[0])
    if dtype == torch.int8:
        assert torch.equal(got[1], want[1]) and torch.equal(energies, want_e)
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    elif dtype == torch.bfloat16:
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(energies, want_e, rtol=1e-3, atol=1e-3)
    assert not bool(want_e[-2].any())  # the span wholly past the end reads zeros


# --- the merged probe + demod: a warp-per-stream probe, then demod_at's kernel --


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("n_lags", [1, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_demod_probe_at_every_residue(cuda, dtype, n_lags, ragged):
    """demod_probe_fused against its plain version at probe bases of every
    residue mod 16 and at 124..127 mod 128, a probe window and a demod span
    past the row's end, a demod span alone past it, a window before the
    row's start, rows that start 3 samples past a 16-byte boundary and,
    ``ragged``, a row length that leaves the other rows off one too; one
    stream loud enough that its int8 window energy passes 2**24. Offsets
    and tones equal; int8 (exact int32 sums): cmax and best bit-equal, the
    energy the exact sum rounded once (bit-equal to the plain version's
    wherever that float32 sum is exact, below 2**24), total within rtol
    1e-5; float32 and bfloat16: cmax and energy within rtol 1e-3 (float32
    sums in another order); bfloat16: best and total within rtol 1e-3;
    float32 (demod_at.cu's three-term split at the refined starts): tones,
    best and total by the split's stated tolerance and near-tie rule
    (_check_split_decisions). One launch counted under the kernel's key and
    none under demod_at_fused's; B = 0 launches nothing."""
    from anet_torch.dsp.sync import gather_span

    rng = np.random.default_rng(3 * n_lags + ragged)
    n_sym = data_symbols_for_payload(CFG, PAY)
    sps, pre = CFG.samples_per_symbol, CFG.preamble_samples
    tpl = preamble_waveform(CFG, device=cuda).to(torch.bfloat16)
    k = tpl.shape[-1]
    length = tstream._buffer_len(CFG, CHUNK, PAY) + (5 if ragged else 0)
    lag = n_lags // 2  # the planted frame's lag in the servo window
    st0 = [200 + r for r in range(16)] + [128 * 7 + r for r in range(124, 128)]
    st0 += [length - k // 2, length - pre - (n_sym * sps) // 2, -3, 1000]
    starts = np.array(st0) + lag
    pay = rng.integers(0, 256, (len(st0), PAY), dtype=np.uint8)
    w = transmit(CFG, pay, device="cpu").numpy()
    x = 0.1 * rng.standard_normal((len(st0), length)).astype(np.float32)
    for i, s in enumerate(starts):
        lo, hi = max(s, 0), min(s + w.shape[1], length)
        x[i, lo:hi] += w[i, lo - s : hi - s]
    x[-1] *= 40.0  # int8: saturated samples, a window energy past 2**24
    x = torch.from_numpy(x)
    x = _quantized(x) if dtype == torch.int8 else x.to(dtype)
    flat = torch.zeros(x.numel() + 3, dtype=dtype, device=cuda)
    flat[3:] = x.reshape(-1).to(cuda)
    buf = flat[3:].view(x.shape)
    st = torch.tensor(st0, dtype=torch.int32, device=cuda)

    key = _key("demod_probe_fused", dtype)
    before = dict(tk.launch_counts)
    got = tk.demod_probe_fused(CFG, buf, st, n_sym, tpl, n_lags=n_lags)
    torch.cuda.synchronize()
    launched = {n: tk.launch_counts[n] - before[n] for n in before if tk.launch_counts[n] != before[n]}
    assert launched == {key: 1}
    want = tk.demod_probe_fused_ref(CFG, buf, st, n_sym, tpl, n_lags=n_lags)
    assert torch.equal(got[1], want[1])
    if dtype == torch.float32:
        _check_split_decisions(got[3:], tk.demod_at_energies_fused_ref(CFG, buf, st + want[1], n_sym))
    else:
        assert torch.equal(got[3], want[3])
    assert bool((got[1][:20] == lag).all())  # the planted frames, wholly inside the row
    if dtype == torch.int8:
        assert torch.equal(got[0], want[0]) and torch.equal(got[4], want[4])
        torch.testing.assert_close(got[5], want[5], rtol=1e-5, atol=0)
        span = gather_span(buf, st.long() // 128 * 128, tk._probe_span_rows(k, n_lags) * 128)
        exact = (span.double() ** 2).sum(-1)
        assert float(exact[-1]) > 2**24
        assert torch.equal(got[2], exact.float())
        below = exact < 2**24
        assert torch.equal(got[2][below], want[2][below])
    else:
        for j in (0, 2) if dtype == torch.float32 else (0, 2, 4, 5):
            torch.testing.assert_close(got[j], want[j], rtol=1e-3, atol=1e-3)

    before = dict(tk.launch_counts)
    empty = tk.demod_probe_fused(CFG, buf[:0], st[:0], n_sym, tpl, n_lags=n_lags)
    assert [tuple(t.shape) for t in empty] == [(0,), (0,), (0,), (0, n_sym), (0, n_sym), (0, n_sym)]
    assert tk.launch_counts == before


# --- decide_frame_tm on the tensor cores: every geometry and edge ------------

FRAME_CONFIGS = {  # sps, tones and bits a symbol of each n-tile count and k-step count
    "fsk2-robust": get_model("fsk2-robust").config,  # sps 128, 2 tones, bps 1
    "mfsk4-sps32": dataclasses.replace(get_model("mfsk4-coded").config, fec="none"),  # sps 32, 4 tones
    "mfsk4-sps64": dataclasses.replace(CFG, num_tones=4),  # sps 64, 4 tones, bps 2
    "mfsk16-fast": CFG,  # sps 64, 16 tones, bps 4
    "mfsk16-ultra": get_model("mfsk16-ultra").config,  # sps 32, 16 tones
    "mfsk16-sps128": dataclasses.replace(CFG, symbol_rate_hz=375),  # sps 128, 16 tones
}
FRAME_BATCHES = (1, 7, 8, 100, 129, 1000)  # rows off 16 bytes unless B is a multiple of 8 (16 int8, 4 float32)


def _frame_case(cfg, rng, b, dtype, offset, extra, pay=7):
    """Time-major [T, B] frames of ``dtype`` whose data section starts at row
    ``offset`` (0: the data section alone; the preamble length: whole
    frames; else that many noise rows before it), followed by ``extra``
    more symbols (copies of the first data symbols, so every symbol has a
    clear winner) and nothing after them."""
    sps, pre = cfg.samples_per_symbol, cfg.preamble_samples
    payload = rng.integers(0, 256, (b, pay), dtype=np.uint8)
    w = transmit(cfg, payload, device="cpu").numpy()
    data = w[:, pre:]
    head = w[:, :pre] if offset == pre else rng.standard_normal((b, offset)).astype(np.float32)
    x = np.concatenate([head, data, data[:, : extra * sps]], -1)
    x = x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(x.T))
    if dtype == torch.int8:
        return torch.round(x * (127.0 / x.abs().max())).to(torch.int8)
    return x.to(dtype)


def _tm_energies(cfg, x, row0, n_symbols, basis_dtype=torch.float32):
    """The plain energies [B, S, M] of the time-major rows' n_symbols
    symbols from row row0: the basis that meets samples of ``basis_dtype``
    (float32 by default; bf16-rounded for bfloat16), a float32 product."""
    sps, m = cfg.samples_per_symbol, cfg.num_tones
    w = x[row0 : row0 + n_symbols * sps].float().reshape(n_symbols, sps, -1)
    iq = torch.einsum("mk,skb->bsm", tk._plain_basis(cfg, basis_dtype, x.device).T, w)
    return iq[..., :m] * iq[..., :m] + iq[..., m:] * iq[..., m:]


def _check_split_frame(cfg, got, want, x, offset):
    """decide_frame_tm's float32 route (the three-term bf16 split) against
    its plain version ``want`` on the same frames, with the split's stated
    tolerance: each symbol's tone (from the packed words) equal to the
    plain energies' argmax but where their two largest lie within
    kernels.F32_SPLIT_RTOL of themselves plus F32_SPLIT_ATOL of the largest
    (a silent symbol's tone the first); words equal but in a tile where a
    tone parted, CRC counts equal but in a stream where one did; the best
    and total sums within F32_SPLIT_RTOL of the plain sums (taken in
    float64) plus F32_SPLIT_ATOL of the sum of the symbols' largest
    energies, conf (their ratio, summed) within 2 (F32_SPLIT_RTOL +
    F32_SPLIT_ATOL) of itself. Returns the count of near-ties among
    symbols with energy."""
    words, crc, qual, s = got
    bps, sb = cfg.bits_per_symbol, tk.TM_SYMBOL_TILE
    energies = _tm_energies(cfg, x, offset, s)
    place = (sb - 1 - torch.arange(sb, device=x.device)) * bps
    data = ((words.long()[:, None, :] >> place[None, :, None]) & ((1 << bps) - 1)).reshape(-1, words.shape[1])
    tone = (data ^ (data >> 1))[:s].T  # binary -> Gray: the tone [B, S]
    scale = energies.amax(-1)
    top2 = energies.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= _split_tol(top2[..., 0], top2[..., 0])
    parted = tone != energies.argmax(-1)
    assert bool((~parted | near).all()) and not bool(tone[scale == 0].any())
    assert not data[s:].any()  # padded symbols: data 0
    tiles = torch.nn.functional.pad(parted, (0, -s % sb)).reshape(parted.shape[0], -1, sb).any(-1).T
    assert torch.equal(words[~tiles], want[0][~tiles])
    streams = parted.any(1)
    assert torch.equal(crc[:, ~streams], want[1][:, ~streams])
    e = energies.double()
    best, total = e.amax(-1), e.sum(-1)
    conf = (best / total.clamp_min(1e-20)).sum(1)
    best, total, scale = best.sum(1), total.sum(1), best.sum(1)
    assert bool(((qual[1] - best).abs() <= _split_tol(best, scale)).all())
    assert bool(((qual[2] - total).abs() <= _split_tol(total, scale)).all())
    assert bool(((qual[0] - conf).abs() <= 2 * (tk.F32_SPLIT_RTOL + tk.F32_SPLIT_ATOL) * conf).all())
    assert not qual[3:].any()
    return int((near & (energies.amax(-1) > 0)).sum())


def _check_frame_tm(cuda, cfg, x, pay, offset, dtype, name="decide_frame_tm"):
    """One launch of decide_frame_tm on ``x`` (under ``name``'s key: the
    walk's, or frame_tm_any's off it; none elsewhere), held against the
    plain version: bfloat16 and int8 words and CRC counts bit-equal, qual
    within rtol 1e-5 (atol 0) for int8 (exact I/Q, sums in another order)
    and for frame_tm_any's bfloat16 (bf16 products exact, float32 sums in
    another order), 1e-3 for the walk's bfloat16; float32 (the three-term
    split) as _check_split_frame holds it."""
    key = _key(name, dtype)
    before = dict(tk.launch_counts)
    got = tk.decide_frame_tm(cfg, x, pay, preamble_offset=offset)
    torch.cuda.synchronize()
    launched = {n: tk.launch_counts[n] - before[n] for n in before if tk.launch_counts[n] != before[n]}
    assert launched == {key: 1}
    want = tk.decide_frame_tm_ref(cfg, x, pay, preamble_offset=offset)
    assert got[3] == want[3]
    if dtype == torch.float32:
        _check_split_frame(cfg, got, want, x, offset)
        return got
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if dtype == torch.int8 or name == "frame_tm_any":
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    else:
        torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=1e-3)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b", FRAME_BATCHES)
@pytest.mark.parametrize("geometry", list(FRAME_CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_decide_frame_tm_every_geometry(cuda, monkeypatch, dtype, geometry, b):
    """decide_frame_tm against its plain version at sps 32, 64 and 128,
    2, 4 and 16 tones (bits a symbol 1, 2 and 4), B from 1 to 1,000 (rows
    off a 16-byte boundary where B is not a multiple of 8, or 16 for
    int8, 4 for float32), preamble offsets 0, odd and the preamble's
    length, and
    n_symbols at every residue 1..7 mod 8 past the frame's own (the
    geometry given extra symbols); the data section ends at the last row."""
    cfg = FRAME_CONFIGS[geometry]
    case = FRAME_BATCHES.index(b) + 6 * list(FRAME_CONFIGS).index(geometry)
    rng = np.random.default_rng(case)
    offset = (0, 3, 37, cfg.preamble_samples)[case % 4]
    extra = 1 + (1 + case % 7 - data_symbols_for_payload(cfg, 7) - 1) % 8  # n_symbols = 1 + case % 7 mod 8
    geometry_of = tk._frame_geometry

    def longer(config, t, payload_len, preamble_offset):
        s, n_tiles, nb = geometry_of(config, t - extra * config.samples_per_symbol, payload_len, preamble_offset)
        s += extra
        return s, -(-s // tk.TM_SYMBOL_TILE), nb

    monkeypatch.setattr(tk, "_frame_geometry", longer)
    x = _frame_case(cfg, rng, b, dtype, offset, extra).to(cuda)
    got = _check_frame_tm(cuda, cfg, x, 7, offset, dtype)
    assert got[3] % tk.TM_SYMBOL_TILE == 1 + case % 7 and x.shape[0] == offset + got[3] * cfg.samples_per_symbol


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["zeros", "saturated"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_decide_frame_tm_every_tie_and_extreme(cuda, dtype, fill):
    """An all-zero input (every symbol ties: tone 0, data 0, zero counts
    and sums) and a saturated +-127 input (int8: I/Q at their largest,
    still exact in int32), B = 129, on mfsk16-fast and fsk2-robust."""
    rng = np.random.default_rng(7 + len(fill))
    for cfg in (CFG, FRAME_CONFIGS["fsk2-robust"]):
        t = cfg.preamble_samples + data_symbols_for_payload(cfg, PAY) * cfg.samples_per_symbol
        if fill == "zeros":
            x = torch.zeros(t, 129, dtype=dtype)
        else:
            x = torch.from_numpy(rng.choice(np.array([-127, 127], np.int8), (t, 129)))
            x = x if dtype == torch.int8 else (x.float() / 127.0).to(dtype)
        got = _check_frame_tm(cuda, cfg, x.to(cuda), PAY, cfg.preamble_samples, dtype)
        if fill == "zeros":
            assert not got[0].any() and not got[1].any() and not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_decide_frame_tm_many_tiles_a_block(cuda, dtype, ragged):
    """The main path's batch, B = 16,384 (16,383 ragged), payload 256: few
    blocks a column of streams, so each walks many symbol tiles, carries
    its CRC counts and quality sums across them and adds them once. 256
    noisy frames tiled across the batch."""
    rng = np.random.default_rng(11 + ragged)
    x = _frame_case(CFG, rng, 256, dtype, CFG.preamble_samples, 0, pay=256).to(cuda).repeat(1, 64)
    if ragged:
        x = x[:, 1:].contiguous()
    _check_frame_tm(cuda, CFG, x, 256, CFG.preamble_samples, dtype)


# --- the batch-major filterbank on the tensor cores: every residue and edge --


def _custom(sps, m):
    """A config of ``sps`` samples and ``m`` tones a symbol at 48 kHz, tones
    from half the symbol rate."""
    rate = 48_000 // sps
    return ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=rate, num_tones=m, base_freq_hz=rate / 2)


# DEMOD_CONFIGS, and the filterbank's own geometry past the other walks'
# (kernels._filterbank_tensor_core_geometry): sps 48 and 80 (3 and 5
# k-steps) and 32 tones (8 n-tiles, the basis in shared memory)
BM_CONFIGS = {
    **DEMOD_CONFIGS,
    "mfsk8-audible": get_model("mfsk8-audible").config,  # sps 48, 8 tones
    "mfsk32-dense": get_model("mfsk32-dense").config,  # sps 80, 32 tones
    "sps48-m16": _custom(48, 16),
    "sps80-m4": _custom(80, 4),
    "sps64-m32": _custom(64, 32),
    "sps128-m32": _custom(128, 32),
}

BM_LEADS = ((1,), (7,), (257,), (2, 3))  # the rows' leading shape
BM_SYMBOLS = (1, 15, 16, 17, 67)
GAP = 1.0e4  # samples between rows and before the first: a read of them would show


def _bm_rows(cfg, rng, device, lead, n_sym, strided, offset, fill="frames", dtype=torch.bfloat16):
    """``dtype`` rows [*lead, n_sym * sps (+ 5 when ``strided``)] in one flat
    allocation that ends with the last row. Contiguous: back to back,
    ``offset`` samples (filled with GAP) into the allocation, so every row is
    at that residue mod 8. Strided: an odd pitch of two symbols and 3
    samples (GAP) more than the row, a partial symbol after the whole ones,
    so the rows pass through every residue. ``fill``: the data sections of
    noisy frames (copies of a few, each symbol a clear winner), all zeros
    (every tone ties) or +-1 at random (full scale)."""
    sps, pre = cfg.samples_per_symbol, cfg.preamble_samples
    r = int(np.prod(lead))
    width = n_sym * sps + (5 if strided else 0)
    pitch = width + (2 * sps + 3 if strided else 0)
    if fill == "frames":
        k = min(r, 5)
        w = transmit(cfg, rng.integers(0, 256, (k, PAY), dtype=np.uint8), device="cpu").numpy()[:, pre:]
        data = np.tile(w, (-(-r // k), -(-width // w.shape[1])))[:r, :width]
        data = data + 0.3 * rng.standard_normal(data.shape).astype(np.float32)
    elif fill == "zeros":
        data = np.zeros((r, width), np.float32)
    else:
        data = rng.choice(np.array([-1.0, 1.0], np.float32), (r, width))
    flat = torch.full((offset + (r - 1) * pitch + width,), GAP, dtype=torch.float32)
    rows = flat[offset:].as_strided((r, width), (pitch, 1))
    rows.copy_(torch.from_numpy(data))
    flat = flat.to(device, dtype)
    strides = tuple(int(np.prod(lead[i + 1 :])) * pitch for i in range(len(lead)))
    return flat[offset:].as_strided((*lead, width), (*strides, 1)), flat


def _check_bm(cfg, rows, exact=False):
    """One launch each of tone_energies_fused and decide_tones_fused on
    ``rows`` with bfloat16 compute (the tensor-core route), under their
    keys, held against the plain versions: tones and the energies' argmax
    bit-equal; energies, best and total within rtol 1e-3 (float32 sums in
    another order), or bit-equal where ``exact``."""
    before = dict(tk.launch_counts)
    e = tk.tone_energies_fused(cfg, rows, compute_dtype=torch.bfloat16)
    got = tk.decide_tones_fused(cfg, rows, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launched = {n: tk.launch_counts[n] - before[n] for n in before if tk.launch_counts[n] != before[n]}
    assert launched == {"tone_energies_fused": 1, "decide_tones_fused": 1}
    want_e = tk.tone_energies_fused_ref(cfg, rows, compute_dtype=torch.bfloat16)
    want = tk.decide_tones_fused_ref(cfg, rows, compute_dtype=torch.bfloat16)
    assert e.shape == want_e.shape and all(g.shape == w.shape for g, w in zip(got, want))
    assert torch.equal(got[0], want[0]) and torch.equal(e.argmax(-1).int(), want[0])
    tol = 0 if exact else 1e-3
    for a, b in zip((e, *got[1:]), (want_e, *want[1:])):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    return e, got


@pytest.mark.cuda
@pytest.mark.parametrize("lead", BM_LEADS, ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("n_sym", BM_SYMBOLS)
@pytest.mark.parametrize("geometry", list(BM_CONFIGS))
def test_cuda_batch_major_filterbank_at_every_residue(cuda, geometry, n_sym, lead):
    """tone_energies_fused and decide_tones_fused with bfloat16 compute (the
    tensor-core route) against their plain versions: sps 32/48/64/80/128
    and 2-32 tones, n_symbols 1, 15, 16, 17 and 67 (whole, partial and
    several symbol tiles), R = 1, 7, 257 and a [2, 3] leading shape; rows
    contiguous at an offset of every residue mod 8 or strided at an odd
    pitch (every residue) with a partial symbol after them, the gaps
    between rows filled with a large value and the last row ending at the
    allocation's end. One launch under each key."""
    cfg = BM_CONFIGS[geometry]
    case = BM_LEADS.index(lead) + 4 * (BM_SYMBOLS.index(n_sym) + 5 * list(BM_CONFIGS).index(geometry))
    rng = np.random.default_rng(case)
    strided = case % 2 == 1
    rows, flat = _bm_rows(cfg, rng, cuda, lead, n_sym, strided, offset=(case // 2) % 8)
    assert rows.data_ptr() + rows.shape[-1] * 2 + rows.stride(-2) * 2 * (int(np.prod(lead)) - 1) == (
        flat.data_ptr() + flat.numel() * 2)
    e, _ = _check_bm(cfg, rows)
    assert e.shape == (*lead, n_sym, cfg.num_tones)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["zeros", "saturated"])
@pytest.mark.parametrize("geometry", list(BM_CONFIGS))
def test_cuda_batch_major_filterbank_every_tie_and_extreme(cuda, geometry, fill):
    """All-zero rows (every tone ties: tone 0, zero energies, best and
    total, bit-equal) and rows of +-1 at random (full scale), R = 7,
    strided, 17 symbols."""
    cfg = BM_CONFIGS[geometry]
    rng = np.random.default_rng(17 + len(fill))
    rows, _ = _bm_rows(cfg, rng, cuda, (7,), 17, True, offset=3, fill=fill)
    e, got = _check_bm(cfg, rows, exact=fill == "zeros")
    if fill == "zeros":
        assert not got[0].any() and not e.any() and not got[2].any()


def _check_split(cfg, rows):
    """One launch each of tone_energies_fused and decide_tones_fused with
    float32 compute on ``rows`` (under their ":f32" keys, or
    filterbank_any's twice off the compile-time walk's geometry), held
    against the
    plain versions with the route's stated tolerance: each energy within
    kernels.F32_SPLIT_RTOL of itself plus F32_SPLIT_ATOL of its symbol's
    largest plain energy, best and total within the same bounds, the tones
    (decided, and the energies' argmax) equal but where the plain
    version's two largest energies lie that close (_check_split_decisions).
    Returns the count of such near-ties among symbols with energy."""
    before = dict(tk.launch_counts)
    e = tk.tone_energies_fused(cfg, rows, compute_dtype=torch.float32)
    tone, best, total = tk.decide_tones_fused(cfg, rows, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    launched = {n: tk.launch_counts[n] - before[n] for n in before if tk.launch_counts[n] != before[n]}
    if tk._filterbank_tensor_core_geometry(cfg):
        assert launched == {"tone_energies_fused:f32": 1, "decide_tones_fused:f32": 1}
    else:
        assert launched == {"filterbank_any:f32": 2}
    want = tk.tone_energies_fused_ref(cfg, rows, compute_dtype=torch.float32)
    assert e.shape == want.shape and tone.shape == best.shape == total.shape == want.shape[:-1]
    assert bool(((e - want).abs() <= _split_tol(want, want.amax(-1, keepdim=True))).all())
    top2 = want.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= _split_tol(top2[..., 0], top2[..., 0])
    assert bool(((e.argmax(-1).int() == want.argmax(-1).int()) | near).all())
    return _check_split_decisions((tone, best, total), want)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mfsk16-fast", "mfsk4-coded", "mfsk32-dense", "mfsk8-audible", "sps40-m4"])
def test_cuda_batch_major_float32_compute_on_bf16_rows(cuda, model):
    """float32 compute on bfloat16 rows (receive_frame's route on bf16
    captures) meets the float32 basis, not the bf16-rounded one: at sps
    32/48/64/80/128 with at most 32 tones the compile-time walk's
    three-term split, elsewhere (a custom sps-40 config) filterbank_any.cu's
    runtime-geometry walk, the same split, each within the route's stated
    tolerance (_check_split)."""
    cfg = _bm_config(model)
    rows, _ = _bm_rows(cfg, np.random.default_rng(29), cuda, (33,), 40, True, offset=1)
    _check_split(cfg, rows)


SPLIT_LEADS = ((7,), (2, 3))
SPLIT_SYMBOLS = (1, 17, 67)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["bf16", "float32"])
@pytest.mark.parametrize("lead", SPLIT_LEADS, ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("n_sym", SPLIT_SYMBOLS)
@pytest.mark.parametrize("geometry", list(BM_CONFIGS))
def test_cuda_split_at_every_residue(cuda, geometry, n_sym, lead, rows):
    """The float32-compute route on the tensor cores (the three-term split)
    at sps 32/48/64/80/128 and 2-32 tones, n_symbols 1, 17 and 67, R = 7 and
    a [2, 3] leading shape, on bf16 rows and on float32 rows (split on
    load), contiguous at an offset or strided at an odd pitch with a
    partial symbol after them, the gaps filled with a large value and the
    last row ending at the allocation's end: within the stated tolerance
    (_check_split), one launch under each ":f32" key."""
    cfg = BM_CONFIGS[geometry]
    case = SPLIT_LEADS.index(lead) + 2 * (SPLIT_SYMBOLS.index(n_sym) + 3 * list(BM_CONFIGS).index(geometry))
    rng = np.random.default_rng(1000 + case)
    dtype = {"bf16": torch.bfloat16, "float32": torch.float32}[rows]
    x, flat = _bm_rows(cfg, rng, cuda, lead, n_sym, case % 2 == 1, offset=(case // 2) % 8, dtype=dtype)
    end = x.data_ptr() + (x.shape[-1] + x.stride(-2) * (int(np.prod(lead)) - 1)) * x.element_size()
    assert end == flat.data_ptr() + flat.numel() * flat.element_size()
    _check_split(cfg, x)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["bf16", "float32"])
@pytest.mark.parametrize("fill", ["zeros", "saturated"])
@pytest.mark.parametrize("geometry", list(BM_CONFIGS))
def test_cuda_split_every_tie_and_extreme(cuda, geometry, fill, rows):
    """The float32-compute route on all-zero rows (every tone ties: tone 0,
    every energy, best and total exactly 0) and on rows of +-1 at random
    (full scale), R = 7, strided, 17 symbols."""
    cfg = BM_CONFIGS[geometry]
    dtype = {"bf16": torch.bfloat16, "float32": torch.float32}[rows]
    x, _ = _bm_rows(cfg, np.random.default_rng(31 + len(fill)), cuda, (7,), 17, True, offset=3, fill=fill,
                    dtype=dtype)
    _check_split(cfg, x)
    if fill == "zeros":
        assert not tk.tone_energies_fused(cfg, x, compute_dtype=torch.float32).any()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [256, 16384])
@pytest.mark.parametrize("rows", ["bf16", "float32"])
def test_cuda_split_main_path(cuda, rows, b):
    """The float32-compute route at the batch-major aligned receiver's
    geometry (mfsk16-fast, payload 256: the data sections of b frames at
    operating noise, read in place past the preamble), as chip_smoke.py's
    phase 2 holds it: within the stated tolerance, near-ties rare."""
    g = torch.Generator(device=cuda).manual_seed(37)
    pay = torch.randint(0, 256, (256, 256), generator=g, device=cuda, dtype=torch.uint8)
    w = transmit(CFG, pay, device=cuda)
    x = (w + 0.3 * torch.randn(w.shape, generator=g, device=cuda)).repeat(b // 256, 1)
    dtype = {"bf16": torch.bfloat16, "float32": torch.float32}[rows]
    near = _check_split(CFG, x.to(dtype)[:, CFG.preamble_samples :])
    assert near <= b  # at most one a frame of 536 symbols


# --- the batch-major filterbank off the compile-time walks: csrc/filterbank_any.cu


ANY_CONFIGS = {  # sps and tones off tone_energies.cu's walks; (R, symbols) a case
    "sps15-m4": (_custom(15, 4), (33,), 67),  # odd sps: rows at every 2-byte residue
    "sps24-m8": (_custom(24, 8), (33,), 67),
    "sps30-m8": (_custom(30, 8), (33,), 67),
    "sps40-m8": (_custom(40, 8), (33,), 67),
    "sps40-m16": (_custom(40, 16), (33,), 67),  # chip_smoke.py's stream-custom-f32 modem
    "sps96-m16": (_custom(96, 16), (2, 3), 40),
    "sps100-m16": (ModemConfig(sample_rate_hz=44_100, symbol_rate_hz=441, num_tones=16, base_freq_hz=220.5),
                   (2, 3), 40),
    "sps160-m64": (_custom(160, 64), (7,), 33),  # two groups of 32 tones
    "sps480-m16": (ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=100, num_tones=16, base_freq_hz=600.0),
                   (1024,), 9),  # chip_smoke.py's stream-slow-f32 modem at its batch; 30 k-steps
    "sps1920-m16": (_custom(1920, 16), (256,), 40),  # past the old CUDA-core body's 1,536; 120 k-steps
    "sps1920-m256": (_custom(1920, 256), (3,), 3),  # eight groups
}
ANY_ROUTES = {"bf16": (torch.bfloat16, torch.bfloat16), "split-bf16-rows": (torch.bfloat16, torch.float32),
              "split-f32-rows": (torch.float32, torch.float32)}  # (rows, compute)


def _check_any(cfg, rows, compute):
    """One launch each of tone_energies_fused and decide_tones_fused on
    ``rows`` with ``compute``, both under filterbank_any (":f32" for float32
    compute), held against the plain versions: float32 compute with the
    split's stated tolerance (F32_SPLIT_RTOL of each value plus
    F32_SPLIT_ATOL of its symbol's largest plain energy); bfloat16 compute
    within 1e-5 of the symbol's largest (bf16 products exact, float32 sums
    in another order); tones (decided, and the
    energies' argmax) equal but where the plain version's two largest
    energies lie that close. Returns the near-ties' count."""
    before = dict(tk.launch_counts)
    e = tk.tone_energies_fused(cfg, rows, compute_dtype=compute)
    tone, best, total = tk.decide_tones_fused(cfg, rows, compute_dtype=compute)
    assert _launched(before) == {_key("filterbank_any", compute): 2}
    want = tk.tone_energies_fused_ref(cfg, rows, compute_dtype=compute)
    assert e.shape == want.shape and tone.shape == best.shape == total.shape == want.shape[:-1]
    scale = want.amax(-1)
    if compute == torch.float32:
        tol = lambda w, sc: _split_tol(w, sc)  # noqa: E731
    else:
        tol = lambda w, sc: 1e-5 * sc  # noqa: E731
    assert bool(((e - want).abs() <= tol(want, scale[..., None])).all())
    top2 = want.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= tol(top2[..., 0], top2[..., 0])
    assert bool(((e.argmax(-1).int() == want.argmax(-1).int()) | near).all())
    assert bool(((tone == want.argmax(-1).int()) | near).all())
    assert bool(((best - scale).abs() <= tol(scale, scale)).all())
    assert bool(((total - want.sum(-1)).abs() <= tol(want.sum(-1), scale)).all())
    return int(near.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ANY_ROUTES))
@pytest.mark.parametrize("geometry", list(ANY_CONFIGS))
def test_cuda_filterbank_any_geometry(cuda, geometry, route):
    """filterbank_any.cu, both wrappers, bfloat16 compute on bf16 rows and
    float32 compute on bf16 and float32 rows, at sps 15, 24, 30, 40 (8
    and 16 tones), 96, 100 (44.1 kHz / 441), 160 with 64 tones (two
    groups), 480 with 16 (B = 1,024) and 1,920 with 16
    and 256 tones (a symbol of 120 k-steps walked in slabs; eight groups):
    the data sections of noisy frames in rows at an odd pitch with a
    partial symbol after them and the gaps filled with a large value, the
    last row ending at the allocation's end (_bm_rows), within _check_any's
    tolerances; near-ties rare."""
    cfg, lead, n_sym = ANY_CONFIGS[geometry]
    rdt, cdt = ANY_ROUTES[route]
    assert not tk._filterbank_tensor_core_geometry(cfg)
    rng = np.random.default_rng(cfg.samples_per_symbol + cfg.num_tones)
    rows, _ = _bm_rows(cfg, rng, cuda, lead, n_sym, True, offset=3, dtype=rdt)
    near = _check_any(cfg, rows, cdt)
    assert near <= rows.numel() // cfg.samples_per_symbol // 20


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ANY_ROUTES))
@pytest.mark.parametrize("geometry", ["sps15-m4", "sps160-m64", "sps1920-m256"])
def test_cuda_filterbank_any_every_tie(cuda, geometry, route):
    """All-zero rows: every tone of every group ties, so the decisions'
    fold keeps tone 0, and the energies, best and total are zero, bit-equal
    to the plain version's."""
    cfg, lead, n_sym = ANY_CONFIGS[geometry]
    rdt, cdt = ANY_ROUTES[route]
    rows, _ = _bm_rows(cfg, np.random.default_rng(0), cuda, lead, n_sym, True, offset=1, fill="zeros", dtype=rdt)
    e = tk.tone_energies_fused(cfg, rows, compute_dtype=cdt)
    tone, best, total = tk.decide_tones_fused(cfg, rows, compute_dtype=cdt)
    assert not e.any() and not tone.any() and not best.any() and not total.any()
    assert e.shape == (*lead, n_sym, cfg.num_tones)


@pytest.mark.cuda
@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32])
def test_cuda_demodulate_frame_at_sps_1920(cuda, compute):
    """dsp.frame.demodulate_frame at sps 1,920 (25 baud, 16 tones), which
    the CUDA-core body refused past 1,536 samples a symbol: 9 noisy frames
    of 24 bytes, every frame ok with its payload, equal to the CPU's
    verdicts, through filterbank_any (":f32" for float32 compute)."""
    from anet_torch.dsp import frame as tframe

    cfg = ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=25, num_tones=16, base_freq_hz=1000.0)
    rng = np.random.default_rng(1920)
    pay = rng.integers(0, 256, (9, 24), dtype=np.uint8)
    w = transmit(cfg, pay, device="cpu")
    x = w + 0.3 * torch.from_numpy(rng.standard_normal(w.shape).astype(np.float32))
    before = dict(tk.launch_counts)
    got = tframe.demodulate_frame(cfg, x.to(cuda), 24, compute_dtype=compute, device=cuda)
    assert _launched(before) == {_key("filterbank_any", compute): 1}
    assert bool(got.ok.all()) and np.array_equal(got.payload.cpu().numpy(), pay)
    on_cpu = tframe.demodulate_frame(cfg, x, 24, compute_dtype=compute, device="cpu")
    assert torch.equal(got.ok.cpu(), on_cpu.ok) and torch.equal(got.payload.cpu(), on_cpu.payload)


# --- probe_at_fused on demod_probe's staged probe, the OFDM equalizer a warp --
# --- a stream ---------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("n_lags", [1, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_probe_at_every_residue(cuda, dtype, n_lags, ragged):
    """probe_at_fused (the coded path's 1,024-sample preamble) against its
    plain version at probe bases of every residue mod 16 and at 124..127
    mod 128, a span past the row's end, a window past it, a base before
    the row's start, rows that start 3 samples past a 16-byte boundary
    and, ``ragged``, a row length that leaves the other rows off one too:
    qualities within rtol 1e-3 (float32 sums in another order), the lag of
    every planted preamble the argmax, one launch counted; a tensor
    template energy on the card gives the bits a float gives; B = 0
    launches nothing."""
    rng = np.random.default_rng(7 * n_lags + ragged)
    tpl = preamble_waveform(CODED, device="cpu").to(dtype)
    k = tpl.shape[-1]
    length = tstream._buffer_len(CODED, CHUNK, PAY) + (5 if ragged else 0)
    lag = n_lags // 2
    st0 = [200 + r for r in range(16)] + [128 * 7 + r for r in range(124, 128)]
    st0 += [length - k - n_lags - 40, 1000, length - k // 2, -3]
    planted = len(st0) - 2  # the windows wholly inside the row
    x = 0.1 * rng.standard_normal((len(st0), length)).astype(np.float32)
    for i, s in enumerate(st0[:planted]):
        x[i, s + lag : s + lag + k] += tpl.float().numpy()
    x = torch.from_numpy(x).to(dtype)
    flat = torch.zeros(x.numel() + 3, dtype=dtype, device=cuda)
    flat[3:] = x.reshape(-1).to(cuda)
    buf = flat[3:].view(x.shape)
    st = torch.tensor(st0, dtype=torch.int32, device=cuda)
    tpl = tpl.to(cuda)
    te = tstream._template_energy(tpl)

    before = dict(tk.launch_counts)
    got = tk.probe_at_fused(buf, st, tpl, te, n_lags=n_lags)
    torch.cuda.synchronize()
    launched = {n: tk.launch_counts[n] - before[n] for n in before if tk.launch_counts[n] != before[n]}
    assert launched == {"probe_at_fused": 1}
    want = tk.probe_at_fused_ref(buf, st, tpl, te, n_lags=n_lags)
    assert got.shape == (len(st0), n_lags) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-6)
    assert bool((got[:planted].argmax(-1) == lag).all()) and float(got[:planted].amax(-1).min()) > 0.9
    assert torch.equal(tk.probe_at_fused(buf, st, tpl, float(te), n_lags=n_lags), got)

    before = dict(tk.launch_counts)
    assert tk.probe_at_fused(buf[:0], st[:0], tpl, te, n_lags=n_lags).shape == (0, n_lags)
    assert tk.launch_counts == before


@pytest.mark.cuda
def test_cuda_probe_at_reads_nothing_to_the_host(cuda):
    """The locked bf16 coded step's probe, with the step's operands (the
    template and its energy from stream._lock_template: a float32 scalar
    on the card) and a fresh template, under
    torch.cuda.set_sync_debug_mode("error"): probe_at_fused neither reads
    a value to the host nor waits for the card, on its first call for a
    template (the taps made) and after, and gives the quality a float
    template energy gives."""
    t_c, t_energy = tstream._lock_template(CODED, torch.bfloat16, cuda)
    assert t_energy.is_cuda and t_energy.dtype == torch.float32 and t_energy.dim() == 0
    fresh = t_c.clone()
    fresh_energy = tstream._template_energy(fresh)
    k = t_c.shape[-1]
    length = tstream._buffer_len(CODED, CHUNK, PAY)
    g = torch.Generator(device=cuda).manual_seed(4)
    buf = torch.randn(64, length, generator=g, device=cuda).to(torch.bfloat16)
    probe_at = torch.randint(0, length - k, (64,), generator=g, device=cuda)
    st0 = tstream._probe_base(probe_at, length, k).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tk.probe_at_fused(buf, st0, t, e, n_lags=tstream.PROBE_LAGS)
               for t, e in ((t_c, t_energy), (fresh, fresh_energy), (fresh, fresh_energy))]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = tk.probe_at_fused(buf, st0, t_c, float(t_energy), n_lags=tstream.PROBE_LAGS)
    assert all(torch.equal(q, want) for q in got)


OFDM_GATE_EPS = 1e-4  # chip_smoke.py GATE_EPS: a gate may part only this close to a tie
OFDM_RTOL = 1e-4
QAM_LEVELS = {2: (1,), 4: (1, 3), 6: (1, 3, 5, 7)}
QAM_SCALE = {2: 0.7071067811865476, 4: 0.31622776601683794, 6: 0.1543033499620919}
OFDM_SNR_DB = {2: 16.0, 4: 24.0, 6: 26.0}  # chip_smoke.py's, by bits a carrier


def _ofdm_points(cfg, rng, b, s_n=None):
    """(z_eq complex64 [b, S, C], h_pow float32 [b, C], slope0 float32 [b],
    drifted bool [b]) at payload 256 (or S = ``s_n``): constellation points rotated by a
    clock drift of c (s + 1) m, c as 100-150 ppm either way does on all but
    every fourth stream (a clean clock, c = 0: the gate near a tie), slope0
    c within 5%, channel powers in [0.5, 1.5], noise at chip_smoke.py's
    SNR."""
    bpc, c_n = cfg.bits_per_carrier, cfg.n_carriers
    s_n = s_n or cfg.data_symbols_for_payload(256)
    levels = np.array(QAM_LEVELS[bpc])
    axis = lambda: rng.choice(np.concatenate([levels, -levels]), (b, s_n, c_n)) * QAM_SCALE[bpc]
    d = axis() + 1j * axis()
    per_ppm = 2 * np.pi * 1e-6 * cfg.symbol_samples / cfg.n_fft
    drifted = np.arange(b) % 4 != 3
    slope = np.where(drifted, rng.choice([-1, 1], b) * rng.uniform(100, 150, b) * per_ppm, 0.0)
    m = cfg.first_carrier + np.arange(c_n)
    ang = slope[:, None, None] * np.arange(1, s_n + 1)[None, :, None] * m[None, None, :]
    sigma = 10 ** (-OFDM_SNR_DB[bpc] / 20) / np.sqrt(2)
    z = d * np.exp(1j * ang) + sigma * (rng.standard_normal(d.shape) + 1j * rng.standard_normal(d.shape))
    h = rng.uniform(0.5, 1.5, (b, c_n))
    slope0 = slope * rng.uniform(0.95, 1.05, b)
    return (torch.from_numpy(z.astype(np.complex64)), torch.from_numpy(h.astype(np.float32)),
            torch.from_numpy(slope0.astype(np.float32)), torch.from_numpy(drifted))


def _check_ofdm(cfg, got, want, drifted):
    """chip_smoke.py compare_ofdm's rules: a stream's LLRs may part from the
    plain version's (beyond OFDM_RTOL of their scale) only where the plain
    version's two coherences lie within OFDM_GATE_EPS, never on a drifted
    frame and never untracked; elsewhere the decisions equal wherever the
    plain LLR lies outside that band and evm2 within OFDM_RTOL; the
    coherences everywhere."""
    llrs, ref = got[0].double(), want[0].double()
    atol = OFDM_RTOL * float(ref.abs().max())
    close = ((llrs - ref).abs() <= OFDM_RTOL * ref.abs() + atol).all(-1)
    parted = ~close
    tie = (want[2][:, 0] - want[2][:, 1]).abs() < OFDM_GATE_EPS
    assert not bool((parted & (drifted.to(parted.device) | ~tie)).any())
    assert cfg.clock_tracking or not bool(parted.any())
    firm = ref[close].abs() > atol
    assert not bool(((llrs[close] > 0) != (ref[close] > 0))[firm].any())
    torch.testing.assert_close(got[1][close], want[1][close], rtol=OFDM_RTOL, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=OFDM_RTOL, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["batch-major", "time-major", "strided-h", "tm-h"])
@pytest.mark.parametrize("b", [1, 7, 257])
@pytest.mark.parametrize("tracked", [True, False])
@pytest.mark.parametrize("model", ["ofdm-fast", "ofdm-turbo", "ofdm-max"])
def test_cuda_ofdm_track_every_layout(cuda, model, tracked, b, layout):
    """ofdm_track_decide_fused on all three constellations, tracked and
    untracked, B = 1, 7 and 257 (not a multiple of the block's streams),
    against its plain version under chip_smoke.py's compare_ofdm rules
    (OFDM_RTOL, OFDM_GATE_EPS): z_eq batch-major or the time-major
    receiver's [B, S, C] view of [S, C, B] points ("time-major", h_pow the
    same view of [C, B]), h_pow a strided view ("strided-h") or
    time-major under batch-major points ("tm-h"); evm_symbols 2 below S
    but for batch-major. Every layout gives the batch-major layout's bits
    (one arithmetic on the same staged points); one launch a call."""
    cfg = dataclasses.replace(get_model(model).config, clock_tracking=tracked)
    rng = np.random.default_rng(b + 1000 * tracked + len(model))
    z, h, slope0, drifted = _ofdm_points(cfg, rng, b)
    s = z.shape[1]
    z, h, slope0 = z.to(cuda), h.to(cuda), slope0.to(cuda)
    base = tk.ofdm_track_decide_fused(cfg, z, h, slope0, evm_symbols=s - 2, with_coherence=True)
    zl, hl = z, h
    if layout == "time-major":
        zl, hl = z.permute(1, 2, 0).contiguous().permute(2, 0, 1), h.T.contiguous().T
    elif layout == "strided-h":
        hl = torch.repeat_interleave(h, 3, dim=-1)[:, 2::3]
    elif layout == "tm-h":
        hl = h.T.contiguous().T
    evm = None if layout == "batch-major" else s - 2
    before = tk.launch_counts["ofdm_track_decide_fused"]
    got = tk.ofdm_track_decide_fused(cfg, zl, hl, slope0, evm_symbols=evm, with_coherence=True)
    torch.cuda.synchronize()
    assert tk.launch_counts["ofdm_track_decide_fused"] == before + 1
    want = tk.ofdm_track_decide_fused_ref(cfg, z, h, slope0, evm_symbols=evm, with_coherence=True)
    assert got[0].shape == (b, s * cfg.n_carriers * cfg.bits_per_carrier) and got[1].shape == (b,)
    _check_ofdm(cfg, got, want, drifted)
    assert torch.equal(got[0], base[0]) and torch.equal(got[2], base[2])
    if evm is not None:
        assert torch.equal(got[1], base[1])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["batch-major", "time-major"])
@pytest.mark.parametrize("s_n", [29, 38, 87, 172, 302, 303, 343])
@pytest.mark.parametrize("tracked", [True, False])
@pytest.mark.parametrize("model", ["ofdm-fast", "ofdm-max"])
def test_cuda_ofdm_track_past_shared_memory(cuda, model, tracked, s_n, layout, monkeypatch):
    """ofdm_track_decide_fused on streams of S = 29 (a 1,024-byte ofdm-max
    frame, on the staged route), 38 (the block route's shortest), 87 (a
    1,024-byte ofdm-coded frame), 172 (a 4,096-byte ofdm-fast one), 302 (the
    longest the staged route holds at 96 carriers), 303 and 343 (a
    4,096-byte ofdm-coded frame) data symbols, QPSK and 64-QAM, tracked and
    untracked, B = 33, batch-major and the time-major view, against its
    plain version under chip_smoke.py's compare_ofdm rules: each on the
    route _ofdm_track_route names from S and C, the same in both layouts
    (the block route from 38 on, counted under
    ofdm_track_decide_fused:block). Its bits do not depend on the layout
    (the time-major view gives the batch-major launch's) nor on the launch
    (batch-major, twice). At S = 302 the staged route, forced, is held
    against the plain version by the same rules."""
    cfg = dataclasses.replace(get_model(model).config, clock_tracking=tracked)
    rng = np.random.default_rng(s_n + 7 * tracked + len(model))
    z, h, slope0, drifted = _ofdm_points(cfg, rng, 33, s_n)
    z, h, slope0 = z.to(cuda), h.to(cuda), slope0.to(cuda)
    zl, hl = z, h
    if layout == "time-major":
        zl, hl = z.permute(1, 2, 0).contiguous().permute(2, 0, 1), h.T.contiguous().T
    route = tk._ofdm_track_route(s_n, cfg.n_carriers)
    assert route == ("staged" if s_n == 29 else "block")
    key = "ofdm_track_decide_fused" + (":block" if route == "block" else "")
    before = dict(tk.launch_counts)
    got = tk.ofdm_track_decide_fused(cfg, zl, hl, slope0, evm_symbols=s_n - 2, with_coherence=True)
    torch.cuda.synchronize()
    assert {n: tk.launch_counts[n] - before[n] for n in before if tk.launch_counts[n] != before[n]} == {key: 1}
    want = tk.ofdm_track_decide_fused_ref(cfg, z, h, slope0, evm_symbols=s_n - 2, with_coherence=True)
    assert got[0].shape == (33, s_n * cfg.n_carriers * cfg.bits_per_carrier)
    _check_ofdm(cfg, got, want, drifted)
    again = tk.ofdm_track_decide_fused(cfg, z, h, slope0, evm_symbols=s_n - 2, with_coherence=True)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    if s_n == 302:
        monkeypatch.setattr(tk, "_ofdm_track_route", lambda s, c: "staged")
        staged = tk.ofdm_track_decide_fused(cfg, zl, hl, slope0, evm_symbols=s_n - 2, with_coherence=True)
        _check_ofdm(cfg, staged, want, drifted)


# --- decide_tones_tm on the tensor cores: every geometry and edge -----------

TONES_BATCHES = (1, 7, 8, 129, 1000, 16383)  # rows off 16 bytes unless B is a multiple of 8
TONES_SYMBOLS = (1, 7, 8, 9, 67)  # whole symbol tiles of 8 and partial ones


def _tones_case(cfg, rng, b, n_sym, dtype, partial, device):
    """Time-major [n_sym * sps + partial, B] data sections of ``dtype`` on
    the card: the data symbols of up to 16 noisy frames (repeated to n_sym
    symbols, so every symbol has a clear winner) tiled across the batch,
    noise 0.3 added on the card, then ``partial`` rows of noise (a trailing
    partial symbol)."""
    sps, pre = cfg.samples_per_symbol, cfg.preamble_samples
    k = min(b, 16)
    w = transmit(cfg, rng.integers(0, 256, (k, PAY), dtype=np.uint8), device="cpu")[:, pre:]
    data = w.repeat(1, -(-n_sym * sps // w.shape[1]))[:, : n_sym * sps]
    data = torch.nn.functional.pad(data, (0, partial)).to(device)
    x = data.repeat(-(-b // k), 1)[:b].T.contiguous()
    g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
    return (x + 0.3 * torch.randn(x.shape, generator=g, device=device)).to(dtype)


def _check_tones_tm(cfg, x, name="decide_tones_tm"):
    """One launch of decide_tones_tm on ``x`` (under ``name``'s key: the
    walk's, or frame_tm_any's off it; none elsewhere), held against the
    plain version: bfloat16 tones bit-equal, best and total within rtol
    1e-3, atol 1e-5 (float32 sums in another order); float32 (the
    three-term split) as _check_split_decisions holds it, a silent symbol's
    tone the first."""
    before = dict(tk.launch_counts)
    got = tk.decide_tones_tm(cfg, x)
    torch.cuda.synchronize()
    launched = {n: tk.launch_counts[n] - before[n] for n in before if tk.launch_counts[n] != before[n]}
    assert launched == {_key(name, x.dtype): 1}
    want = tk.decide_tones_tm_ref(cfg, x)
    s = x.shape[0] // cfg.samples_per_symbol
    assert all(g.shape == w.shape == (s, x.shape[1]) for g, w in zip(got, want))
    if x.dtype == torch.float32:
        energies = _tm_energies(cfg, x, 0, s)
        _check_split_decisions([v.T for v in got], energies)
        assert not bool(got[0].T[energies.amax(-1) == 0].any())
        return got
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b", TONES_BATCHES)
@pytest.mark.parametrize("geometry", list(DEMOD_CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decide_tones_tm_every_geometry(cuda, dtype, geometry, b):
    """decide_tones_tm against its plain version, bfloat16 and float32 (the
    tensor-core walk, float32 as its three-term split): sps 32, 64 and
    128, 2, 4, 8 and 16 tones, B = 1 to 16,383 (rows off a 16-byte
    boundary where B is not a multiple of 8 in bfloat16, 4 in float32),
    n_symbols 1, 7, 8, 9 and 67 (one per case, in turn), a trailing
    partial symbol on every other case."""
    cfg = DEMOD_CONFIGS[geometry]
    case = TONES_BATCHES.index(b) + 6 * list(DEMOD_CONFIGS).index(geometry)
    rng = np.random.default_rng(100 + case)
    n_sym = TONES_SYMBOLS[case % 5]
    partial = (0, 17)[case % 2]
    x = _tones_case(cfg, rng, b, n_sym, dtype, partial, cuda)
    assert x.shape == (n_sym * cfg.samples_per_symbol + partial, b)
    _check_tones_tm(cfg, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decide_tones_tm_every_tie(cuda, dtype):
    """All-zero input: every tone ties, so tone 0, best and total 0,
    bit-equal, at B = 129 and 9 symbols of each geometry."""
    for cfg in DEMOD_CONFIGS.values():
        x = torch.zeros(9 * cfg.samples_per_symbol + 5, 129, dtype=dtype, device=cuda)
        got = _check_tones_tm(cfg, x)
        assert not got[0].any() and not got[1].any() and not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [16384, 16383])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decide_tones_tm_every_split_of_the_grid(cuda, dtype, b):
    """The oversized window's batch, B = 16,384 (16,383: rows off 16 bytes),
    a frame's 536 data symbols plus 8 (544): few blocks a column of
    streams, so the tensor-core walk gives each a share of the symbol
    tiles (gridDim.y) and its blocks meet at tile edges."""
    rng = np.random.default_rng(b)
    x = _tones_case(CFG, rng, b, 544, dtype, 0, cuda)
    _check_tones_tm(CFG, x)


# --- gather_rows_fused: every element width, residue and row edge ----------

GATHER_LEADS = ((1,), (7,), (257,), (2, 3))
GATHER_LEN = 1003  # samples a row: odd, so rows pass through every residue
SENTINEL = 0x5A  # the bytes around the buffer view: a read of them would show


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("lead", GATHER_LEADS, ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float16, torch.float32], ids=str)
def test_cuda_gather_every_residue_and_edge(cuda, dtype, lead, ragged):
    """gather_rows_fused against its plain version, bit for bit: int8,
    bfloat16, float16 and float32 buffers as a view 0-15 bytes into a
    larger tensor of sentinel bytes (so the source byte of a row's first
    sample passes through every residue mod 16), the last row ending at the
    view's end with sentinels after it; sizes whose bytes are whole 16-byte
    vectors or (ragged) not, and one shorter than a vector; starts at 0,
    at the last fitting one, below 0, past L - size, wholly before and
    wholly past the row (zeros), and random ones. One launch each, under
    its key. Any byte taken from outside a row shows in the output."""
    e = torch.tensor([], dtype=dtype).element_size()
    r = int(np.prod(lead))
    rng = np.random.default_rng(e * 10 + r + ragged)
    key = "gather_rows_fused:int8" if dtype == torch.int8 else "gather_rows_fused"
    sizes = (16 * 40 // e, 16 * 50) if not ragged else (16 * 40 // e + 1, 3, 16 * 50 - 1)
    n_bytes = r * GATHER_LEN * e
    for pre in range(0, 16, e):
        for size in sizes:
            edges = [0, GATHER_LEN - size, -3, GATHER_LEN - size + 7, -size - 2, GATHER_LEN + 1, 1 - size]
            starts = rng.integers(-size // 2, GATHER_LEN - size // 2, r)
            turn = (pre // e + sizes.index(size)) % len(edges)
            for i in range(min(r, len(edges))):
                starts[i] = edges[(turn + i) % len(edges)]
            flat = torch.full((pre + n_bytes + 16,), SENTINEL, dtype=torch.uint8)
            flat[pre : pre + n_bytes] = torch.from_numpy(rng.integers(0, 256, n_bytes, dtype=np.uint8))
            flat = flat.to(cuda)
            buf = flat[pre : pre + n_bytes].view(dtype).view(*lead, GATHER_LEN)
            st = torch.from_numpy(starts).reshape(lead).to(cuda)
            before = dict(tk.launch_counts)
            got = tk.gather_rows_fused(buf, st, size)
            torch.cuda.synchronize()
            launched = {n: tk.launch_counts[n] - before[n] for n in before if tk.launch_counts[n] != before[n]}
            assert launched == {key: 1}
            want = tk.gather_rows_fused_ref(buf, st, size)
            assert got.shape == (*lead, size) and got.dtype == dtype
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), (pre, size)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tracker_matches_cpu(cuda, dtype):
    """The symbol-clock tracker on the card against its CPU run: six
    mfsk16-fast captures (payload 256) drifted by -1000 to +1000 ppm at 14
    dB through receive_frame_tracked, and a 4-stream tracked stream at
    +-500 ppm. Verdicts and payloads equal; the drift estimates within 1
    ppm (the card's float32 products sum in another order, and the timing
    state feeds them back). It launches no kernel of csrc/ but the stream's
    search."""
    from anet_torch.dsp import pipeline as tpipeline
    from anet_torch.dsp.family import frame_samples
    from anet_torch.profile_stream import drift_rows

    rng = np.random.default_rng(61)
    ppms = (-1000.0, -700.0, -300.0, 300.0, 700.0, 1000.0)
    pay = rng.integers(0, 256, (len(ppms), 256), dtype=np.uint8)
    w = transmit(CFG, pay, device="cpu").numpy()
    caps = np.zeros((len(ppms), 38400), np.float32)
    for i in range(len(ppms)):
        caps[i, 500 + 37 * i : 500 + 37 * i + w.shape[1]] = w[i]
    caps = drift_rows(torch.from_numpy(caps), torch.tensor(ppms)).numpy()
    sigma = np.sqrt(np.mean(w**2, axis=1, keepdims=True) * 10**-1.4)
    caps += sigma * rng.standard_normal(caps.shape).astype(np.float32)
    before = dict(tk.launch_counts)
    got = tpipeline.receive_frame_tracked(CFG, torch.from_numpy(caps).to(cuda), 256, compute_dtype=dtype, device=cuda)
    torch.cuda.synchronize()
    assert tk.launch_counts == before
    want = tpipeline.receive_frame_tracked(CFG, caps, 256, compute_dtype=dtype, device="cpu")
    assert bool(got.frame.ok.all()) and np.array_equal(got.frame.payload.cpu().numpy(), pay)
    assert torch.equal(got.sync.offset.cpu(), want.sync.offset) and torch.equal(got.frame.ok.cpu(), want.frame.ok)
    torch.testing.assert_close(got.drift_ppm.cpu(), want.drift_ppm, rtol=0, atol=1.0)
    assert bool((got.drift_ppm.cpu() * torch.tensor(ppms) < 0).all())

    chunk = 4096
    t = frame_samples(CFG, PAY)
    n = -(-(900 + 2 * t + 2 * chunk) // chunk) * chunk
    spay = rng.integers(0, 256, (4, 2, PAY), dtype=np.uint8)
    sw = transmit(CFG, spay.reshape(8, PAY), device="cpu").numpy().reshape(4, 2, t)
    scap = np.zeros((4, n), np.float32)
    scap[:, 900 : 900 + t] = sw[:, 0]
    scap[:, 900 + t + 300 : 900 + 2 * t + 300] = sw[:, 1]
    scap = drift_rows(torch.from_numpy(scap), torch.tensor([500.0, -500.0, 800.0, -800.0])).numpy()
    scap += 0.05 * rng.standard_normal(scap.shape).astype(np.float32)
    got = tstream.receive_stream(CFG, torch.from_numpy(scap).to(cuda), chunk, PAY, compute_dtype=dtype,
                                 track=True, device=cuda)
    want = tstream.receive_stream(CFG, scap, chunk, PAY, compute_dtype=dtype, track=True, device="cpu")
    det = got.steps.detected.cpu()
    assert torch.equal(det, want.steps.detected) and torch.equal(got.carry.frames_ok.cpu(), want.carry.frames_ok)
    assert int(got.carry.frames_ok.sum()) == 8
    assert torch.equal(got.steps.frame.payload.cpu()[det], want.steps.frame.payload[det])
    assert torch.equal(got.steps.frame_start.cpu(), want.steps.frame_start)


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
def test_cuda_resident_scan_matches_carry_path(cuda, warm):
    """receive_stream(lock=True, resident=True) on the card against the
    carry path (resident=False) on the same card, at a mid size: 512
    mfsk16-fast streams (payload 256), a gap of 1,000 samples, then 6
    back-to-back frames, bf16, cold and from a warm-lock seed. Frames, the
    final carry's buffer and every counter equal; the resident scan
    launches demod_at_fused (and, cold, sync_search_fused) and never
    probe_at_fused or demod_probe_fused."""
    from anet_torch.dsp.family import frame_samples

    rng = np.random.default_rng(71 + warm)
    b, pay_len = 512, 256
    t = frame_samples(CFG, pay_len)
    chunk = t // 128 * 128
    n = -(-(1000 + 6 * t) // chunk) * chunk
    pay = torch.from_numpy(rng.integers(0, 256, (6 * b, pay_len), dtype=np.uint8)).to(cuda)
    w = transmit(CFG, pay, device=cuda).reshape(6, b, t)
    cap = torch.zeros(b, n, dtype=torch.bfloat16, device=cuda)
    for i in range(6):
        cap[:, 1000 + i * t : 1000 + (i + 1) * t] = w[i].to(torch.bfloat16)
    cap += (0.05 * torch.randn(b, n, device=cuda)).to(torch.bfloat16)

    def seed():
        if not warm:
            return None
        c = tstream.init_carry(CFG, chunk, pay_len, (b,), dtype=torch.bfloat16, device=cuda)
        return c._replace(locked=torch.ones_like(c.locked), next_start=torch.full_like(c.next_start, 1000))

    want = tstream.receive_stream(CFG, cap, chunk, pay_len, carry=seed(), compute_dtype=torch.bfloat16,
                                  lock=True, resident=False, device=cuda)
    before = dict(tk.launch_counts)
    got = tstream.receive_stream(CFG, cap, chunk, pay_len, carry=seed(), compute_dtype=torch.bfloat16,
                                 lock=True, resident=True, device=cuda)
    torch.cuda.synchronize()
    launched = {k: tk.launch_counts[k] - before[k] for k in before if tk.launch_counts[k] != before[k]}
    assert launched.get("demod_at_fused", 0) == n // chunk
    assert "probe_at_fused" not in launched and "demod_probe_fused" not in launched
    if not warm:
        assert "sync_search_fused" in launched
    assert int(got.carry.frames_ok.sum()) == 6 * b
    assert torch.equal(got.steps.detected, want.steps.detected)
    det = got.steps.detected
    assert torch.equal(got.steps.frame.payload[det], want.steps.frame.payload[det])
    assert torch.equal(got.steps.frame.ok, want.steps.frame.ok)
    assert torch.equal(got.steps.frame_start[det], want.steps.frame_start[det])
    for f in tstream.StreamCarry._fields:
        assert torch.equal(getattr(got.carry, f), getattr(want.carry, f)), f


# --- the time-major pair off the walk's geometry: csrc/frame_tm_any.cu --------


def _custom(sps, m):
    """A config of ``sps`` samples and ``m`` tones a symbol at 48 kHz, tones
    from half the symbol rate."""
    from anet_torch.dsp.params import ModemConfig

    rate = 48_000 // sps
    return ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=rate, num_tones=m, base_freq_hz=rate / 2)


GENERIC_PRESETS = ("mfsk8-audible", "mfsk32-dense")
TM_ANY_CONFIGS = {  # geometries off a wrapper's walk; 1, 2, 4 and 8 n-tiles, and groups of 32 tones
    "sps15-m4": _custom(15, 4),  # odd sps: the last k-step masked past sample 15
    "sps24-m2": _custom(24, 2),
    "sps40-m4": _custom(40, 4),
    "sps24-m8": _custom(24, 8),
    "sps40-m16": _custom(40, 16),  # chip_smoke.py's aligned-custom modem
    "sps48-m4": _custom(48, 4),  # decide_frame_tm only: decide_tones_tm's walk takes sps 48 and 80
    "sps80-m16": _custom(80, 16),
    "sps96-m16": _custom(96, 16),
    "sps96-m32": _custom(96, 32),  # 8 n-tiles
    "sps128-m64": _custom(128, 64),  # the walks' sps, past their 32 tones: two groups
    "sps1920-m16": _custom(1920, 16),  # 120 k-steps (60 int8): slab by slab, the float32 sums folded
}
TM_ANY_TONES_CONFIGS = ("sps15-m4", "sps24-m2", "sps40-m4", "sps24-m8", "sps96-m32", "sps128-m64", "sps1920-m16")
TM_ANY_FRAME_CONFIGS = ("sps15-m4", "sps24-m2", "sps48-m4", "sps40-m16", "sps80-m16", "sps96-m16", "sps1920-m16")
TM_ANY_BATCHES = (1, 7, 129, 1000)
# decide_tones_tm's walk past decide_frame_tm's geometry: sps 48 and 80 at
# 1, 2, 4 and 8 n-tiles, and 8 n-tiles (17-32 tones, the basis in shared
# memory) at sps 64 and 128
WALK_TONES_CONFIGS = {
    "mfsk8-audible": get_model("mfsk8-audible").config,  # sps 48, 8 tones
    "mfsk32-dense": get_model("mfsk32-dense").config,  # sps 80, 32 tones
    "sps48-m4": _custom(48, 4),
    "sps48-m16": _custom(48, 16),
    "sps80-m4": _custom(80, 4),
    "sps80-m8": _custom(80, 8),
    "sps80-m16": _custom(80, 16),
    "sps64-m32": _custom(64, 32),
    "sps128-m32": _custom(128, 32),
}


def _launched(before):
    torch.cuda.synchronize()
    return {n: tk.launch_counts[n] - before[n] for n in before if tk.launch_counts[n] != before[n]}


@pytest.mark.cuda
@pytest.mark.parametrize("b", TM_ANY_BATCHES)
@pytest.mark.parametrize("geometry", list(WALK_TONES_CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decide_tones_tm_walk_past_frame_geometry(cuda, dtype, geometry, b):
    """decide_tones_tm on its tensor-core walk at the geometries
    decide_frame_tm's walk does not take (sps 48 and 80, 17-32 tones as 8
    n-tiles), both presets among them: B = 1, 7, 129 and 1,000 (rows on
    and off 16 bytes: the 16-byte, element-wise and 4-byte cp.async
    fetches), n_symbols 1, 7, 9 and 67 in turn, a trailing partial symbol
    on every other case; held against the plain version by
    _check_tones_tm (one launch under decide_tones_tm's key, ":f32" for
    float32, none under frame_tm_any's)."""
    cfg = WALK_TONES_CONFIGS[geometry]
    assert tk._tm_operands("decide_tones_tm", cfg, dtype, cuda)[1] == ("split" if dtype == torch.float32 else "mma")
    case = TM_ANY_BATCHES.index(b) + 4 * list(WALK_TONES_CONFIGS).index(geometry)
    rng = np.random.default_rng(600 + case)
    n_sym = (1, 7, 9, 67)[case % 4]
    x = _tones_case(cfg, rng, b, n_sym, dtype, (0, 17)[case % 2], cuda)
    _check_tones_tm(cfg, x)


def _tm_any_route(dtype):
    return "tm_any_split" if dtype == torch.float32 else "tm_any"


def _check_tm_any_tones(cfg, x):
    """One launch of decide_tones_tm on frame_tm_any.cu (under frame_tm_any,
    ":f32" for float32; none elsewhere), held against the plain version's
    energies: float32 (the three-term split) as _check_split_decisions
    holds it; bfloat16 (bf16 products exact, float32 sums in another
    order) with best and total within 1e-5 of the symbol's largest energy
    and the tones equal but where the two largest lie that close; a silent
    symbol's tone the first."""
    before = dict(tk.launch_counts)
    got = tk.decide_tones_tm(cfg, x)
    assert _launched(before) == {_key("frame_tm_any", x.dtype): 1}
    s = x.shape[0] // cfg.samples_per_symbol
    assert all(v.shape == (s, x.shape[1]) for v in got)
    energies = _tm_energies(cfg, x, 0, s, x.dtype)
    assert not bool(got[0].T[energies.amax(-1) == 0].any())
    if x.dtype == torch.float32:
        return _check_split_decisions([v.T for v in got], energies)
    tone, best, total = (v.T for v in got)
    scale = energies.amax(-1)
    top2 = energies.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= 1e-5 * top2[..., 0]
    assert bool(((tone == energies.argmax(-1).int()) | near).all())
    assert bool(((best - scale).abs() <= 1e-5 * scale).all())
    assert bool(((total - energies.sum(-1)).abs() <= 1e-5 * scale).all())
    return int((near & (scale > 0)).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("b", TM_ANY_BATCHES)
@pytest.mark.parametrize("geometry", TM_ANY_TONES_CONFIGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decide_tones_tm_any_every_geometry(cuda, dtype, geometry, b):
    """decide_tones_tm on frame_tm_any.cu's tensor-core walk against its
    plain version on noisy frames' data sections, 3 symbols of noise after
    them and a trailing partial symbol, at sps 15 to 1,920 with 2 to 64
    tones, B = 1, 7, 129 and 1,000 (rows off 16 bytes but at 1,000: the
    element-wise and 4-byte fetches): _check_tm_any_tones, one launch on
    the route _tm_operands names; near-ties rare."""
    cfg = TM_ANY_CONFIGS[geometry]
    assert tk._tm_operands("decide_tones_tm", cfg, dtype, cuda)[1] == _tm_any_route(dtype)
    case = TM_ANY_BATCHES.index(b) + 4 * TM_ANY_TONES_CONFIGS.index(geometry)
    rng = np.random.default_rng(300 + case)
    x = _frame_case(cfg, rng, b, torch.float32, 0, 0)
    sps = cfg.samples_per_symbol
    tail = torch.from_numpy(rng.standard_normal((3 * sps + sps // 2, b)).astype(np.float32))
    x = torch.cat([x, tail]).to(dtype).to(cuda)
    near = _check_tm_any_tones(cfg, x)
    assert near <= max(1, x.shape[0] // sps * b // 50)


@pytest.mark.cuda
@pytest.mark.parametrize("b", TM_ANY_BATCHES)
@pytest.mark.parametrize("geometry", TM_ANY_FRAME_CONFIGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_decide_frame_tm_any_every_geometry(cuda, dtype, geometry, b):
    """decide_frame_tm on frame_tm_any.cu's tensor-core walk against its
    plain version at sps 15, 24, 48, 40, 80, 96 and 1,920 (bits a symbol 2,
    1, 2, 4, 4, 4, 4), whole frames, the data section alone and an odd offset, B
    = 1, 7, 129 and 1,000: _check_frame_tm with frame_tm_any's key (bf16
    and int8 words and CRC counts bit-equal, the quality sums within rtol
    1e-5, atol 0; float32 under the split's tolerance), one launch on the
    route _tm_operands names."""
    cfg = TM_ANY_CONFIGS[geometry]
    assert tk._tm_operands("decide_frame_tm", cfg, dtype, cuda)[1] == _tm_any_route(dtype)
    case = TM_ANY_BATCHES.index(b) + 4 * TM_ANY_FRAME_CONFIGS.index(geometry)
    rng = np.random.default_rng(400 + case)
    offset = (cfg.preamble_samples, 0, 37)[case % 3]
    x = _frame_case(cfg, rng, b, dtype, offset, 0).to(cuda)
    _check_frame_tm(cuda, cfg, x, 7, offset, dtype, name="frame_tm_any")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_frame_tm_any_ties_and_full_width(cuda, dtype):
    """All-zero input (every symbol ties: tone 0, zero energies, words,
    counts and sums) at sps 96 with 32 tones (decide_tones_tm) and sps 80
    with 16 tones (decide_frame_tm); then the main path's batch, B =
    16,384 and 16,383, payload 256 (few blocks a column of streams, each
    walking its share of the tiles): 256 noisy frames tiled across the
    batch, held as above, and decide_tones_tm on the data sections of 256
    sps-96 frames of 32 tones tiled alike."""
    wide, frame_cfg = TM_ANY_CONFIGS["sps96-m32"], TM_ANY_CONFIGS["sps80-m16"]
    if dtype != torch.int8:
        tone, best, total = tk.decide_tones_tm(wide, torch.zeros(9 * 96, 129, dtype=dtype, device=cuda))
        assert not tone.any() and not best.any() and not total.any()
    t = frame_cfg.preamble_samples + data_symbols_for_payload(frame_cfg, PAY) * 80
    words, crc, qual, _ = tk.decide_frame_tm(frame_cfg, torch.zeros(t, 129, dtype=dtype, device=cuda), PAY,
                                             preamble_offset=frame_cfg.preamble_samples)
    assert not words.any() and not crc.any() and not qual.any()
    rng = np.random.default_rng(17)
    for b in (16384, 16383):
        x = _frame_case(frame_cfg, rng, 256, dtype, frame_cfg.preamble_samples, 0, pay=256).to(cuda)
        x = x.repeat(1, 64)[:, 16384 - b :].contiguous()
        _check_frame_tm(cuda, frame_cfg, x, 256, frame_cfg.preamble_samples, dtype, name="frame_tm_any")
        if dtype != torch.int8:
            data = _frame_case(wide, rng, 256, dtype, 0, 0, pay=256).to(cuda).repeat(1, 64)[:, 16384 - b :]
            _check_tm_any_tones(wide, data.contiguous())
            del data
        del x
        torch.cuda.empty_cache()


def _placed(cfg, rng, lens, chunk, b, gap0=700):
    """A [B, N] float32 capture: gap0 zeros, the frames of ``lens`` bytes
    back to back, a frame of silence, whole chunks, noise 0.05."""
    from anet_torch.dsp.family import frame_samples

    t_max = frame_samples(cfg, max(lens))
    parts = [torch.zeros(b, gap0)]
    parts += [transmit(cfg, rng.integers(0, 256, (b, n), dtype=np.uint8), device="cpu") for n in lens]
    cap = torch.cat(parts + [torch.zeros(b, t_max + 300)], -1)
    cap = torch.nn.functional.pad(cap, (0, -cap.shape[1] % chunk))
    return cap + 0.05 * torch.from_numpy(rng.standard_normal(cap.shape).astype(np.float32))


def _same_stream(got, want, frames: int, b: int) -> None:
    assert got.carry.frames_ok.tolist() == [frames] * b
    assert torch.equal(got.steps.detected.cpu(), want.steps.detected)
    det = want.steps.detected
    for f in ("payload", "ok", "header_crc_ok", "payload_crc_ok"):
        assert torch.equal(getattr(got.steps.frame, f).cpu()[det], getattr(want.steps.frame, f)[det]), f
    assert torch.equal(got.steps.frame_start.cpu()[det], want.steps.frame_start[det])
    for f in ("frames_detected", "frames_ok", "decode_errors", "locked", "next_start", "last_frame_end"):
        assert torch.equal(getattr(got.carry, f).cpu(), getattr(want.carry, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("model", GENERIC_PRESETS)
def test_cuda_generic_geometry_receivers_match_cpu(cuda, model):
    """Every receiver of the two presets on the card against the same call
    on the CPU, every frame decoded, payloads and verdicts equal: the
    aligned time-major receiver (bf16 and float32: decide_tones_tm's
    tensor-core walk), the batch-major and one-shot receivers
    (tone_energies_fused's tensor-core routes), receive_stream
    searching on a float32 carry, locked on bf16 and int8 carries, and
    receive_stream_dynamic locked (the slice and the batch-major receiver:
    no align+demod kernel launches). Every time-major launch is on
    decide_tones_tm's keys, none on decide_frame_tm's or frame_tm_any's; every filterbank launch on tone_energies_fused's keys, none on
    its CUDA-core body's."""
    from anet_torch.dsp import frame as tframe
    from anet_torch.dsp import pipeline as tpipeline
    from anet_torch.dsp.family import frame_samples

    cfg = get_model(model).config
    rng = np.random.default_rng(500 + len(model))
    before = dict(tk.launch_counts)
    pay = rng.integers(0, 256, (9, PAY), dtype=np.uint8)
    w = transmit(cfg, pay, device="cpu")
    x = w + 0.3 * torch.from_numpy(rng.standard_normal(w.shape).astype(np.float32))
    for dtype in (torch.bfloat16, torch.float32):
        x_tm = x.T.contiguous().to(dtype)
        on_card = tframe.demodulate_frame_tm(cfg, x_tm.to(cuda), PAY, compute_dtype=dtype, device=cuda)
        on_cpu = tframe.demodulate_frame_tm(cfg, x_tm, PAY, compute_dtype=dtype, device="cpu")
        assert bool(on_card.ok.all()) and np.array_equal(on_card.payload.cpu().numpy(), pay)
        assert all(torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)) for f in
                   ("payload", "ok", "header_crc_ok", "payload_crc_ok"))
        torch.testing.assert_close(on_card.confidence.cpu(), on_cpu.confidence, rtol=1e-5, atol=0)
        bm = tframe.demodulate_frame(cfg, x.to(dtype).to(cuda), PAY, compute_dtype=dtype, device=cuda)
        assert bool(bm.ok.all()) and torch.equal(bm.payload.cpu(), on_cpu.payload)
    starts = torch.tensor([0, 1, 63, 127, 128, 777, 1999, 5, 300])
    cap = 0.2 * torch.from_numpy(rng.standard_normal((9, w.shape[1] + 7000)).astype(np.float32))
    cap.scatter_add_(1, starts[:, None] + torch.arange(w.shape[1]), w)
    got = tpipeline.receive_frame(cfg, cap.to(cuda), PAY, device=cuda)
    want = tpipeline.receive_frame(cfg, cap, PAY, device="cpu")
    assert torch.equal(got.sync.offset.cpu(), starts.int()) and bool(got.frame.ok.all())
    assert torch.equal(got.frame.payload.cpu(), want.frame.payload)

    t_frame = frame_samples(cfg, PAY)
    chunk = t_frame // 128 * 128
    cap = _placed(cfg, rng, (PAY,) * 3, chunk, 9)
    for carry_dtype, lock in ((torch.float32, False), (torch.bfloat16, True), (torch.int8, True)):
        compute = torch.float32 if carry_dtype == torch.float32 else torch.bfloat16
        runs = []
        for dev in (cuda, torch.device("cpu")):
            carry = tstream.init_carry(cfg, chunk, PAY, (9,), dtype=carry_dtype, device=dev)
            runs.append(tstream.receive_stream(cfg, cap.to(dev), chunk, PAY, carry=carry, lock=lock,
                                               compute_dtype=compute, device=dev))
        _same_stream(*runs, 3, 9)
    lens = (8, 48, 24)
    chunk = frame_samples(cfg, min(lens)) // 128 * 128
    cap = _placed(cfg, rng, lens, chunk, 9).to(torch.bfloat16)
    runs = [tstream.receive_stream_dynamic(cfg, cap.to(dev), chunk, 48, compute_dtype=torch.bfloat16,
                                           lock=True, device=dev) for dev in (cuda, torch.device("cpu"))]
    _same_stream(*runs, 3, 9)
    det = runs[1].steps.detected
    assert torch.equal(runs[0].steps.frame.payload_len.cpu()[det], runs[1].steps.frame.payload_len[det])
    launched = _launched(before)
    assert not any(k.startswith(("demod_at_fused", "demod_at_energies_fused", "demod_probe_fused"))
                   for k in launched)
    assert not any(k.startswith(("decide_frame_tm", "frame_tm_any", "filterbank_any"))
                   for k in launched)  # the bodies off the compile-time walks
    assert launched["decide_tones_tm"] and launched["decide_tones_tm:f32"] and launched["sync_search_fused"]
    assert launched["tone_energies_fused"] and launched["tone_energies_fused:f32"] and launched["probe_at_fused"]


# --- the align+demod kernels off their walk: csrc/demod_at_any.cu -------------

# every geometry of the reference's gate (128 % sps == 0) off demod_at.cu's
# walk that a modem below Nyquist has: A rows of 2 to 8 short symbols (sps 4,
# 8, 16), and 32 or 64 tones (one or two groups of 8 n-tiles)
ANY_DEMOD_CONFIGS = {
    "sps4-m2": ModemConfig(48_000, 12_000, num_tones=2, base_freq_hz=3_000.0),
    "sps8-m2": _custom(8, 2),
    "sps8-m4": _custom(8, 4),
    "sps16-m2": _custom(16, 2),
    "sps16-m4": ModemConfig(48_000, 3_000, num_tones=4),
    "sps16-m8": _custom(16, 8),
    "sps64-m32": _custom(64, 32),
    "sps128-m32": ModemConfig(48_000, 375, num_tones=32),
    "sps128-m64": _custom(128, 64),
}


def _check_any_decisions(got, want, energies, dtype):
    """demod_at_any's decisions (tone, best, total) against the plain
    version's and the plain energies [B, S, M] of the same spans: int8
    (exact int32 I/Q) tones and best bit-equal, total within rtol 1e-5;
    bfloat16 tones equal, best and total within 1e-5 of the symbol's
    largest energy (bf16 products exact, float32 sums in another order);
    float32 the split's tolerance and near-tie rule (_check_split_decisions)."""
    if dtype == torch.float32:
        _check_split_decisions(got, energies)
        return
    assert torch.equal(got[0], want[0])
    if dtype == torch.int8:
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
        return
    scale = energies.amax(-1)
    for a, b in zip(got[1:], want[1:]):
        assert bool(((a - b).abs() <= 1e-5 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("geometry", list(ANY_DEMOD_CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_demod_at_any_every_residue(cuda, dtype, geometry, ragged):
    """The three align+demod wrappers off demod_at.cu's walk, on
    csrc/demod_at_any.cu: demod_at_fused, demod_at_energies_fused and
    demod_probe_fused (n_lags 5) against their plain versions at data
    starts of every residue mod 16, a span half past the buffer's end, one
    wholly past it, one before the row's start, rows that start off a
    16-byte boundary and, ``ragged``, a row length that leaves every other
    row off one too; 67 symbols (not a multiple of an A row's r symbols or
    a tile's rows). Decisions by _check_any_decisions; energies: int8
    bit-equal, bfloat16 within 1e-5 of the symbol's largest, float32 the
    split's (_check_split_energies), argmaxes equal but at the split's
    near-ties; the probe's offsets equal. Three launches, all under
    demod_at_any's key for the dtype, none under the walk's keys."""
    cfg = ANY_DEMOD_CONFIGS[geometry]
    assert not tk._tensor_core_geometry(cfg) and tk._demod_at_geometry(cfg)
    rng = np.random.default_rng(len(geometry) + 100 * ragged)
    n_sym = 67
    length = cfg.preamble_samples + n_sym * cfg.samples_per_symbol + 1000 + (5 if ragged else 0)
    buf, st = _demod_buffer(cfg, rng, n_sym, length, dtype, cuda)
    tpl = preamble_waveform(cfg, device=cuda).to(torch.bfloat16)
    before = dict(tk.launch_counts)
    got = tk.demod_at_fused(cfg, buf, st, n_sym)
    energies = tk.demod_at_energies_fused(cfg, buf, st, n_sym)
    probe = tk.demod_probe_fused(cfg, buf, st - 2, n_sym, tpl)
    assert _launched(before) == {_key("demod_at_any", dtype): 3}
    want_e = tk.demod_at_energies_fused_ref(cfg, buf, st, n_sym)
    _check_any_decisions(got, tk.demod_at_fused_ref(cfg, buf, st, n_sym), want_e, dtype)
    if dtype == torch.float32:
        _check_split_energies(energies, want_e)
    elif dtype == torch.int8:
        assert torch.equal(energies, want_e)
    else:
        assert bool(((energies - want_e).abs() <= 1e-5 * want_e.amax(-1, keepdim=True)).all())
        assert torch.equal(energies.argmax(-1).int(), want_e.argmax(-1).int())
    want_p = tk.demod_probe_fused_ref(cfg, buf, st - 2, n_sym, tpl)
    assert torch.equal(probe[1], want_p[1])
    _check_any_decisions(probe[3:], want_p[3:], tk.demod_at_energies_fused_ref(cfg, buf, st - 2 + want_p[1], n_sym),
                         dtype)
    assert not bool(want_e[-2].any())  # the span wholly past the end reads zeros


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["sps16-m4", "sps128-m32"])
def test_cuda_demod_at_any_resident_scan_matches_carry_path(cuda, geometry):
    """receive_stream(lock=True, resident=True) off demod_at.cu's walk
    (sps 16 with 4 tones, sps 128 with 32) against the carry path on the
    same card: 64 streams, payload 64, a gap of 1,000 samples, then 4
    back-to-back frames, bf16. Every frame ok; frames, the final carry's
    buffer and every counter equal. The resident scan demodulates on
    demod_at_any.cu (demod_at_fused's launches under its key, one a chunk),
    the carry path's locked step on it too (demod_probe_fused's)."""
    from anet_torch.dsp.family import frame_samples

    cfg = ANY_DEMOD_CONFIGS[geometry]
    rng = np.random.default_rng(17 + len(geometry))
    b, pay_len = 64, 64
    t = frame_samples(cfg, pay_len)
    chunk = t // 128 * 128
    n = -(-(1000 + 4 * t) // chunk) * chunk
    pay = torch.from_numpy(rng.integers(0, 256, (4 * b, pay_len), dtype=np.uint8)).to(cuda)
    w = transmit(cfg, pay, device=cuda).reshape(4, b, t)
    cap = torch.zeros(b, n, dtype=torch.bfloat16, device=cuda)
    for i in range(4):
        cap[:, 1000 + i * t : 1000 + (i + 1) * t] = w[i].to(torch.bfloat16)
    cap += (0.05 * torch.randn(b, n, device=cuda)).to(torch.bfloat16)
    before = dict(tk.launch_counts)
    want = tstream.receive_stream(cfg, cap, chunk, pay_len, compute_dtype=torch.bfloat16, lock=True,
                                  resident=False, device=cuda)
    carry_path = _launched(before)
    assert carry_path.get("demod_at_any", 0) > 0
    assert not any(k.startswith(("demod_at_fused", "demod_probe_fused")) for k in carry_path)
    before = dict(tk.launch_counts)
    got = tstream.receive_stream(cfg, cap, chunk, pay_len, compute_dtype=torch.bfloat16, lock=True,
                                 resident=True, device=cuda)
    launched = _launched(before)
    assert launched.get("demod_at_any", 0) == n // chunk and "sync_search_fused" in launched
    assert not any(k.startswith(("demod_at_fused", "demod_probe_fused", "probe_at_fused")) for k in launched)
    assert int(got.carry.frames_ok.sum()) == 4 * b
    assert torch.equal(got.steps.detected, want.steps.detected)
    det = got.steps.detected
    assert torch.equal(got.steps.frame.payload[det], want.steps.frame.payload[det])
    assert torch.equal(got.steps.frame.ok, want.steps.frame.ok)
    assert torch.equal(got.steps.frame_start[det], want.steps.frame_start[det])
    for f in tstream.StreamCarry._fields:
        assert torch.equal(getattr(got.carry, f), getattr(want.carry, f)), f
