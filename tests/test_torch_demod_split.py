"""The stream's float32 align+demod on the tensor cores: demod_at_fused's
float32 buffers, alone and as demod_probe_fused's demod, run
csrc/demod_at.cu's walk with the three-term bf16 split (SplitTerms: the
float32 basis and the float32 samples each as three bf16 terms, six of the
nine products kept), and demod_at_energies_fused's float32 buffers (the
coded stream's default carry) run the same walk in csrc/demod_at_energies.cu
with the energies epilogue. The kernels run only on the card, so these
tests model them on the CPU: the walk's span read (demod_core.cuh's fetch
into a warp's ring, the zeroing before the row's start and the fragments'
sample offsets) transliterated over a flat float32 memory, and its
arithmetic by test_torch_filterbank_split.emulate_iq on the spans so read.
The emulated decisions are held against demod_at_fused_ref,
demod_probe_fused_ref and anet's Pallas kernel (interpret mode) with the
split's stated tolerance (kernels.F32_SPLIT_RTOL, F32_SPLIT_ATOL): best and
total within it, tones equal but where the plain version's two largest
energies lie that close; the emulated energies against
demod_at_energies_fused_ref and the Pallas demod_at_energies_fused, each
within that tolerance, and, on noisy coded frames, their LLRs through the
plain Viterbi give the plain energies' payloads and verdicts. The card's
own comparison: test_torch_kernels_cuda.py -k "residue or
demod_probe_at_every"."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_filterbank_split import emulate_iq

import anet.kernels as jk
from anet.models import get_model as jget_model

from anet_torch import kernels as tk
from anet_torch import stream as tstream
from anet_torch.dsp import frame as tframe
from anet_torch.dsp.demod import decide_symbols
from anet_torch.dsp.pipeline import transmit
from anet_torch.dsp.sync import gather_span, preamble_waveform
from anet_torch.models import OPERATING_SNR_DB, get_model

# mfsk16-fast (sps 64, 16 tones), mfsk4-coded (sps 32, 4 tones), a sps-32
# preset of 16 tones and the sps-128 one (2 tones)
PRESETS = ("mfsk16-fast", "mfsk4-coded", "mfsk16-ultra", "fsk2-robust")
N_SYM = 67  # not a multiple of a tile's 16 symbols
PAYLOAD = 64  # bytes of each planted frame
WARPS, STAGE_TARGET = 4, 2048  # demod_core.cuh's block and tile geometry


def _shape(sps: int) -> dict:
    """demod_core.cuh's Shape<float, SPS>, in bytes."""
    sb = 4 * sps
    mt = 1 if 16 * sb >= STAGE_TARGET else STAGE_TARGET // (16 * sb)
    return {"SB": sb, "CPS": sb // 16, "WPS": sb // 4, "ROW": sb + 16, "SYMS": 16 * mt,
            "CHUNKS": 16 * mt * (sb // 16) + 1}


def walk_spans(cfg, mem: np.ndarray, off: int, b: int, length: int, start: np.ndarray, n_symbols: int):
    """The samples [B, n_symbols, sps] that demod_at_mma_f32's fragments
    read, from a Span of ``b`` contiguous rows of ``length`` float32 samples
    at element ``off`` of the flat memory ``mem`` (whose element 0 lies on
    a 16-byte boundary): per (stream, tile) item the 16-byte chunks of the
    tile's span aligned down in the flat memory, copied as cp.async's source
    size allows (nothing past the row's end, nothing for a chunk wholly
    outside the row, the rest of a chunk zero-filled), the bytes before the
    row's start zeroed after the copy, each symbol's word x read at 4 x of
    its ring row, or past the row's 16 bytes of pad for x >= WPS. Also
    returns the lowest and highest memory element a copy read."""
    sps, pre = cfg.samples_per_symbol, cfg.preamble_samples
    s = _shape(sps)
    sb, cps, wps, row_b, syms, chunks = (s[k] for k in ("SB", "CPS", "WPS", "ROW", "SYMS", "CHUNKS"))
    membytes = mem.view(np.uint8)
    out = np.empty((b, n_symbols, sps), np.float32)
    lo_read, hi_read = np.inf, -np.inf
    tiles = -(-n_symbols // syms)
    for j in range(b * tiles):
        bb, s0 = divmod(j, tiles)
        s0 *= syms
        n = min(syms, n_symbols - s0)
        pos = int(start[bb]) + pre + s0 * sps
        at = 4 * (off + bb * length + pos)
        rb = at % 16
        chunk0 = at - rb
        need = (rb + n * sb + 15) // 16
        p0 = pos - rb // 4
        stage = np.full(syms * row_b + 16, 0xAB, np.uint8)  # the ring stage: old bytes
        for c in range(chunks):
            p = p0 + 4 * c
            left = length - p
            nbytes = 4 * min(left, 4) if (c < need and p + 4 > 0 and left > 0) else 0
            dst = (c // cps) * row_b + (c % cps) * 16
            stage[dst : dst + 16] = 0
            if nbytes:
                src = chunk0 + 16 * c
                stage[dst : dst + nbytes] = membytes[src : src + nbytes]
                lo_read, hi_read = min(lo_read, src // 4), max(hi_read, (src + nbytes) // 4 - 1)
        if pos < 0:
            for y in range(min(rb - 4 * pos, chunks * 16)):
                stage[(y // sb) * row_b + y % sb] = 0
        words = stage.view(np.float32)
        for g in range(n):
            x = rb // 4 + np.arange(sps)
            o = 4 * x + np.where(x >= wps, 16, 0)
            out[bb, s0 + g] = words[(g * row_b + o) // 4]
    return out, lo_read, hi_read


def _stream_buffer(cfg, rng, starts, length: int, off: int, noise: float = 0.3):
    """(flat float32 memory, the [B, length] buffer at element ``off`` of
    it, the payloads [B, PAYLOAD]): noise of standard deviation ``noise``
    and a frame at each start, NaN outside the buffer."""
    pay = rng.integers(0, 256, (len(starts), PAYLOAD), dtype=np.uint8)
    w = transmit(cfg, pay, device="cpu").numpy()
    x = noise * rng.standard_normal((len(starts), length)).astype(np.float32)
    for i, s in enumerate(starts):
        lo, hi = max(s, 0), min(s + w.shape[1], length)
        if lo < hi:
            x[i, lo:hi] += w[i, lo - s : hi - s]
    mem = np.full(off + x.size + 16, np.nan, np.float32)
    mem[off : off + x.size] = x.reshape(-1)
    return mem, x, pay


def _starts(cfg, length: int) -> np.ndarray:
    """Data starts at every residue mod 16 samples (every 16-byte residue
    four times over), a span half past the row's end, one wholly past it
    and one beginning before the row's start."""
    sps, pre = cfg.samples_per_symbol, cfg.preamble_samples
    st = [300 + r for r in range(16)]
    st += [length - pre - (N_SYM * sps) // 2 - 3, length, -pre - 2 * sps - 5]
    return np.array(st, np.int64)


def _length(cfg) -> int:
    return cfg.preamble_samples + N_SYM * cfg.samples_per_symbol + 700


def emulated_energies(cfg, spans: np.ndarray) -> torch.Tensor:
    """Energies [B, S, M] of the split's arithmetic on the spans [B, S,
    sps]: emulate_iq's I/Q, I*I + Q*Q rounded after each operation."""
    b, s, sps = spans.shape
    iq = emulate_iq(cfg, torch.from_numpy(spans.reshape(b, s * sps)))
    m = cfg.num_tones
    return iq[..., :m] * iq[..., :m] + iq[..., m:] * iq[..., m:]


def emulated_decisions(cfg, spans: np.ndarray):
    """(tone, best, total) of emulated_energies, the first argmax."""
    e = emulated_energies(cfg, spans)
    return e.argmax(-1).int(), e.amax(-1), e.sum(-1)


def _bound(want: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return tk.F32_SPLIT_RTOL * want.abs() + tk.F32_SPLIT_ATOL * scale


def assert_split_decisions(got, energies: torch.Tensor, want=None) -> int:
    """The split's decisions ``got`` against the plain energies [B, S, M]
    (and, where given, the decisions ``want`` made from them elsewhere):
    best and total within the stated tolerance, tones equal but at
    near-ties. Returns the near-tie count among symbols with energy (a
    span read as zeros ties every tone: its tone must be the first)."""
    tone, best, total = got
    scale, total_w = energies.amax(-1), energies.sum(-1)
    top2 = energies.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= _bound(top2[..., 0], top2[..., 0])
    tone_w = energies.argmax(-1).int()
    if want is not None:
        assert bool(((want[0] == tone_w) | near).all())
        scale_w, total_w = want[1], want[2]
        assert bool(((scale_w - scale).abs() <= _bound(scale, scale)).all())
        scale = scale_w
    assert bool(((tone == tone_w) | near).all())
    assert bool(((best - scale).abs() <= _bound(scale, scale)).all())
    assert bool(((total - total_w).abs() <= _bound(total_w, scale)).all())
    silent = scale == 0
    assert not bool(tone[silent].any())
    return int((near & ~silent).sum())


def assert_split_energies(got: torch.Tensor, energies: torch.Tensor, want=None) -> int:
    """The split's energies ``got`` [B, S, M] against the plain energies of
    the same spans, or, where given, against the energies ``want`` computed
    from them elsewhere (themselves within the same bound of the plain
    ones): each within the stated tolerance, F32_SPLIT_RTOL of itself plus
    F32_SPLIT_ATOL of its symbol's largest; the argmax equal but at
    near-ties of the energies held against. Returns the near-tie count
    among symbols with energy."""
    scale = energies.amax(-1, keepdim=True)
    if want is not None:
        assert bool(((want - energies).abs() <= _bound(energies, scale)).all())
        energies, scale = want, want.amax(-1, keepdim=True)
    assert bool(((got - energies).abs() <= _bound(energies, scale)).all())
    top2 = energies.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= _bound(top2[..., 0], top2[..., 0])
    assert bool(((got.argmax(-1) == energies.argmax(-1)) | near).all())
    return int((near & (scale[..., 0] > 0)).sum())


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("name", PRESETS)
def test_walk_reads_the_gathered_span(name, off):
    """The transliterated span read of a float32 Span equals gather_span at
    every start (each residue mod 16 bytes, and rows starting ``off``
    elements past a 16-byte boundary), zeros before the row's start and
    past its end included, and no copy reads outside the 16-byte chunks
    that hold the buffer."""
    cfg = get_model(name).config
    rng = np.random.default_rng(len(name) + off)
    length = _length(cfg)
    starts = _starts(cfg, length)
    mem, x, _ = _stream_buffer(cfg, rng, starts, length, off)
    spans, lo, hi = walk_spans(cfg, mem, off, len(starts), length, starts, N_SYM)
    sps, pre = cfg.samples_per_symbol, cfg.preamble_samples
    want = gather_span(torch.from_numpy(x), torch.from_numpy(starts + pre), N_SYM * sps)
    np.testing.assert_array_equal(spans.reshape(len(starts), -1), want.numpy())
    assert lo >= off // 4 * 4 and hi < -(-(off + x.size) // 4) * 4
    assert not spans[-2].any()  # the span wholly past the end reads zeros


def _walked_buffer(name: str):
    """(config, the spans the walk reads, the [B, length] float32 buffer,
    the int32 starts) of a stream buffer at _starts' starts, rows one
    element past a 16-byte boundary."""
    cfg = get_model(name).config
    rng = np.random.default_rng(3 + len(name))
    length = _length(cfg)
    starts = _starts(cfg, length)
    mem, x, _ = _stream_buffer(cfg, rng, starts, length, 1)
    spans, _, _ = walk_spans(cfg, mem, 1, len(starts), length, starts, N_SYM)
    return cfg, spans, torch.from_numpy(x), torch.from_numpy(starts.astype(np.int32))


@pytest.mark.parametrize("name", PRESETS)
def test_emulated_split_decisions_match_demod_at_ref(name):
    """The kernel's span read and split arithmetic on a float32 stream
    buffer against demod_at_fused_ref at the same starts: best and total
    within the stated tolerance, tones equal but at the plain version's
    near-ties (rare at this noise)."""
    cfg, spans, buf, st = _walked_buffer(name)
    got = emulated_decisions(cfg, spans)
    want = tk.demod_at_fused_ref(cfg, buf, st, N_SYM)
    near = assert_split_decisions(got, tk.demod_at_energies_fused_ref(cfg, buf, st, N_SYM), want)
    assert near < want[0].numel() // 100
    assert not bool(got[2][-2].any())


@pytest.mark.parametrize("name", PRESETS)
def test_emulated_split_energies_match_demod_at_energies_ref(name):
    """demod_at_energies_fused on a float32 stream buffer: the same span
    read and split arithmetic as demod_at_fused's, every tone's energy
    stored. The emulated energies against demod_at_energies_fused_ref at
    the same starts: each within the stated tolerance, the argmax equal but
    at near-ties; the span wholly past the end all zeros."""
    cfg, spans, buf, st = _walked_buffer(name)
    got = emulated_energies(cfg, spans)
    want = tk.demod_at_energies_fused_ref(cfg, buf, st, N_SYM)
    assert got.shape == want.shape == (len(st), N_SYM, cfg.num_tones)
    assert assert_split_energies(got, want) < want[..., 0].numel() // 100
    assert not bool(got[-2].any())


@pytest.mark.parametrize("name", PRESETS)
def test_emulated_split_decisions_match_demod_probe_ref(name):
    """demod_probe_fused on a float32 buffer: the probe (unchanged) refines
    each start, then demod_at.cu's split runs there. The emulated demod at
    the plain probe's refined starts against demod_probe_fused_ref's
    decisions, with the split's tolerance and near-tie rule; the probe
    bases lie at every residue mod 16, before the row's start and past its
    end."""
    cfg = get_model(name).config
    rng = np.random.default_rng(11 + len(name))
    length = _length(cfg)
    lag = 2
    starts = _starts(cfg, length)
    mem, x, _ = _stream_buffer(cfg, rng, starts + lag, length, 2)
    buf, st0 = torch.from_numpy(x), torch.from_numpy(starts.astype(np.int32))
    tpl = preamble_waveform(cfg, device="cpu")
    cmax, off, energy, tone, best, total = tk.demod_probe_fused_ref(cfg, buf, st0, N_SYM, tpl, n_lags=5)
    assert bool((off[:16] == lag).all())  # the planted frames, wholly inside the row
    refined = (st0 + off).numpy().astype(np.int64)
    spans, _, _ = walk_spans(cfg, mem, 2, len(starts), length, refined, N_SYM)
    got = emulated_decisions(cfg, spans)
    energies = tk.demod_at_energies_fused_ref(cfg, buf, st0 + off, N_SYM)
    near = assert_split_decisions(got, energies, (tone, best, total))
    assert near < tone.numel() // 100


PALLAS_CHUNK = 4096


def _pallas_buffer(name: str):
    """(config, the spans the walk reads, the [B, length] float32 stream
    buffer of a PALLAS_CHUNK-sample chunk, its int32 starts) of one
    stream buffer whose starts lie at the chunk's ends and at every
    residue mod 16, rows 3 elements past a 16-byte boundary."""
    cfg = get_model(name).config
    rng = np.random.default_rng(21)
    length = tstream._buffer_len(cfg, PALLAS_CHUNK, PAYLOAD)
    starts = np.array([1, 700, PALLAS_CHUNK - 1] + [1000 + r for r in range(16)], np.int64)
    mem, x, _ = _stream_buffer(cfg, rng, starts, length, 3)
    spans, _, _ = walk_spans(cfg, mem, 3, len(starts), length, starts, N_SYM)
    return cfg, spans, torch.from_numpy(x), torch.from_numpy(starts.astype(np.int32))


def _pallas(kernel, name: str, buf: torch.Tensor, st: torch.Tensor):
    """anet's Pallas ``kernel`` (interpret mode) on the buffer at the starts,
    as test_torch_kernels_ref.py runs it."""
    return kernel(jget_model(name).config, jnp.asarray(buf.numpy()), jnp.asarray(st.numpy()), N_SYM,
                  start_bound=PALLAS_CHUNK, interpret=True)


def test_emulated_split_decisions_match_pallas():
    """The emulated split on one mfsk16-fast float32 stream buffer against
    anet's Pallas demod_at_fused (interpret mode), as
    test_torch_kernels_ref.py runs it: best and total within the stated
    tolerance of the Pallas kernel's, tones equal but at near-ties of the
    plain energies."""
    name = "mfsk16-fast"
    cfg, spans, buf, st = _pallas_buffer(name)
    got = emulated_decisions(cfg, spans)
    want = tuple(torch.from_numpy(np.array(v)) for v in _pallas(jk.demod_at_fused, name, buf, st))
    near = assert_split_decisions(got, tk.demod_at_energies_fused_ref(cfg, buf, st, N_SYM), want)
    assert near < want[0].numel() // 100


def test_emulated_split_energies_match_pallas():
    """The emulated split on one mfsk4-coded float32 stream buffer (the
    coded stream's default carry) against anet's Pallas
    demod_at_energies_fused (interpret mode): the Pallas energies within
    the stated tolerance of the plain ones, the emulated energies within it
    of the Pallas kernel's, the argmax equal but at near-ties."""
    name = "mfsk4-coded"
    cfg, spans, buf, st = _pallas_buffer(name)
    got = emulated_energies(cfg, spans)
    want = torch.from_numpy(np.array(_pallas(jk.demod_at_energies_fused, name, buf, st)))
    near = assert_split_energies(got, tk.demod_at_energies_fused_ref(cfg, buf, st, N_SYM), want)
    assert near < want[..., 0].numel() // 100


@pytest.mark.parametrize("snr_offset_db", [0.0, -2.5])
def test_emulated_split_energies_decode_as_the_plain_energies(snr_offset_db):
    """The coded stream's soft decisions on float32 energies: 20 noisy
    mfsk4-coded frames in one float32 stream buffer (data starts at every
    residue mod 16), at the preset's operating SNR and 2.5 dB below it,
    where frames start to fail. The emulated split energies' max-log LLRs,
    deinterleaved through the plain Viterbi (frame_result_from_decisions,
    as the locked coded step parses them), give every frame's payload
    bytes and its magic, length, CRC and ok verdicts equal to those of the
    plain energies; at the operating SNR every frame is ok and as sent."""
    name = "mfsk4-coded"
    cfg = get_model(name).config
    n_sym = tframe.data_symbols_for_payload(cfg, PAYLOAD)
    t_frame = tframe.frame_num_samples(cfg, PAYLOAD)
    starts = np.array([300 + r for r in range(20)], np.int64) - cfg.preamble_samples
    length = 1020 + t_frame
    rng = np.random.default_rng(31)
    power = float((transmit(cfg, np.zeros((1, PAYLOAD), np.uint8), device="cpu") ** 2).mean())
    noise = (power / 10.0 ** ((OPERATING_SNR_DB[name] + snr_offset_db) / 10.0)) ** 0.5
    mem, x, pay = _stream_buffer(cfg, rng, starts, length, 1, noise)
    spans, _, _ = walk_spans(cfg, mem, 1, len(starts), length, starts, n_sym)
    buf, st = torch.from_numpy(x), torch.from_numpy(starts.astype(np.int32))
    plain = tk.demod_at_energies_fused_ref(cfg, buf, st, n_sym)
    split = emulated_energies(cfg, spans)
    assert_split_energies(split, plain)
    got, want = (tframe.frame_result_from_decisions(cfg, decide_symbols(cfg, e), e, PAYLOAD) for e in (split, plain))
    for field in ("payload", "magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok", "ok"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    if snr_offset_db == 0.0:
        assert bool(want.ok.all()) and np.array_equal(want.payload.numpy(), pay)
    else:
        assert 0 < int(want.ok.sum()) < len(starts)  # the cliff: both verdicts met
