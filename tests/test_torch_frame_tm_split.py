"""The time-major pair's float32 route on the tensor cores: decide_frame_tm
and decide_tones_tm on float32 frames run csrc/decide_frame_tm.cu's walk
(frame_tm_mma_f32<...>) with demod_core.cuh's three-term bf16 split
(SplitTerms: the float32 basis and each float32 sample as three bf16
terms, six of the nine products kept). The kernel runs only on the card,
so these tests model it on the CPU: the walk's time-major read (fetch's
16-byte or 4-byte copies into the swizzled ring stage, then
a_split's 32-bit shared loads into each lane's A registers) transliterated
over a flat float32 memory and held against the rows sliced directly, the
banks of each shared load counted, and the arithmetic of the rows so read
emulated by test_torch_filterbank_split.emulate_iq. The emulated
decisions, packed words, CRC counts (popcounts of the words against
kernels._frame_crc_masks) and quality sums are held against
decide_frame_tm_ref, decide_tones_tm_ref and anet's Pallas kernels
(interpret mode, float32 compute) with the split's stated tolerance
(kernels.F32_SPLIT_RTOL, F32_SPLIT_ATOL): tones, words and CRC counts equal
but where the plain version's two largest energies lie within it. The
card's own comparison: test_torch_kernels_cuda.py -k "frame_tm or
tones_tm"."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_filterbank_split import emulate_iq

import anet.kernels as jk
from anet.models import get_model as jget_model

from anet_torch import kernels as tk
from anet_torch.dsp.frame import data_symbols_for_payload
from anet_torch.dsp.pipeline import transmit
from anet_torch.models import get_model

NB, WARPS = 64, 4  # decide_frame_tm.cu: streams and warps a block
CH, E, PITCH = 16, 4, 272  # Geo<float, SPS>: 16-byte chunks a staged row, streams a chunk, row bytes
SB = tk.TM_SYMBOL_TILE
PAY = 7
CPU = torch.device("cpu")
# sps 32, 64 and 128 with 2, 4 and 16 tones (1, 2 and 4 bits a symbol), as
# test_torch_kernels_cuda.py's FRAME_CONFIGS; the names of anet's presets
# they are made from, so its Pallas kernels see the same geometry
CONFIGS = {
    "fsk2-robust": ("fsk2-robust", {}),  # sps 128, 2 tones
    "mfsk4-sps32": ("mfsk4-coded", {"fec": "none"}),  # sps 32, 4 tones
    "mfsk4-sps64": ("mfsk16-fast", {"num_tones": 4}),  # sps 64, 4 tones
    "mfsk16-fast": ("mfsk16-fast", {}),  # sps 64, 16 tones
    "mfsk16-ultra": ("mfsk16-ultra", {}),  # sps 32, 16 tones
    "mfsk16-sps128": ("mfsk16-fast", {"symbol_rate_hz": 375}),  # sps 128, 16 tones
}


def _configs(name: str):
    """(the port's config, anet's) of CONFIGS[name]."""
    preset, changes = CONFIGS[name]
    return (dataclasses.replace(get_model(preset).config, **changes),
            dataclasses.replace(jget_model(preset).config, **changes))


def chunk_at(t, q):
    """Byte offset of chunk q of staged row t: rows PITCH bytes apart, chunk
    q at q ^ 2 in rows whose bit 3 is set."""
    return t * PITCH + 16 * (q ^ (((t >> 3) & 1) << 1))


def fetch(mem: np.ndarray, off: int, b: int, row0: int, s: int, sps: int, b0: int) -> np.ndarray:
    """The ring stage that fetch leaves for symbol s of the block of
    streams b0 .. b0 + 63, from [T, b] time-major float32 rows at element
    ``off`` of the flat memory ``mem`` (element 0 on a 16-byte boundary):
    16-byte copies when every row piece starts on a 16-byte boundary (off
    and b multiples of 4), cp.async's source size stopping each at the
    last stream and zero-filling the rest of its chunk; else a 4-byte copy
    a sample, source size 0 (zeros) past the last stream. Bytes no copy
    writes (the rows' pads) keep the stage's old 0xAB. Every read lies in
    the rows."""
    membytes = mem.view(np.uint8)
    stage = np.full(sps * PITCH, 0xAB, np.uint8)
    r0 = row0 + s * sps
    lo, hi = 4 * off, 4 * (off + (r0 + sps) * b)
    if off % 4 == 0 and b % 4 == 0:
        c = np.arange(sps * CH)
        t, q = c // CH, c % CH
        col = b0 + q * E
        live = b - col
        nbytes = np.where(live >= E, 16, np.where(live > 0, 4 * live, 0))
        src = 4 * (off + (r0 + t) * b + col)
        j = np.arange(16)
        valid = j < nbytes[:, None]
        dst = chunk_at(t, q)[:, None] + j
        src = src[:, None] + j
        assert bool(((src[valid] >= lo) & (src[valid] < hi)).all())
        stage[dst[valid]] = membytes[src[valid]]
        stage[dst[~valid]] = 0
    else:  # thread (t0, col) of 2 x 64 copies rows t0 + 2 k of its column
        tid, k = np.meshgrid(np.arange(2 * NB), np.arange(sps // 2), indexing="ij")
        col, t0 = tid % NB, tid // NB
        live = b0 + col < b
        src = off + (r0 + t0) * b + b0 + col + 2 * k * b
        dst = t0 * PITCH + 4 * (col & 3) + 2 * k * PITCH + 16 * np.where((k >> 2) & 1, (col >> 2) ^ 2, col >> 2)
        assert np.array_equal(dst, chunk_at(t0 + 2 * k, col >> 2) + 4 * (col & 3))
        v = np.where(live, mem[np.where(live, src, off)], np.float32(0)).astype(np.float32)
        assert bool(((4 * src[live] >= lo) & (4 * src[live] < hi)).all())
        stage[dst.reshape(-1, 1) + np.arange(4)] = v.reshape(-1).view(np.uint8).reshape(-1, 4)
    return stage


def a_split_offsets(sps: int) -> np.ndarray:
    """Byte offsets [KS, warp, hk, h, c, lane] in a stage of the samples
    a_split loads: lane (g, i) of a warp, k-step ks, register 2 hk + h,
    c 0 (its low half) or 1: time 16 ks + 8 hk + 2 i + c, the block's
    stream column 16 warp + 8 h + g."""
    ks, w, hk, h, c, lane = np.meshgrid(np.arange(sps // 16), np.arange(WARPS), np.arange(2), np.arange(2),
                                        np.arange(2), np.arange(32), indexing="ij")
    g, i = lane >> 2, lane & 3
    t = 16 * ks + 8 * hk + 2 * i + c
    col = 16 * w + 8 * h + g
    return chunk_at(t, col >> 2) + 4 * (col & 3)


def a_registers(stage: np.ndarray, sps: int) -> np.ndarray:
    """The samples [KS, warp, hk, h, c, lane] that a_split reads from a
    stage, before their split into bf16 terms."""
    o = a_split_offsets(sps)
    assert not (o % 4).any()
    return stage.view(np.float32)[o // 4]


def block_rows(stage: np.ndarray, sps: int) -> np.ndarray:
    """The [64 streams, sps times] samples that the block's A fragments
    hold at one symbol: register 2 hk + h of lane (g, i) at k-step ks is M
    row g + 8 h of its warp's m16 tile (stream 16 warp + 8 h + g), K
    columns 2 i + 8 hk + (0, 1) (times 16 ks + ...). Each (stream, time)
    is held exactly once."""
    regs = a_registers(stage, sps)
    ks, w, hk, h, c, lane = np.meshgrid(*(np.arange(n) for n in regs.shape), indexing="ij")
    stream = 16 * w + 8 * h + (lane >> 2)
    time = 16 * ks + 8 * hk + 2 * (lane & 3) + c
    out = np.full((NB, sps), np.nan, np.float32)
    seen = np.zeros((NB, sps), np.int64)
    out[stream.ravel(), time.ravel()] = regs.ravel()
    np.add.at(seen, (stream.ravel(), time.ravel()), 1)
    assert (seen == 1).all()
    return out


def walk_rows(mem: np.ndarray, off: int, b: int, row0: int, n_symbols: int, sps: int) -> np.ndarray:
    """The samples [B, n_symbols, sps] the walk's A fragments hold, every
    block of 64 streams and every symbol read through fetch and a_split."""
    out = np.empty((b, n_symbols, sps), np.float32)
    for b0 in range(0, b, NB):
        for s in range(n_symbols):
            out[b0 : b0 + NB, s] = block_rows(fetch(mem, off, b, row0, s, sps, b0), sps)[: b - b0]
    return out


def _flat(x_tm: np.ndarray, off: int) -> np.ndarray:
    """A flat float32 memory holding the [T, B] rows at element ``off``,
    NaN before and after them."""
    mem = np.full(off + x_tm.size + 16, np.nan, np.float32)
    mem[off : off + x_tm.size] = x_tm.reshape(-1)
    return mem


def _frames_tm(cfg, rng, b: int, pre: int, extra: int = 0, noise: float = 0.3) -> np.ndarray:
    """[T, B] time-major float32 frames of PAY-byte payloads at ``noise``,
    the data section from row ``pre`` (whole frames when it is the
    preamble's length, else that many rows of noise before it), then
    ``extra`` rows of noise."""
    w = transmit(cfg, rng.integers(0, 256, (b, PAY), dtype=np.uint8), device="cpu").numpy()
    p = cfg.preamble_samples
    head = w[:, :p] if pre == p else rng.standard_normal((b, pre)).astype(np.float32)
    x = np.concatenate([head, w[:, p:], rng.standard_normal((b, extra)).astype(np.float32)], -1)
    x = x + noise * rng.standard_normal(x.shape).astype(np.float32)
    return np.ascontiguousarray(x.T)


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("b", [1, 7, 8, 129])
@pytest.mark.parametrize("sps", [32, 64, 128])
def test_walk_reads_the_time_major_rows(sps, b, off):
    """The transliterated read of float32 rows (16-byte copies when the
    rows start ``off`` = 0 elements past a 16-byte boundary and B is a
    multiple of 4, else 4-byte copies) puts in each lane's A registers the
    sample of its (stream, time), equal to the rows sliced directly, zeros
    for streams past B, at a data section starting at an odd row."""
    rng = np.random.default_rng(sps + b + off)
    row0, n_sym = 3, 3
    x = rng.standard_normal((row0 + n_sym * sps, b)).astype(np.float32)
    mem = _flat(x, off)
    for b0 in range(0, b, NB):
        for s in range(n_sym):
            got = block_rows(fetch(mem, off, b, row0, s, sps, b0), sps)
            want = np.zeros((NB, sps), np.float32)
            live = x[row0 + s * sps : row0 + (s + 1) * sps, b0 : b0 + NB].T
            want[: live.shape[0]] = live
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sps", [32, 64, 128])
def test_a_split_loads_hit_32_banks(sps):
    """Each of a_split's 32-bit shared loads (one k-step, warp, register
    and half) reads 32 words in 32 distinct banks: the eight times of a
    load lie in one half of the chunk swizzle, so word (time, stream) sits
    in bank 4 time + stream mod 32 up to one shift."""
    banks = (a_split_offsets(sps) // 4) % 32
    loads = banks.reshape(-1, 32)
    assert loads.shape[0] == (sps // 16) * WARPS * 8
    assert all(len(set(row)) == 32 for row in loads.tolist())


def _energies(cfg, x_tm: torch.Tensor, row0: int, n_symbols: int) -> torch.Tensor:
    """The plain energies [B, S, M] of the float32 rows' symbols from row0
    (the float32 basis, float32 product)."""
    sps, m = cfg.samples_per_symbol, cfg.num_tones
    w = x_tm[row0 : row0 + n_symbols * sps].reshape(n_symbols, sps, -1)
    iq = torch.einsum("mk,skb->bsm", tk._plain_basis(cfg, torch.float32, CPU).T, w)
    return iq[..., :m] * iq[..., :m] + iq[..., m:] * iq[..., m:]


def emulated_energies(cfg, rows: np.ndarray) -> torch.Tensor:
    """Energies [B, S, M] of the split's arithmetic on the rows [B, S, sps]
    the walk read: emulate_iq's I/Q, I*I + Q*Q rounded after each."""
    b, s, sps = rows.shape
    iq = emulate_iq(cfg, torch.from_numpy(rows.reshape(b, s * sps)))
    m = cfg.num_tones
    return iq[..., :m] * iq[..., :m] + iq[..., m:] * iq[..., m:]


def emulated_frame(cfg, e: torch.Tensor, payload_len: int):
    """decide_frame_tm's epilogue on the energies [B, S, M]: the first
    argmax, Gray decoded, 8 symbols a word MSB-first (padded symbols 0),
    the CRC counts as the sum over tiles of popc(word & mask[tile, c])
    (kernels._frame_crc_masks), and each stream's quality sums taken in
    float32 symbol by symbol. Returns (tone [S, B], words, crc, qual)."""
    b, s, _ = e.shape
    bps = cfg.bits_per_symbol
    tone = e.argmax(-1).int()
    data = tone.clone()
    sh = 1
    while sh < bps:
        data ^= data >> sh
        sh <<= 1
    n_tiles = -(-s // SB)
    data = torch.nn.functional.pad(data, (0, n_tiles * SB - s)).reshape(b, n_tiles, SB).numpy().astype(np.uint64)
    place = np.uint64(bps) * (SB - 1 - np.arange(SB, dtype=np.uint64))
    words = (data << place).sum(-1).astype(np.uint32).T  # [n_tiles, B]
    masks = tk._frame_crc_masks(payload_len, n_tiles, bps, CPU).numpy().view(np.uint32)
    crc = np.bitwise_count(words[:, None, :] & masks[:, :, None]).sum(0).astype(np.float32)
    best, total = e.amax(-1), e.sum(-1)
    qual = torch.zeros(8, b)
    for k in range(s):  # a lane's sums, one symbol at a time in float32
        qual[0] += best[:, k] / total[:, k].clamp_min(1e-20)
        qual[1] += best[:, k]
        qual[2] += total[:, k]
    return tone.T, torch.from_numpy(words.view(np.int32)), torch.from_numpy(crc), qual


def _bound(want: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return tk.F32_SPLIT_RTOL * want.abs() + tk.F32_SPLIT_ATOL * scale


def near_ties(energies: torch.Tensor) -> torch.Tensor:
    """[S, B]: symbols whose two largest plain energies lie within the
    split's tolerance of each other."""
    top2 = energies.topk(2, dim=-1).values
    return ((top2[..., 0] - top2[..., 1]) <= _bound(top2[..., 0], top2[..., 0])).T


def assert_frame_outputs(got, want, energies: torch.Tensor) -> int:
    """The split's decide_frame_tm outputs ``got`` (tone [S, B] or None,
    words, crc, qual) against ``want`` (words, crc, qual) of a plain
    float32 computation, with the plain energies [B, S, M]: words equal
    but in tiles where a tone parted at a near-tie, CRC counts equal but in
    streams with such a tone; best and total sums within F32_SPLIT_RTOL of
    themselves plus F32_SPLIT_ATOL of the sum of the symbols' largest
    energies, and conf, their ratio summed, within twice (F32_SPLIT_RTOL +
    F32_SPLIT_ATOL) of itself. Returns the count of parted tones."""
    tone, words, crc, qual = got
    near = near_ties(energies)
    parted = torch.zeros_like(near)
    if tone is not None:
        parted = tone != energies.argmax(-1).int().T
        assert bool((~parted | near).all())
        s = parted.shape[0]
        tiles = torch.nn.functional.pad(parted, (0, 0, 0, -s % SB)).reshape(-1, SB, parted.shape[1]).any(1)
        assert torch.equal(words[~tiles], want[0][~tiles])
        streams = parted.any(0)
        assert torch.equal(crc[:, ~streams], want[1][:, ~streams])
    else:
        assert torch.equal(words, want[0]) and torch.equal(crc, want[1])
    scale = energies.amax(-1).double().sum(1)
    for row, tol in ((1, _bound(want[2][1].double(), scale)), (2, _bound(want[2][2].double(), scale)),
                     (0, 2 * (tk.F32_SPLIT_RTOL + tk.F32_SPLIT_ATOL) * want[2][0].double().abs())):
        assert bool(((qual[row].double() - want[2][row].double()).abs() <= tol).all()), row
    return int(parted.sum())


def _frame_case(name: str, b: int, off: int):
    """(config, anet's config, [T, B] frames, the rows the walk reads,
    preamble offset, n_symbols) of a case: whole frames, the data section
    read in place past the preamble."""
    cfg, jcfg = _configs(name)
    rng = np.random.default_rng(b + off + len(name))
    pre = cfg.preamble_samples
    s = data_symbols_for_payload(cfg, PAY)
    x = _frames_tm(cfg, rng, b, pre)
    assert x.shape[0] == pre + s * cfg.samples_per_symbol
    rows = walk_rows(_flat(x, off), off, b, pre, s, cfg.samples_per_symbol)
    return cfg, jcfg, x, rows, pre, s


@pytest.mark.parametrize("b,off", [(7, 1), (129, 0)])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_emulated_frame_matches_decide_frame_tm_ref(name, b, off):
    """The walk's read and split arithmetic on float32 frames (B = 7 by
    4-byte copies, B = 129 by 16-byte copies) against decide_frame_tm_ref:
    the rows read equal to the data section, and words, CRC counts and
    quality sums as assert_frame_outputs holds them (no tone parts at this
    noise)."""
    cfg, _, x, rows, pre, s = _frame_case(name, b, off)
    sps = cfg.samples_per_symbol
    np.testing.assert_array_equal(rows, x[pre:].reshape(s, sps, b).transpose(2, 0, 1))
    e = emulated_energies(cfg, rows)
    want = tk.decide_frame_tm_ref(cfg, torch.from_numpy(x), PAY, preamble_offset=pre)
    assert want[3] == s
    energies = _energies(cfg, torch.from_numpy(x), pre, s)
    assert assert_frame_outputs(emulated_frame(cfg, e, PAY), want[:3], energies) == 0


@pytest.mark.parametrize("name", ["mfsk16-fast", "fsk2-robust", "mfsk16-ultra"])
def test_emulated_frame_matches_pallas(name):
    """The same emulation against anet's Pallas decide_frame_tm (interpret
    mode, float32 compute, the data section read in place at
    preamble_offset) on 7 streams: words, CRC counts and quality sums as
    assert_frame_outputs holds them."""
    cfg, jcfg, x, rows, pre, s = _frame_case(name, 7, 1)
    jw, jc, jq, js = jk.decide_frame_tm(jcfg, jnp.asarray(x), PAY, compute_dtype=jnp.float32, interpret=True,
                                        preamble_offset=pre)
    assert js == s
    want = tuple(torch.from_numpy(np.array(v)) for v in (jw, jc, jq))
    energies = _energies(cfg, torch.from_numpy(x), pre, s)
    assert assert_frame_outputs(emulated_frame(cfg, emulated_energies(cfg, rows), PAY), want, energies) == 0


def assert_tone_decisions(got, energies: torch.Tensor, want) -> int:
    """decide_tones_tm's outputs ``got`` (tone, best, total [S, B]) of the
    split against ``want`` of a plain float32 computation, with the plain
    energies [B, S, M]: tones equal but at near-ties, best and total within
    F32_SPLIT_RTOL of themselves plus F32_SPLIT_ATOL of the symbol's
    largest energy. Returns the count of near-ties."""
    scale = energies.amax(-1).T
    near = near_ties(energies)
    assert bool(((got[0] == want[0]) | near).all())
    for g, w in zip(got[1:], want[1:]):
        assert bool(((g - w).abs() <= _bound(w, scale)).all())
    return int(near.sum())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_emulated_tones_match_decide_tones_tm_ref(name):
    """decide_tones_tm's float32 route: the same walk from row 0, every
    whole symbol of an oversized window (a frame's data section, 8 symbols
    of noise and a trailing partial symbol, dropped), B = 129 by 16-byte
    copies, against decide_tones_tm_ref."""
    cfg, _ = _configs(name)
    sps = cfg.samples_per_symbol
    rng = np.random.default_rng(len(name))
    x = _frames_tm(cfg, rng, 129, 0, 8 * sps + 17)
    s = x.shape[0] // sps
    rows = walk_rows(_flat(x, 0), 0, 129, 0, s, sps)
    e = emulated_energies(cfg, rows)
    got = (e.argmax(-1).int().T, e.amax(-1).T, e.sum(-1).T)
    xt = torch.from_numpy(x)
    assert assert_tone_decisions(got, _energies(cfg, xt, 0, s), tk.decide_tones_tm_ref(cfg, xt)) == 0


@pytest.mark.parametrize("name", ["mfsk16-fast", "fsk2-robust", "mfsk4-sps32"])
def test_emulated_tones_match_pallas(name):
    """The same emulation against anet's Pallas decide_tones_tm (interpret
    mode, float32 compute) on 7 streams read by 4-byte copies."""
    cfg, jcfg = _configs(name)
    sps = cfg.samples_per_symbol
    x = _frames_tm(cfg, np.random.default_rng(3), 7, 0, 8 * sps + 5)
    s = x.shape[0] // sps
    rows = walk_rows(_flat(x, 1), 1, 7, 0, s, sps)
    e = emulated_energies(cfg, rows)
    got = (e.argmax(-1).int().T, e.amax(-1).T, e.sum(-1).T)
    want = tuple(torch.from_numpy(np.array(v)) for v in
                 jk.decide_tones_tm(jcfg, jnp.asarray(x), compute_dtype=jnp.float32, interpret=True))
    assert assert_tone_decisions(got, _energies(cfg, torch.from_numpy(x), 0, s), want) == 0
