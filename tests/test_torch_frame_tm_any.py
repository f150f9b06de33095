"""The time-major pair (decide_tones_tm, decide_frame_tm) at every geometry
off decide_frame_tm.cu's compile-time walk (csrc/frame_tm_any.cu: any
samples_per_symbol, any tone count, on the tensor cores). The kernel runs
only on the card, so these tests hold on the CPU:

- its basis operand, kernels._filterbank_any_basis for the samples' dtype:
  words in (group, k-step, n-tile, lane) order, k-steps of 16 samples (32
  for int8, its x127 integers a byte each), zero rows past sps, entries
  those of _plain_basis (float32: three bf16 terms summing to them);
- a numpy transliteration of the kernel's walk: the launch's pieces (up to
  8 whole symbols a stage, or slabs of a long symbol), ring and tile
  shares, fetch's rows staged with the swizzle into ring stages whose
  other bytes hold stale garbage, the lanes' A registers as
  ldmatrix.trans (and int8's __byte_perm) or a_split read them, the samples
  past sps zeroed in registers, the B words read at the kernel's index,
  the groups' fold, and both epilogues (tones; Gray-decoded words, CRC
  popcounts against _frame_crc_masks, quality sums), held against
  decide_tones_tm_ref and decide_frame_tm_ref;
- the plain versions against the JAX package's Pallas kernels (interpret
  mode) at custom geometries.

The card's own comparison: tests/test_torch_kernels_cuda.py -k tm_any.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anet.kernels as jk
from anet.dsp.params import ModemConfig as JModemConfig

from anet_torch import kernels as tk
from anet_torch.dsp.frame import data_symbols_for_payload
from anet_torch.dsp.params import ModemConfig
from anet_torch.dsp.pipeline import transmit

CPU = torch.device("cpu")
GROUP, NB, WARPS = 32, 64, 4  # csrc/frame_tm_any.cu
ESIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}


def _config(sps: int, m: int, cls=ModemConfig):
    """``m`` tones of ``sps`` samples a symbol at 48 kHz, from half the
    symbol rate."""
    baud = 48_000 // sps
    return cls(sample_rate_hz=48_000, symbol_rate_hz=baud, num_tones=m, base_freq_hz=baud / 2)


def launch_geometry(dtype: torch.dtype, sps: int, m: int) -> dict:
    """frame_tm_any.cu's launch(): the staged rows, slabs, ring and basis."""
    esize = ESIZE[dtype]
    ch = NB * esize // 16
    pitch, krows = 16 * (ch + 1), (32 if esize == 1 else 16)
    stages, target = (3, 13056) if esize == 4 else (4, 10240) if esize == 1 else (4, 13824)
    gm = min(m, GROUP)
    ng, nt, ks = m // gm, tk._demod_mma_tiles(gm), -(-sps // krows)
    ksl = min(max(1, target // (krows * pitch)), ks)
    nsl = -(-ks // ksl)
    ksl = -(-ks // nsl)
    if nsl == 1:  # whole symbols a stage, one after another
        slot = sps
        extra = krows * ks - slot
        spp = max(1, min(8, (target // pitch - extra) // slot))
        stage = (spp * slot + extra) * pitch
    else:
        slot, spp, stage = 0, 1, krows * ksl * pitch
    basis = ng * ks * nt * 32 * (24 if esize == 4 else 8)
    return dict(esize=esize, ch=ch, e=16 // esize, pitch=pitch, krows=krows, stages=stages, gm=gm, ng=ng, nt=nt,
                ks=ks, ksl=ksl, nsl=nsl, ppi=ng * nsl, spp=spp, slot=slot, stage=stage,
                basis_smem=basis if basis <= 49152 else 0, long=nsl > 1 and esize != 1)


def unpack_any_basis(cfg, dtype: torch.dtype, basis: torch.Tensor) -> np.ndarray:
    """kernels._filterbank_any_basis unpacked as the kernels read it: the
    [groups, E KS, 8 nt] product columns (E = 16 samples a k-step, 32 for
    int8), float64; float32 the sum of its three bf16 terms."""
    m, sps = cfg.num_tones, cfg.samples_per_symbol
    gm = min(m, GROUP)
    ng, nt = m // gm, tk._demod_mma_tiles(gm)
    e = 32 if dtype == torch.int8 else 16
    ks = -(-sps // e)
    words = basis.numpy().view(np.uint32)
    n0 = ng * ks * nt * 64
    assert words.size == n0 * (3 if dtype == torch.float32 else 1)
    terms = [words[:n0].reshape(ng, ks, nt, 32, 2)]
    if dtype == torch.float32:
        b12 = words[n0:].reshape(ng, ks, nt, 32, 2, 2)  # [..., lane, term, register]
        terms += [b12[..., 0, :], b12[..., 1, :]]
    out = np.zeros((ng, e * ks, 8 * nt))
    for w in terms:
        if dtype == torch.int8:  # 4 bytes a word: rows 32 s + 16 r + 4 i + byte
            v = w.astype("<u4").view(np.int8).reshape(ng, ks, nt, 8, 4, 2, 4).astype(np.float64)  # [.., g, i, r, byte]
            out += v.transpose(0, 1, 5, 4, 6, 2, 3).reshape(ng, e * ks, 8 * nt)
        else:  # 2 bf16 a word: rows 16 s + 8 r + 2 i + half
            bits = np.stack([w & 0xFFFF, w >> 16], -1).astype(np.uint32) << 16
            v = bits.view(np.float32).astype(np.float64).reshape(ng, ks, nt, 8, 4, 2, 2)
            out += v.transpose(0, 1, 5, 4, 6, 2, 3).reshape(ng, e * ks, 8 * nt)
    return out


# --- the basis ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("sps,m", [(15, 4), (24, 8), (40, 16), (96, 32), (1920, 16), (160, 64)])
def test_tm_any_basis_layout(sps, m, dtype):
    """The runtime-geometry walk's basis, the one _tm_operands gives
    off the walk: per group of 32 tones the interleaved columns of
    _plain_basis's entries for the samples' dtype, zero rows past sps and
    zero columns past the group's tones, in k-steps of 16 samples (32 for
    int8), float32 as three bf16 terms summing to the entries exactly."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}[dtype]
    cfg = _config(sps, m)
    kind = "decide_tones_tm" if m > 16 or dt != torch.int8 and sps != 40 else "decide_frame_tm"
    entry, route, basis = tk._tm_operands(kind, cfg, dt, CPU)
    assert (entry, route) == (f"{kind}_any", "tm_any_split" if dt == torch.float32 else "tm_any")
    assert basis is tk._filterbank_any_basis(cfg, dt, CPU)
    cols = unpack_any_basis(cfg, dt, basis)
    g = launch_geometry(dt, sps, m)
    assert cols.shape == (g["ng"], g["krows"] * g["ks"], 8 * g["nt"])
    plain = tk._plain_basis(cfg, dt, CPU).double().numpy()
    gm = g["gm"]
    for grp in range(g["ng"]):
        np.testing.assert_array_equal(cols[grp, :sps, 0 : 2 * gm : 2], plain[:, grp * gm : (grp + 1) * gm])
        np.testing.assert_array_equal(cols[grp, :sps, 1 : 2 * gm : 2], plain[:, m + grp * gm : m + (grp + 1) * gm])
    assert not cols[:, sps:].any() and not cols[:, :, 2 * gm :].any()


# --- the walk, transliterated ----------------------------------------------------


def _chunk_at(g: dict, t: int, q: int) -> int:
    return t * g["pitch"] + 16 * (q ^ (((t >> 3) & 1) << 1))


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).view(torch.int16).numpy().astype(np.uint16)


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _split3(x: np.ndarray) -> list[np.ndarray]:
    """demod_core.cuh's bf16_pair three times: float32 samples as three bf16
    terms (float64 values) whose sum is each sample exactly."""
    rest, terms = x.astype(np.float32), []
    for _ in range(3):
        t = _bf16_value(_bf16_bits(rest))
        terms.append(t)
        rest = (rest.astype(np.float64) - t).astype(np.float32)
    return terms


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for n in range(4):
        b = (both >> np.uint64(8 * ((sel >> (4 * n)) & 7))) & np.uint64(0xFF)
        out |= (b.astype(np.uint32) << np.uint32(8 * n))
    return out


def _keep(left: np.ndarray, w: int) -> np.ndarray:
    """frame_tm_any.cu's keep_mask<w>: the kept bits of a register of 4 / w
    samples whose first lies ``left`` samples before the symbol's end."""
    n = 4 // w
    part = (np.uint64(1) << (np.uint64(8 * w) * np.clip(left, 0, n).astype(np.uint64))) - np.uint64(1)
    return np.where(left >= n, 0xFFFFFFFF, np.where(left <= 0, 0, part)).astype(np.uint32)


def _a_tiles(g: dict, dtype, stage: np.ndarray, kk: int, left: int, warp: int) -> list[np.ndarray]:
    """The warp's A operand [16 M rows, K] of k-step kk of a symbol's staged
    slab, as the lanes' registers hold it (float64; float32: its three bf16
    terms)."""
    lane = np.arange(32)
    gq, i = lane >> 2, lane & 3
    if dtype == torch.float32:
        terms = [np.zeros((16, 16)) for _ in range(3)]
        for hk in range(2):
            t = 16 * kk + 8 * hk + 2 * i
            l = left - 8 * hk - 2 * i
            for h in range(2):
                col = 16 * warp + 8 * h + gq
                at = 4 * (col & 3)
                lo = np.array([stage[_chunk_at(g, tt, c >> 2) + a : _chunk_at(g, tt, c >> 2) + a + 4].view(np.float32)[0]
                               for tt, c, a in zip(t, col, at)])
                hi = np.array([stage[_chunk_at(g, tt + 1, c >> 2) + a : _chunk_at(g, tt + 1, c >> 2) + a + 4]
                               .view(np.float32)[0] for tt, c, a in zip(t, col, at)])
                lo = np.where(l >= 1, lo, np.float32(0))
                hi = np.where(l >= 2, hi, np.float32(0))
                for term, (tl, th) in enumerate(zip(_split3(lo), _split3(hi))):
                    terms[term][8 * h + gq, 8 * hk + 2 * i] = tl
                    terms[term][8 * h + gq, 8 * hk + 2 * i + 1] = th
        return terms
    j, rr = lane >> 3, lane & 7  # the x4 load's matrix and row this lane addresses

    def row16(t, q):  # the 8 16-bit elements of the staged chunk q of row t
        at = _chunk_at(g, t, q)
        return stage[at : at + 16].view(np.uint16)

    if dtype == torch.bfloat16:
        addr = [(16 * kk + 8 * (jj >> 1) + r, 2 * warp + (jj & 1)) for jj, r in zip(j, rr)]
    else:
        addr = [(32 * kk + 16 * (jj >> 1) + 2 * (jj & 1) + 4 * (r >> 1) + (r & 1), warp) for jj, r in zip(j, rr)]
    mats = np.array([row16(t, q) for t, q in addr]).reshape(4, 8, 8)  # [matrix, row, element]
    # .trans: register j of lane (gq, i) is (M_j[2i][gq], M_j[2i + 1][gq]), the first in the low half
    regs = (mats[:, 2 * i, gq].astype(np.uint32) | (mats[:, 2 * i + 1, gq].astype(np.uint32) << 16))  # [4, 32]
    a = np.zeros((16, 32 if dtype == torch.int8 else 16))
    if dtype == torch.bfloat16:
        m0, m1 = _keep(left - 2 * i, 2), _keep(left - 8 - 2 * i, 2)
        regs = regs & np.stack([m0, m0, m1, m1])
        for r, (row_off, k_off) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            lo, hi = _bf16_value(regs[r] & 0xFFFF), _bf16_value(regs[r] >> 16)
            a[row_off + gq, k_off + 2 * i] = lo
            a[row_off + gq, k_off + 2 * i + 1] = hi
        return [a]
    a_regs = [_byte_perm(regs[0], regs[1], 0x6420), _byte_perm(regs[0], regs[1], 0x7531),
              _byte_perm(regs[2], regs[3], 0x6420), _byte_perm(regs[2], regs[3], 0x7531)]
    m0, m1 = _keep(left - 4 * i, 1), _keep(left - 16 - 4 * i, 1)
    for r, (row_off, k_off, mask) in enumerate(((0, 0, m0), (8, 0, m0), (0, 16, m1), (8, 16, m1))):
        v = (a_regs[r] & mask).astype("<u4").view(np.int8).reshape(32, 4).astype(np.float64)
        for byte in range(4):
            a[row_off + gq, k_off + 4 * i + byte] = v[:, byte]
    return [a]


def _b_tiles(g: dict, dtype, words: np.ndarray, grp: int, ks: int) -> list[np.ndarray]:
    """The B operand [K, 8 nt] of (group, k-step) read as the lanes read it:
    uint2 b0 at ((grp ks_total + ks) nt + t) 32 + lane, and (float32) the
    uint4 of b1, b2 after all of b0."""
    lane = np.arange(32)
    gq, i = lane >> 2, lane & 3
    nt = g["nt"]
    n0 = g["ng"] * g["ks"] * nt * 32
    k = 32 if dtype == torch.int8 else 16
    out = [np.zeros((k, 8 * nt)) for _ in range(3 if dtype == torch.float32 else 1)]
    for t in range(nt):
        bi = ((grp * g["ks"] + ks) * nt + t) * 32 + lane
        regs = [[words[2 * bi], words[2 * bi + 1]]]
        if dtype == torch.float32:
            regs += [[words[2 * n0 + 4 * bi], words[2 * n0 + 4 * bi + 1]],
                     [words[2 * n0 + 4 * bi + 2], words[2 * n0 + 4 * bi + 3]]]
        for term, (r0, r1) in enumerate(regs):
            for r, w in enumerate((r0, r1)):
                if dtype == torch.int8:
                    v = w.astype("<u4").view(np.int8).reshape(32, 4).astype(np.float64)
                    for byte in range(4):
                        out[term][16 * r + 4 * i + byte, 8 * t + gq] = v[:, byte]
                else:
                    out[term][8 * r + 2 * i, 8 * t + gq] = _bf16_value(w & 0xFFFF)
                    out[term][8 * r + 2 * i + 1, 8 * t + gq] = _bf16_value(w >> 16)
    return out


def emulate_walk(cfg, x: torch.Tensor, row0: int, n_symbols: int, tones: bool, gy: int, payload_len: int = 0):
    """frame_tm_any.cu on time-major ``x`` [T, B]: (tone, best, total) [S, B]
    (``tones``) or (words, crc, qual) of decide_frame_tm, every block of 64
    streams walking its share (of ``gy``) of the 8-symbol tiles through
    the ring of its stages, each stage filled with stale garbage first."""
    dtype = x.dtype
    sps, m, bps = cfg.samples_per_symbol, cfg.num_tones, cfg.bits_per_symbol
    g = launch_geometry(dtype, sps, m)
    words = tk._filterbank_any_basis(cfg, dtype, CPU).numpy().view(np.uint32)
    t_rows, b_all = x.shape
    raw = (x.view(torch.int16) if g["esize"] == 2 else x.view(torch.int32) if g["esize"] == 4 else x).numpy()
    raw = np.ascontiguousarray(raw).view(np.uint8).reshape(t_rows, b_all * g["esize"])
    n_tiles = -(-n_symbols // 8)
    tone_o = np.zeros((n_symbols, b_all), np.int64)
    best_o = np.zeros((n_symbols, b_all), np.float32)
    total_o = np.zeros((n_symbols, b_all), np.float32)
    word_o = np.zeros((n_tiles, b_all), np.uint32)
    crc_o = np.zeros((64, b_all))
    qual_o = np.zeros((8, b_all))
    masks = tk._frame_crc_masks(payload_len, n_tiles, bps, CPU).numpy().view(np.uint32) if not tones else None
    rng = np.random.default_rng(0)
    for bx in range(-(-b_all // NB)):
        b0 = NB * bx
        for by in range(gy):
            t0, t1 = by * n_tiles // gy, (by + 1) * n_tiles // gy
            s_begin, s_end = 8 * t0, min(8 * t1, n_symbols)
            ring = [rng.integers(0, 256, g["stage"], dtype=np.uint8) for _ in range(g["stages"])]
            running = {}
            n_pieces = -(-(s_end - s_begin) // g["spp"]) if g["nsl"] == 1 else (s_end - s_begin) * g["ppi"]
            for q in range(n_pieces):
                stage = ring[q % g["stages"]]
                if g["nsl"] == 1:  # piece(): up to spp whole symbols, every group
                    s0, n_syms, sl, grps = s_begin + q * g["spp"], 0, 0, range(g["ng"])
                    n_syms = min(g["spp"], s_end - s0)
                else:  # one slab of one symbol for one group
                    rem = q % g["ppi"]
                    s0, n_syms, sl, grps = s_begin + q // g["ppi"], 1, rem % g["nsl"], [rem // g["nsl"]]
                lo = sl * g["ksl"] * g["krows"]
                n_rows = min(g["ksl"] * g["krows"], sps - lo)
                for r in range(n_syms * n_rows):  # fetch: the piece's rows of the block's 64 streams
                    src = raw[row0 + s0 * sps + lo + r]
                    j_sym, t = divmod(r, n_rows)  # symbol j_sym's rows from staged row j_sym slot, swizzled from there
                    base = j_sym * g["slot"] * g["pitch"]
                    for qc in range(g["ch"]):
                        b = b0 + qc * g["e"]
                        chunk = np.zeros(16, np.uint8)
                        live = max(0, min(g["e"], b_all - b)) * g["esize"]
                        chunk[:live] = src[b * g["esize"] : b * g["esize"] + live]
                        stage[base + _chunk_at(g, t, qc) : base + _chunk_at(g, t, qc) + 16] = chunk
                assert n_syms == 1 or (n_syms - 1) * g["slot"] + g["krows"] * g["ks"] <= g["stage"] // g["pitch"]
                nk = min(g["ksl"], g["ks"] - sl * g["ksl"])
                for j_sym in range(n_syms):
                    s, sym = s0 + j_sym, stage[j_sym * g["slot"] * g["pitch"] :]  # the symbol's rows
                    for grp in grps:
                        for warp in range(WARPS):
                            key = (warp, grp)
                            if sl == 0:
                                running[key] = np.zeros((16, 8 * g["nt"]))
                            for kk in range(nk):
                                ks = sl * g["ksl"] + kk
                                left = sps - ks * g["krows"]
                                a = _a_tiles(g, dtype, sym, kk, left, warp)
                                bt = _b_tiles(g, dtype, words, grp, ks)
                                if dtype == torch.float32:  # the six products a_i b_j, i + j <= 2
                                    running[key] += sum(a[p] @ bt[r] for p in range(3) for r in range(3) if p + r <= 2)
                                else:
                                    running[key] += a[0] @ bt[0]
                        if sl != g["nsl"] - 1:
                            continue
                        for warp in range(WARPS):  # the group's decisions, folded into the symbol's
                            iq = running[(warp, grp)].astype(np.float32)
                            e = (iq[:, 0::2] * iq[:, 0::2]).astype(np.float32) + (iq[:, 1::2] * iq[:, 1::2]).astype(np.float32)
                            bt_, bq, tot = e.argmax(1), e.max(1), e.astype(np.float64).sum(1)
                            prev = running.get(("fold", warp))
                            if grp == 0:
                                running[("fold", warp)] = [bt_, bq, tot]
                            else:
                                better = bq > prev[1]
                                prev[0] = np.where(better, grp * GROUP + bt_, prev[0])
                                prev[1] = np.where(better, bq, prev[1])
                                prev[2] = prev[2] + tot
                        if grp != g["ng"] - 1:
                            continue
                        for warp in range(WARPS):
                            ft, fb, fs = running[("fold", warp)]
                            rows = np.arange(16)
                            if dtype == torch.int8:  # M row gq is stream 2 gq, gq + 8 is 2 gq + 1
                                streams = b0 + 16 * warp + np.where(rows < 8, 2 * rows, 2 * (rows - 8) + 1)
                            else:
                                streams = b0 + 16 * warp + rows
                            ok = streams < b_all
                            st, ft, fb, fs = streams[ok], ft[ok], fb[ok], fs[ok]
                            if tones:
                                tone_o[s, st], best_o[s, st], total_o[s, st] = ft, fb, fs
                                continue
                            data = ft.copy()
                            shift = 1
                            while shift < bps:
                                data ^= data >> shift
                                shift <<= 1
                            word_o[s // 8, st] |= (data.astype(np.uint32) << np.uint32((7 - s % 8) * bps))
                            qual_o[0, st] += fb / np.maximum(fs, 1e-20)
                            qual_o[1, st] += fb
                            qual_o[2, st] += fs
    if tones:
        return tone_o, best_o, total_o
    for tile in range(n_tiles):  # the CRC popcounts of each tile's words
        for c in range(64):
            crc_o[c] += np.array([bin(int(w) & int(masks[tile, c])).count("1") for w in word_o[tile]])
    return word_o.view(np.int32), crc_o, qual_o


def _noisy_tm(cfg, rng, b: int, dtype, offset: int, n_sym: int) -> torch.Tensor:
    """Time-major [offset + n_sym sps + sps // 2, B] of ``dtype``: a frame's
    first data symbols (repeated) after ``offset`` rows of its preamble,
    noise 0.3, a trailing partial symbol."""
    sps, pre = cfg.samples_per_symbol, cfg.preamble_samples
    w = transmit(cfg, rng.integers(0, 256, (b, 8), dtype=np.uint8), device="cpu").numpy()
    data = np.tile(w[:, pre:], (1, -(-n_sym * sps // (w.shape[1] - pre))))[:, : n_sym * sps]
    x = np.concatenate([w[:, pre - offset : pre], data, np.zeros((b, sps // 2), np.float32)], -1)
    x = np.ascontiguousarray((x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)).T)
    t = torch.from_numpy(x)
    if dtype == torch.int8:
        return torch.round(t * (127.0 / t.abs().max())).to(torch.int8)
    return t.to(dtype)


TONES_CASES = {  # (sps, tones, dtype, B, symbols, tile shares): slabs, groups, masks, ragged B
    "sps15-m4-bf16": (15, 4, torch.bfloat16, 5, 9, 2),  # 6 symbols a stage
    "sps40-m16-f32": (40, 16, torch.float32, 70, 10, 2),
    "sps96-m32-bf16": (96, 32, torch.bfloat16, 3, 3, 1),  # a symbol a stage, 8 n-tiles
    "sps96-m32-f32": (96, 32, torch.float32, 3, 2, 1),  # two slabs, the six products folded
    "sps128-m64-bf16": (128, 64, torch.bfloat16, 2, 2, 1),  # two groups of two slabs each
    "sps24-m8-f32": (24, 8, torch.float32, 66, 17, 3),
}


@pytest.mark.parametrize("case", list(TONES_CASES))
def test_walk_matches_decide_tones_tm_ref(case):
    """The transliterated walk's tones equal decide_tones_tm_ref's, best and
    total within rtol 1e-5 (float64 sums of the same bf16 terms: the
    kernel's are float32 sums in another order)."""
    sps, m, dt, b, n_sym, gy = TONES_CASES[case]
    cfg = _config(sps, m)
    x = _noisy_tm(cfg, np.random.default_rng(sps + m + b), b, dt, 0, n_sym)
    tone, best, total = emulate_walk(cfg, x, 0, x.shape[0] // sps, True, gy)
    rt, rb, rtot = tk.decide_tones_tm_ref(cfg, x)
    np.testing.assert_array_equal(tone, rt.numpy())
    np.testing.assert_allclose(best, rb.numpy(), rtol=1e-5)
    np.testing.assert_allclose(total, rtot.numpy(), rtol=1e-5)


FRAME_CASES = {  # (sps, tones, dtype, B, tile shares)
    "sps40-m16-bf16": (40, 16, torch.bfloat16, 9, 2),
    "sps40-m16-int8": (40, 16, torch.int8, 70, 3),  # k-steps of 32, the last masked past 40; 2 symbols a stage
    "sps40-m16-f32": (40, 16, torch.float32, 5, 2),
    "sps24-m2-int8": (24, 2, torch.int8, 3, 2),  # one k-step, masked past 24; 1 bit a symbol; 5 a stage
    "sps15-m4-bf16": (15, 4, torch.bfloat16, 4, 1),
}


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_walk_matches_decide_frame_tm_ref(case):
    """The transliterated walk's frame epilogue on whole frames (the data
    section read from the preamble's end): words and CRC popcounts equal
    to decide_frame_tm_ref's, the quality sums within rtol 1e-5."""
    sps, m, dt, b, gy = FRAME_CASES[case]
    cfg = _config(sps, m)
    pay = 6
    rng = np.random.default_rng(sps + m + b)
    payload = rng.integers(0, 256, (b, pay), dtype=np.uint8)
    w = transmit(cfg, payload, device="cpu")
    x = (w + 0.3 * torch.from_numpy(rng.standard_normal(w.shape).astype(np.float32))).T.contiguous()
    x = torch.round(x * (127.0 / x.abs().max())).to(torch.int8) if dt == torch.int8 else x.to(dt)
    pre = cfg.preamble_samples
    rw, rc, rq, s = tk.decide_frame_tm_ref(cfg, x, pay, preamble_offset=pre)
    words, crc, qual = emulate_walk(cfg, x, pre, s, False, gy, pay)
    np.testing.assert_array_equal(words, rw.numpy())
    np.testing.assert_array_equal(crc, rc.numpy())
    np.testing.assert_allclose(qual, rq.numpy(), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["bf16", "f32", "int8"])
def test_walk_at_sps_1920(dtype):
    """sps 1,920 (120 k-steps, 60 for int8: 12 to 40 slabs a symbol, the
    float32 sums folded past one): bf16 and float32 decisions on 2 streams
    of 2 symbols equal the plain version's (tones equal, best and total
    within rtol 1e-5); int8 frames of 2 bytes, words and CRC counts equal,
    quality sums within rtol 1e-5."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}[dtype]
    cfg = _config(1920, 16)
    g = launch_geometry(dt, 1920, 16)
    assert g["nsl"] >= 12 and g["long"] == (dt != torch.int8)
    rng = np.random.default_rng(1920)
    if dt == torch.int8:
        pay, pre = 2, cfg.preamble_samples
        w = transmit(cfg, rng.integers(0, 256, (2, pay), dtype=np.uint8), device="cpu")
        x = (w + 0.3 * torch.from_numpy(rng.standard_normal(w.shape).astype(np.float32))).T.contiguous()
        x = torch.round(x * (127.0 / x.abs().max())).to(torch.int8)
        rw, rc, rq, s = tk.decide_frame_tm_ref(cfg, x, pay, preamble_offset=pre)
        words, crc, qual = emulate_walk(cfg, x, pre, s, False, 1, pay)
        np.testing.assert_array_equal(words, rw.numpy())
        np.testing.assert_array_equal(crc, rc.numpy())
        np.testing.assert_allclose(qual, rq.numpy(), rtol=1e-5)
        return
    x = _noisy_tm(cfg, rng, 2, dt, 0, 2)
    tone, best, total = emulate_walk(cfg, x, 0, 2, True, 1)
    rt, rb, rtot = tk.decide_tones_tm_ref(cfg, x)
    np.testing.assert_array_equal(tone, rt.numpy())
    np.testing.assert_allclose(best, rb.numpy(), rtol=1e-5)
    np.testing.assert_allclose(total, rtot.numpy(), rtol=1e-5)


# --- the plain versions against the Pallas kernels --------------------------------


@pytest.mark.parametrize("geometry", [(40, 16), (96, 32), (15, 4)])
def test_plain_versions_match_pallas_at_custom_geometries(geometry):
    """decide_tones_tm_ref and decide_frame_tm_ref against anet's Pallas
    decide_tones_tm and decide_frame_tm (interpret mode, float32) at
    custom geometries off the compile-time walk (sps 40 with 16 tones,
    aligned-custom's modem; sps 96 with 32; sps 15 with 4), B = 4: tones,
    words and CRC counts equal, best, total and quality sums within rtol
    1e-5 (float32 sums in another order). decide_frame_tm takes at most 16
    tones, so sps 96 holds the tones alone."""
    sps, m = geometry
    cfg, jcfg = _config(sps, m), _config(sps, m, JModemConfig)
    rng = np.random.default_rng(sps * m)
    pay, b = 6, 4
    w = transmit(cfg, rng.integers(0, 256, (b, pay), dtype=np.uint8), device="cpu")
    x = (w + 0.3 * torch.from_numpy(rng.standard_normal(w.shape).astype(np.float32))).T.contiguous()
    pre = cfg.preamble_samples
    data = x[pre:].contiguous()
    got = tk.decide_tones_tm_ref(cfg, data)
    want = jk.decide_tones_tm(jcfg, jnp.asarray(data.numpy()), compute_dtype=jnp.float32, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, c in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5)
    if m > 16:
        return
    words, crc, qual, s = tk.decide_frame_tm_ref(cfg, x, pay, preamble_offset=pre)
    jw, jc, jq, js = jk.decide_frame_tm(jcfg, jnp.asarray(x.numpy()), pay, compute_dtype=jnp.float32,
                                        interpret=True, preamble_offset=pre)
    assert s == js == data_symbols_for_payload(cfg, pay)
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(crc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(qual.numpy()[:3], np.asarray(jq)[:3], rtol=1e-5)
