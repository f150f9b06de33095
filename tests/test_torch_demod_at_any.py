"""csrc/demod_at_any.cu on the CPU: the align+demod kernels (demod_at_fused,
demod_at_energies_fused, demod_probe_fused's demod) at the geometries of
the reference's gate (128 % sps == 0) off demod_at.cu's compile-time walk:
sps 4, 8 and 16, and 32 or 64 tones at sps 64 and 128.

- Its basis, kernels._demod_at_any_basis, read back at the kernel's word
  index: the reference's block-diagonal layout cut to a k-step (r = E / sps
  symbols an A row, slot u's columns on rows u sps .. (u + 1) sps - 1), or
  32 tones a group for a row of one symbol; float32 as three bf16 terms
  summing to the entries exactly.
- Every (k-steps, n-tiles) instantiation's shared memory within a block.
- A numpy transliteration of the walk (its launch geometry, the items in
  the order the warps step through them, the span's 16-byte copies into
  staged rows with their pad, the zero fill past the row and before its
  start into stages of stale bytes, the funnel-shift A registers or the
  float32 samples split into three bf16 terms, the B words at the
  kernel's index, batches of two m16 tiles, the epilogue's scratch lane
  by lane: passes, lanes a symbol, a pair of warps' merge, stores on
  consecutive addresses; rows of odd length) against the plain versions.
- The plain versions against the reference's Pallas kernels in interpret
  mode at sps 8, 16, 64 / 32 tones and 128 / 32 tones, and at sps 4, where
  the reference's Pallas kernel raises, against its jnp filterbank.
- The locked stream's card branch at sps 16 on an int8 carry: the merged
  probe + demod route, with the reference's verdicts and payloads.
Card: tests/test_torch_kernels_cuda.py -k demod_at_any.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_frame_tm_any import _b_tiles, _bf16_bits, _bf16_value, _split3

import anet.kernels as jk
from anet import stream as jstream
from anet.dsp import demod as jdemod
from anet.dsp import family as jfamily
from anet.dsp.params import ModemConfig as JModemConfig

import anet_torch.stream as tstream
from anet_torch import kernels as tk
from anet_torch.dsp.params import ModemConfig

CPU = torch.device("cpu")
DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}
ESIZE = {torch.bfloat16: 2, torch.int8: 1, torch.float32: 4}
WARPS, STAGE_TARGET, GROUP = 4, 2048, 32  # csrc/demod_at_any.cu
RTOL = 1e-5  # bf16 products exact, float32 sums in another order


def _config(sps: int, m: int, cls=ModemConfig):
    """``m`` tones a symbol of ``sps`` samples at 48 kHz from half the
    symbol rate (the top tone below Nyquist: m <= sps / 2)."""
    rate = 48_000 // sps
    return cls(sample_rate_hz=48_000, symbol_rate_hz=rate, num_tones=m, base_freq_hz=rate / 2)


def walk_constants(dtype: torch.dtype, ks: int, nt: int) -> dict:
    """Walk<T, KS, NT>'s constants in demod_at_any.cu: the A row's bytes,
    the staged row (16 bytes of pad), chunks and words a row, m16 tiles an
    item, the ring stage, the warps an item (p, a team: 2 for float32 rows
    of one symbol at 8 n-tiles) and n-tiles a warp (ntw), the m16 tiles a B
    fragment meets (u), B in registers (breg), the epilogue's n-tiles a
    pass (nte) and a warp's passes, floats a scratch row (pp), and a team's
    shared memory."""
    e = 32 if dtype == torch.int8 else 16
    f32 = dtype == torch.float32
    rb = ks * e * ESIZE[dtype]
    mt = (2 if not f32 and rb <= 128 else 1) if 16 * rb >= STAGE_TARGET else STAGE_TARGET // (16 * rb)
    p = 2 if f32 and nt == 8 and ks > 1 else 1  # warps an item, nt / p n-tiles each
    ntw = nt // p
    nte = ntw if ntw < 4 or ks == 1 else 4
    c = {
        "rb": rb, "row": rb + 16, "cps": rb // 16, "wps": rb // 4, "mt": mt, "rows": 16 * mt,
        "chunks": 16 * mt * (rb // 16) + 1, "stage": 16 * mt * (rb + 16) + 16, "ring": 2 if f32 else 3,
        "p": p, "ntw": ntw, "u": 2 if mt >= 2 and not (f32 and nt == 8) else 1,
        "breg": ks * nt <= (2 if f32 else 8), "nte": nte, "passes": ntw // nte,
        "pp": 12 if nte == 1 else 4 * nte + 4,
    }
    scratch = 16 * c["u"] * c["pp"] * 4
    c["team_smem"] = c["ring"] * c["stage"] + p * scratch + (16 * c["u"] * 16 if p > 1 else 0)
    return c


def launch_geometry(dtype: torch.dtype, sps: int, m: int) -> dict:
    """demod_at_any.cu's make_geo: symbols an A row r, its k-steps ks,
    tones a group gm, groups ng, n-tiles nt; and walk_constants of (ks,
    nt)."""
    e = 32 if dtype == torch.int8 else 16
    r = e // sps if sps < e else 1
    gm = m if r > 1 or m < GROUP else GROUP
    cols = r * 2 * gm
    nt = 1 if cols <= 8 else 2 if cols <= 16 else 4 if cols <= 32 else 8
    ks = r * sps // e
    return {"e": e, "r": r, "lsamp": r * sps, "ks": ks, "gm": gm, "ng": m // gm, "nt": nt,
            **walk_constants(dtype, ks, nt)}


def basis_columns(g: dict, dtype, basis: torch.Tensor) -> list[np.ndarray]:
    """The basis as the lanes read it: per group the [E ks, 8 nt] columns of
    each term (float64), from the words at the kernel's index."""
    words = basis.numpy().view(np.uint32)
    n_terms = 3 if dtype == torch.float32 else 1
    assert words.size == n_terms * g["ng"] * g["ks"] * g["nt"] * 64
    return [
        [np.concatenate([_b_tiles(g, dtype, words, grp, ks)[t] for ks in range(g["ks"])]) for t in range(n_terms)]
        for grp in range(g["ng"])
    ]


# every geometry of the reference's gate off demod_at.cu's walk, as a
# ModemConfig below Nyquist has them
ANY_GEOMETRIES = [(4, 2), (8, 2), (8, 4), (16, 2), (16, 4), (16, 8), (64, 32), (128, 32), (128, 64)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sps,m", ANY_GEOMETRIES)
def test_demod_at_any_basis_layout(sps, m, dtype):
    """The route off the walk and its basis: slot u of a row of r symbols
    holds the interleaved columns (2c the cos of tone c, 2c + 1 its sin) of
    _plain_basis's entries on rows u sps .. (u + 1) sps - 1 and zeros
    elsewhere; a row of one symbol holds groups of 32 tones; zero columns
    past the slots'. Made once a config, dtype and device; float32 as three
    bf16 terms whose sum is the entries exactly."""
    dt = DTYPES[dtype]
    cfg = _config(sps, m)
    entry, route, basis = tk._demod_at_operands("k", "demod_at", cfg, dt, CPU)
    assert (entry, route) == ("demod_at_any", "at_any")
    assert tk._demod_at_operands("k", "demod_at_energies", cfg, dt, CPU)[:2] == ("demod_at_energies_any", "at_any")
    assert basis is tk._demod_at_any_basis(cfg, dt, CPU) and basis.dtype == torch.int32
    g = launch_geometry(dt, sps, m)
    assert tk._demod_at_any_geometry(cfg, dt) == (g["r"], g["ks"], g["gm"], g["ng"], g["nt"])
    plain = tk._plain_basis(cfg, dt, CPU).double().numpy()
    r, gm = g["r"], g["gm"]
    for grp, terms in enumerate(basis_columns(g, dt, basis)):
        if dt == torch.float32:
            for t in terms:  # each term a bf16 value
                np.testing.assert_array_equal(_bf16_value(_bf16_bits(t.astype(np.float32))), t)
        cols = sum(terms)
        assert cols.shape == (g["e"] * g["ks"], 8 * g["nt"]) and cols.shape[0] == r * sps
        want = np.zeros_like(cols)
        for u in range(r):
            rows = slice(u * sps, (u + 1) * sps)
            want[rows, u * 2 * gm : (u + 1) * 2 * gm : 2] = plain[:, grp * gm : (grp + 1) * gm]
            want[rows, u * 2 * gm + 1 : (u + 1) * 2 * gm : 2] = plain[:, m + grp * gm : m + (grp + 1) * gm]
        np.testing.assert_array_equal(cols, want)


# --- the walk, transliterated ----------------------------------------------------


def _a_operand(g: dict, dtype, stage: np.ndarray, base: int, x0: int, sh: int, ks: int) -> list[np.ndarray]:
    """The warp's A operand [16 rows, K] of k-step ks of the m16 tile whose
    row 0 is staged at ``base``, as the lanes build it (float64; float32:
    its three bf16 terms): word x of a row's span at 4 x of its staged row,
    past the row's 16 bytes of pad for x >= wps."""
    lane = np.arange(32)
    gq, i = lane >> 2, lane & 3

    def at(h, x):  # byte offset of word x of lane row gq + 8 h
        return base + (gq + 8 * h) * g["row"] + 4 * x + np.where(x >= g["wps"], 16, 0)

    def word(h, x):
        o = at(h, x)
        return stage[o[:, None] + np.arange(4)].copy().view("<u4")[:, 0]

    if dtype == torch.float32:
        terms = [np.zeros((16, 16)) for _ in range(3)]
        for hk in range(2):
            x = x0 + 2 * i + 16 * ks + 8 * hk
            for h in range(2):
                lo, hi = word(h, x).view(np.float32), word(h, x + 1).view(np.float32)
                for term, (tl, th) in enumerate(zip(_split3(lo), _split3(hi))):
                    terms[term][8 * h + gq, 8 * hk + 2 * i] = tl
                    terms[term][8 * h + gq, 8 * hk + 2 * i + 1] = th
        return terms
    a = np.zeros((16, g["e"]))
    for hk in range(2):
        x = x0 + i + 8 * ks + 4 * hk
        for h in range(2):
            both = (word(h, x + 1).astype(np.uint64) << np.uint64(32)) | word(h, x).astype(np.uint64)
            reg = ((both >> np.uint64(sh)) & np.uint64(0xFFFFFFFF)).astype("<u4")  # __funnelshift_r
            if dtype == torch.int8:
                v = reg.view(np.int8).reshape(32, 4).astype(np.float64)
                for byte in range(4):
                    a[8 * h + gq, 16 * hk + 4 * i + byte] = v[:, byte]
            else:
                a[8 * h + gq, 8 * hk + 2 * i] = _bf16_value(reg & 0xFFFF)
                a[8 * h + gq, 8 * hk + 2 * i + 1] = _bf16_value(reg >> 16)
    return [a]


def _iq(dtype, a_terms: list, b_terms: list) -> np.ndarray:
    """One k-step's products into float32 sums as the kernel keeps them:
    bf16 and int8 one product (exact, summed in float64 here); float32 the
    six a_i b_j with i + j <= 2, a0 b0 apart from the rest."""
    if dtype != torch.float32:
        return a_terms[0] @ b_terms[0], None
    (a0, a1, a2), (b0, b1, b2) = a_terms, b_terms
    return a0 @ b0, a2 @ b0 + a1 @ b1 + a0 @ b2 + a1 @ b0 + a0 @ b1


def _store(out: dict, key: str, idx: np.ndarray, vals: np.ndarray):
    """Record the stores of one warp instruction; a second store to one
    index fails."""
    for k, v in zip(idx.tolist(), vals.tolist()):
        assert (key, k) not in out, (key, k)
        out[(key, k)] = v


def _items(b: int, tiles: int, warps: int) -> list[tuple[int, int]]:
    """The (stream, tile) items in the order the launch's warps walk them:
    warp w from item w (one division), then on by the step of ``warps``
    items as (streams, tiles) with a carry, no division; every item once."""
    step_b, step_t = divmod(warps, tiles)
    seen = []
    for w in range(warps):
        sb, st = divmod(w, tiles)
        while sb < b:
            seen.append((sb, st))
            st, sb = st + step_t, sb + step_b
            if st >= tiles:
                st, sb = st - tiles, sb + 1
    assert sorted(seen) == [(x, y) for x in range(b) for y in range(tiles)]
    return seen


def _epilogue(g: dict, decide: bool, scratch: np.ndarray, bb: int, sym0: int, tone0: int, out: dict, n_sym: int):
    """One pass of a warp's epilogue in demod_at_any.cu, lane by lane, from
    its scratch [16 u rows, pp] (columns past the pass's 4 nte pairs NaN):
    the energies stored as 16-byte (2 tones: 8-byte) pieces, every store
    instruction on consecutive addresses over consecutive lanes; or the
    decisions, each lane (pair of lanes where the batch holds 16 symbols)
    folding whole symbols' tones in order, returned as [(symbol of the
    batch, best, tone, total)] a 32-lane step for the caller to fold and
    store."""
    lane = np.arange(32)
    r, m = g["r"], g["m"]
    rs = r.bit_length() - 1
    gu = min(g["gm"], 4 * g["nte"])  # tones of a slot in a pass
    gus = gu.bit_length() - 1
    nsym = 16 * g["u"] * r
    if not decide:
        base = bb * n_sym
        if gu >= 4:
            ps = rs + gus - 2  # log2 of the 16-byte pieces a scratch row
            q = np.arange((16 * g["u"]) << ps)
            row, c = q >> ps, 4 * (q & ((1 << ps) - 1))
            sym = sym0 + (row << rs) + (c >> gus)
            dst = (base + sym) * m + tone0 + (c & (gu - 1))
            width = 4
        else:
            q = np.arange(nsym)
            row, c, sym = q >> rs, 2 * (q & (r - 1)), sym0 + q
            dst = (base + sym) * m + tone0
            width = 2
        ok = sym < n_sym
        if g["ng"] == 1 and g["p"] * g["passes"] == 1:
            for w0 in range(0, q.size, 32):  # one instruction: 32 lanes' pieces, consecutive
                assert np.all(np.diff(dst[w0 : w0 + 32]) == width)
        vals = np.stack([scratch[row, c + k] for k in range(width)], -1)
        assert not np.isnan(vals[ok]).any()
        _store(out, "energies", (dst[ok, None] + np.arange(width)).reshape(-1), vals[ok].reshape(-1))
        return []
    lps = 1 if nsym >= 32 else 2
    half = lane & (lps - 1)
    per = gu // lps  # tones a lane folds
    steps = []
    for s0 in range(0, nsym, 32 // lps):
        sg = s0 + lane // lps
        row, slot = sg >> rs, sg & (r - 1)
        vals = scratch[row[:, None], (slot * gu + half * per)[:, None] + np.arange(per)]
        assert not np.isnan(vals).any()
        best, tone, tot = np.full(32, -1, np.float32), np.zeros(32, np.int64), np.zeros(32, np.float32)
        for c in range(per):
            up = vals[:, c] > best
            best, tone = np.where(up, vals[:, c], best), np.where(up, c, tone)
            tot = (tot + vals[:, c]).astype(np.float32)
        tone = tone + half * per
        if lps == 2:  # the pair's halves: shfl_xor 1, the lower tones first
            ob, ot = best[lane ^ 1], tone[lane ^ 1]
            tot = (tot + tot[lane ^ 1]).astype(np.float32)
            win = (ob > best) | ((ob == best) & (ot < tone))
            best, tone = np.where(win, ob, best), np.where(win, ot, tone)
        steps.append((sg, best, tone + tone0, tot))
    return steps


def _store_decisions(out: dict, bb: int, sym0: int, sg, best, tone, tot, n_sym: int):
    """The decisions of a 32-lane step: lanes whose half is 0 store their
    symbol, consecutive lanes on consecutive symbols."""
    lane = np.arange(32)
    lps = 2 if sg[1] == sg[0] else 1
    sym = sym0 + sg
    ok = ((lane & (lps - 1)) == 0) & (sym < n_sym)
    assert np.all(np.diff(sym[(lane & (lps - 1)) == 0]) == 1)
    idx = bb * n_sym + sym
    _store(out, "tone", idx[ok], tone[ok])
    _store(out, "best", idx[ok], best[ok])
    _store(out, "total", idx[ok], tot[ok])


def emulate_walk(cfg, dtype, mem: np.ndarray, off: int, b: int, length: int, start: np.ndarray, n_sym: int,
                 decide: bool, warps: int = 12) -> dict:
    """demod_at_any.cu on a [b, length] buffer at byte ``off`` of the flat
    bytes ``mem``: the (stream, tile) items in the order ``warps`` warps
    take them, each item's span copied as cp.async's source size allows
    into a stage of stale bytes (whole chunks where the span's chunks lie
    within the row), the bytes before the row's start zeroed, every batch
    of u m16 tiles and group through the products (each B fragment applied
    to the batch's tiles) and the epilogue's passes. Returns the stores by
    (output, flat index)."""
    sps, m, pre = cfg.samples_per_symbol, cfg.num_tones, cfg.preamble_samples
    es = ESIZE[dtype]
    ce = 16 // es  # samples a chunk
    g = launch_geometry(dtype, sps, m)
    g["m"] = m
    basis = basis_columns(g, dtype, tk._demod_at_any_basis(cfg, dtype, CPU))
    r, u_n, gm = g["r"], g["u"], g["gm"]
    rows = -(-n_sym // r)
    tiles = -(-rows // g["rows"])
    out = {}
    for bb, tidx in _items(b, tiles, warps):
        r0 = tidx * g["rows"]
        n = min(g["rows"], rows - r0)
        pos = int(start[bb]) + pre + r0 * g["lsamp"]
        at = off + (bb * length + pos) * es
        rb = at % 16
        chunk0 = at - rb
        p0 = pos - rb // es
        whole = p0 >= 0 and p0 + g["chunks"] * ce <= length  # the span's chunks within the row
        stage = np.full(g["stage"], 0xAB, np.uint8)  # a ring stage's stale bytes
        for c in range(g["chunks"]):
            p = p0 + c * ce
            left = length - p
            nbytes = 16 if whole else es * min(left, ce) if (p + ce > 0 and left > 0) else 0
            dst = (c // g["cps"]) * g["row"] + (c % g["cps"]) * 16
            stage[dst : dst + 16] = 0  # cp.async zero-fills past its source size
            stage[dst : dst + nbytes] = mem[chunk0 + 16 * c : chunk0 + 16 * c + nbytes]
        if pos < 0:
            for y in range(min(rb - pos * es, g["chunks"] * 16)):
                stage[(y // g["rb"]) * g["row"] + y % g["rb"]] = 0
        for ub in range(g["mt"] // u_n):
            if 16 * u_n * ub >= n:
                break
            carry = {"on": g["ng"] > 1 or g["p"] * g["passes"] > 1}
            for grp in range(g["ng"]):
                e_rows = []  # [u] of [16 rows, 4 nt pairs] float32
                for u in range(u_n):
                    big = np.zeros((16, 8 * g["nt"]))
                    small = np.zeros_like(big)
                    for ks in range(g["ks"]):
                        a = _a_operand(g, dtype, stage, 16 * (u_n * ub + u) * g["row"], rb >> 2, 8 * (rb & 3), ks)
                        rows_k = slice(ks * g["e"], (ks + 1) * g["e"])
                        p_big, p_small = _iq(dtype, a, [t[rows_k] for t in basis[grp]])
                        big += p_big
                        if p_small is not None:
                            small += p_small
                    iq = big.astype(np.float32)
                    if dtype == torch.float32:
                        iq = (iq + small.astype(np.float32)).astype(np.float32)
                    ii, qq = iq[:, 0::2], iq[:, 1::2]
                    e_rows.append((ii * ii).astype(np.float32) + (qq * qq).astype(np.float32))
                gu = min(gm, 4 * g["nte"])
                sym0 = (r0 + 16 * u_n * ub) * r
                for pw in range(g["p"]):  # the team's warps: n-tiles pw ntw .. (pw + 1) ntw - 1
                    for pas in range(g["passes"]):
                        gp = pw * g["passes"] + pas  # the pass among the group's
                        scratch = np.full((16 * u_n, g["pp"]), np.nan, np.float32)
                        cols = slice(4 * gp * g["nte"], 4 * (gp + 1) * g["nte"])
                        for u in range(u_n):  # row 16 u + g + 8 h, column 4 t + i of the pass
                            scratch[16 * u : 16 * u + 16, : 4 * g["nte"]] = e_rows[u][:, cols]
                        steps = _epilogue(g, decide, scratch, bb, sym0, grp * gm + gp * gu, out, n_sym)
                        if not steps:
                            continue
                        if not carry["on"]:
                            for sg, best, tone, tot in steps:
                                _store_decisions(out, bb, sym0, sg, best, tone, tot, n_sym)
                            continue
                        (sg, best, tone, tot), = steps  # one symbol a lane (pair): r = 1
                        c = carry.setdefault(pw, None)
                        if c is None:
                            carry[pw] = [sg, best, tone, tot]
                        else:  # a warp's passes and groups rise in tone: a tie keeps the earlier
                            up = best > c[1]
                            c[1], c[2] = np.where(up, best, c[1]), np.where(up, tone, c[2])
                            c[3] = (c[3] + tot).astype(np.float32)
            if decide and carry["on"]:
                sg, best, tone, tot = carry[0]
                if g["p"] > 1:  # the second warp's higher tones through the team's merge area
                    _, ob, ot, osum = carry[1]
                    win = (ob > best) | ((ob == best) & (ot < tone))
                    best, tone = np.where(win, ob, best), np.where(win, ot, tone)
                    tot = (tot + osum).astype(np.float32)
                _store_decisions(out, bb, (r0 + 16 * u_n * ub) * r, sg, best, tone, tot, n_sym)
    return out


def _unpack(out: dict, key: str, size: int, dtype=np.float32) -> np.ndarray:
    """The stores of ``key`` as a flat array; every index stored once."""
    idx = np.array([k for (name, k) in out if name == key])
    assert idx.size == size and np.array_equal(np.sort(idx), np.arange(size)), key
    vals = np.empty(size, dtype)
    for (name, k), v in out.items():
        if name == key:
            vals[k] = v
    return vals


def _buffer(cfg, dtype, rng, b: int, length: int, off: int):
    """(flat bytes, the [b, length] buffer at byte ``off`` of them): noise
    and tones of the config's basis, NaN (or -1) bytes around the buffer."""
    x = rng.standard_normal((b, length)).astype(np.float32)
    if dtype == torch.int8:
        t = torch.from_numpy(np.clip(np.round(x * 40), -127, 127)).to(torch.int8)
    else:
        t = torch.from_numpy(x).to(dtype)
    raw = t.contiguous().view(torch.uint8).numpy().reshape(-1)
    mem = np.full(off + raw.size + 64, 0xFF, np.uint8)
    mem[off : off + raw.size] = raw
    return mem, t


def _starts(cfg, length: int, n_sym: int, es: int) -> np.ndarray:
    """Preamble starts whose data starts take every byte residue mod 16,
    a span half past the row's end, one ending at it (its last item's
    chunks run past the row), one wholly past it and one beginning before
    the row's start."""
    sps, pre = cfg.samples_per_symbol, cfg.preamble_samples
    st = [37 + r for r in range(16 // es)] + [300 + 5 * r for r in range(4)]
    st += [length - pre - (n_sym * sps) // 2 - 3, length - pre - n_sym * sps, length, -pre - 2 * sps - 5]
    return np.array(st, np.int64)


def _check_decisions(got, energies: np.ndarray, split: bool):
    """Decisions (tone, best, total) against the plain energies [B, S, M]
    of the same spans: best and total within RTOL of the symbol's largest
    energy (the split: F32_SPLIT_RTOL of themselves plus F32_SPLIT_ATOL of
    it), tones equal but where the two largest energies lie that close."""
    tone, best, total = got
    top, total_w = energies.max(-1), energies.sum(-1)

    def tol(w):
        return tk.F32_SPLIT_RTOL * np.abs(w) + tk.F32_SPLIT_ATOL * top if split else RTOL * top

    near = top - np.sort(energies, -1)[..., -2] <= tol(top)
    assert np.all((tone == energies.argmax(-1)) | near)
    assert np.all(np.abs(best - top) <= tol(top))
    assert np.all(np.abs(total - total_w) <= tol(total_w))


WALK_CASES = {  # (sps, tones, dtype, n_symbols, byte offset of the buffer, ragged rows): every A row layout
    "sps4-bf16": (4, 2, torch.bfloat16, 67, 6, False),
    "sps4-int8": (4, 2, torch.int8, 67, 3, False),
    "sps8-m4-int8": (8, 4, torch.int8, 37, 5, False),
    "sps8-f32": (8, 2, torch.float32, 67, 4, False),
    "sps16-m4-int8": (16, 4, torch.int8, 67, 1, False),
    "sps16-m8-bf16": (16, 8, torch.bfloat16, 37, 2, False),
    "sps16-m4-f32": (16, 4, torch.float32, 37, 12, False),
    "sps64-m32-int8": (64, 32, torch.int8, 37, 7, False),
    "sps128-m32-bf16": (128, 32, torch.bfloat16, 17, 10, False),
    "sps128-m64-f32": (128, 64, torch.float32, 17, 8, False),
    # rows of an odd length: the rows' starts take every byte residue the
    # dtype has; items of 2 m16 tiles (a B fragment on both), 2 lanes a
    # symbol (one m16 tile an item), two epilogue passes
    "sps16-m4-int8-ragged": (16, 4, torch.int8, 150, 9, True),
    "sps16-m4-bf16-ragged": (16, 4, torch.bfloat16, 75, 2, True),
    "sps128-m32-int8-ragged": (128, 32, torch.int8, 33, 5, True),
    "sps8-m2-f32-ragged": (8, 2, torch.float32, 150, 4, True),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walk_matches_the_plain_versions(case):
    """The transliterated walk, both epilogues, against demod_at_fused_ref
    and demod_at_energies_fused_ref on buffers laid in a flat memory at an
    offset off 16 bytes (stale stage bytes, the scratch's unwritten columns
    and the bytes around the buffer are garbage: none may enter a sum or a
    store). int8 energies and best bit-equal (exact int32 I/Q), bf16
    within RTOL, float32 within the split's tolerance; tones equal but at
    near-ties."""
    sps, m, dt, n_sym, off, ragged = WALK_CASES[case]
    cfg = _config(sps, m)
    rng = np.random.default_rng(sps * 131 + m)
    length = cfg.preamble_samples + n_sym * sps + 300 + ragged
    start = _starts(cfg, length, n_sym, ESIZE[dt])
    mem, buf = _buffer(cfg, dt, rng, len(start), length, off)
    b = len(start)
    if ragged:  # row starts at every residue of 16 bytes the dtype allows
        assert len({(off + bb * length * ESIZE[dt]) % 16 for bb in range(b)}) == 16 // ESIZE[dt]
    st = torch.from_numpy(start.astype(np.int32))
    want_e = tk.demod_at_energies_fused_ref(cfg, buf, st, n_sym).numpy()
    got_e = _unpack(emulate_walk(cfg, dt, mem, off, b, length, start, n_sym, False), "energies", b * n_sym * m)
    got_e = got_e.reshape(b, n_sym, m)
    split = dt == torch.float32
    top = want_e.max(-1, keepdims=True)
    if dt == torch.int8:
        np.testing.assert_array_equal(got_e, want_e)
    elif split:
        assert np.all(np.abs(got_e - want_e) <= tk.F32_SPLIT_RTOL * np.abs(want_e) + tk.F32_SPLIT_ATOL * top)
    else:
        assert np.all(np.abs(got_e - want_e) <= RTOL * top)
    stores = emulate_walk(cfg, dt, mem, off, b, length, start, n_sym, True)
    got = [_unpack(stores, k, b * n_sym, np.int32 if k == "tone" else np.float32).reshape(b, n_sym)
           for k in ("tone", "best", "total")]
    if dt == torch.int8:  # integer I/Q: the plain version's bits
        want = tk.demod_at_fused_ref(cfg, buf, st, n_sym)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())
    _check_decisions(got, want_e, split)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_every_instantiation_fits_a_block(dtype):
    """Every (KS, NT) instantiation of demod_at_any.cu for the dtype (KS 1,
    2, 4, 8 k-steps an A row, int8 at most 4; NT 1, 2, 4, 8 n-tiles): a
    row's chunks divide a warp's (the copy loop's constant offsets), its
    shared memory (b0 past the registers at 64 tones, and b1 and b2 where
    pairs of warps share items; four warps' rings and scratch, or six to
    eight pairs') within a block's 232,448 bytes; at the two custom modems'
    geometries (sps 16 with 4 tones, sps 128 with 32) B in registers at sps
    16, and every lane's word offsets of a k-step but the last within its
    staged row."""
    dt = DTYPES[dtype]
    for ks in (1, 2, 4) + (() if dt == torch.int8 else (8,)):
        for nt in (1, 2, 4, 8):
            c = walk_constants(dt, ks, nt)
            assert 32 % c["cps"] == 0 and c["rb"] % 32 == 0
            basis = 0 if c["breg"] else 2 * ks * nt * 32 * 8 * (3 if c["p"] > 1 else 1)  # 64 tones
            teams = min(8, (232_448 - basis) // c["team_smem"]) if c["p"] > 1 else WARPS
            assert teams >= (6 if c["p"] > 1 else 4), (ks, nt)
            smem = basis + teams * c["team_smem"]
            assert smem <= 232_448, (ks, nt, smem)
            assert c["p"] * c["passes"] in (1, 2) and (c["p"] * c["passes"] == 1 or ks > 1)
            # x = x0 + WK ks + XH hk + w < WPS for every k-step before the last (x0 <= 3 + 2 * 3)
            wk, xh = c["rb"] // ks // 4, 8 if dt == torch.float32 else 4
            assert all(9 + wk * k + xh + 1 < c["wps"] for k in range(ks - 1))
    assert launch_geometry(dt, 16, 4)["breg"]
    assert not launch_geometry(dt, 128, 32)["breg"]


# --- the plain versions against the reference ------------------------------------


REF_CASES = {  # (sps, tones, dtype, kernel): each epilogue and dtype once over the four geometries
    "sps8-m4": (8, 4, "int8", "decisions"),
    "sps16-m8": (16, 8, "bf16", "energies"),
    "sps64-m32": (64, 32, "f32", "decisions"),
    "sps128-m32": (128, 32, "int8", "energies"),
}
JDTYPES = {"bf16": jnp.bfloat16, "int8": jnp.int8, "f32": jnp.float32}


def _ref_inputs(cfg, dtype: str, seed: int, n_sym: int):
    rng = np.random.default_rng(seed)
    sps = cfg.samples_per_symbol
    length = cfg.preamble_samples + n_sym * sps + 512
    x = rng.standard_normal((5, length)).astype(np.float32)
    if dtype == "int8":
        x = np.clip(np.round(x * 40), -127, 127)
    start = np.array([0, 3, 17, 250, 511 - 3 * sps], np.int32)
    buf = torch.from_numpy(x).to(DTYPES[dtype])
    jbuf = jnp.asarray(x).astype(JDTYPES[dtype])
    return buf, jbuf, start


@pytest.mark.parametrize("case", list(REF_CASES))
def test_plain_versions_match_pallas(case):
    """The plain versions against anet's Pallas kernels (interpret mode) off
    the walk: tones equal, energies, best and total within RTOL (float32
    sums in another order; int8's I/Q are exact integers, but XLA on the CPU
    may fuse I*I + Q*Q, which the plain version rounds twice)."""
    sps, m, dtype, kernel = REF_CASES[case]
    cfg, jcfg = _config(sps, m), _config(sps, m, JModemConfig)
    n_sym = 37
    buf, jbuf, start = _ref_inputs(cfg, dtype, sps + m, n_sym)
    st = torch.from_numpy(start)
    if kernel == "energies":
        got = tk.demod_at_energies_fused_ref(cfg, buf, st, n_sym).numpy()
        want = np.asarray(jk.demod_at_energies_fused(jcfg, jbuf, jnp.asarray(start), n_sym, interpret=True))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * want.max())
        return
    got = tk.demod_at_fused_ref(cfg, buf, st, n_sym)
    want = jk.demod_at_fused(jcfg, jbuf, jnp.asarray(start), n_sym, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for k in (1, 2):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_plain_versions_at_sps4_match_the_reference_filterbank(dtype):
    """sps 4 (2 tones at 12,000 baud): the reference's Pallas kernel raises
    at every length (its output block's 'swap'), so the plain versions are
    held against its jnp filterbank (anet.dsp.demod.tone_energies) on the
    same spans: energies within RTOL, the decisions its argmax, max and
    sum."""
    cfg = ModemConfig(48_000, 12_000, num_tones=2, base_freq_hz=3_000.0)
    jcfg = JModemConfig(48_000, 12_000, num_tones=2, base_freq_hz=3_000.0)
    n_sym = 67
    buf, _, start = _ref_inputs(cfg, dtype, 4, n_sym)
    st = torch.from_numpy(start)
    x = buf.float().numpy()
    idx = start[:, None] + cfg.preamble_samples + np.arange(n_sym * 4)
    span = np.where((idx >= 0) & (idx < x.shape[1]), np.take_along_axis(x, np.clip(idx, 0, x.shape[1] - 1), 1), 0)
    want = np.asarray(jdemod.tone_energies(jcfg, jnp.asarray(span), compute_dtype=JDTYPES[dtype]))
    got = tk.demod_at_energies_fused_ref(cfg, buf, st, n_sym).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * want.max())
    tone, best, total = (t.numpy() for t in tk.demod_at_fused_ref(cfg, buf, st, n_sym))
    np.testing.assert_array_equal(tone, want.argmax(-1))
    np.testing.assert_allclose(best, want.max(-1), rtol=RTOL)
    np.testing.assert_allclose(total, want.sum(-1), rtol=RTOL)


# --- the locked stream's card branch ----------------------------------------------


def test_locked_int8_stream_at_sps16_takes_the_merged_route(monkeypatch):
    """receive_stream(lock=True) on an int8 carry at sps 16 (48 kHz, 3,000
    baud, 4 tones), the card's branch driven on the CPU: the merged lock
    step's predicate asked as on the card (a CUDA buffer), so the step runs
    demod_probe_fused and, on acquisition, demod_at_fused on the int8
    buffer (the x127 integer basis) and never slices; detections, frame
    starts, verdicts and payloads equal the reference's."""
    cfg = ModemConfig(48_000, 3_000, num_tones=4)
    jcfg = JModemConfig(48_000, 3_000, num_tones=4)
    pay, chunk, b = 16, 2048, 3
    real = tstream._merged_lock_supported
    on_card = type("Carry", (), {"buffer": type("Buffer", (), {"is_cuda": True})()})()
    monkeypatch.setattr(tstream, "_merged_lock_supported", lambda config, carry: real(config, on_card))
    calls = {"demod_probe_fused": 0, "demod_at_fused": 0}
    for name in calls:
        fn = getattr(tk, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            assert a[1].dtype == torch.int8  # the carry itself, never a slice cast to compute
            return _fn(*a, **k)

        monkeypatch.setattr(tk, name, counted)
    monkeypatch.setattr(tstream, "_batched_dynamic_slice", None)  # the sliced route must not run
    rng = np.random.default_rng(0x516)
    t_frame = jfamily.frame_samples(jcfg, pay)
    pays = rng.integers(0, 256, (b * 3, pay), dtype=np.uint8)
    waves = np.asarray(jax.jit(jfamily.transmit_fn(jcfg))(jnp.asarray(pays))).reshape(b, 3, t_frame)
    length = -(-(450 + 131 * (b - 1) + 4 * t_frame + chunk) // chunk) * chunk
    cap = np.zeros((b, length), np.float32)
    for s in range(b):
        for i in range(3):
            lo = 450 + 131 * s + i * t_frame
            cap[s, lo : lo + t_frame] = waves[s, i]
    cap += 0.1 * rng.standard_normal(cap.shape).astype(np.float32)
    carry = tstream.init_carry(cfg, chunk, pay, (b,), dtype=torch.int8, device="cpu")
    jcarry = jstream.init_carry(jcfg, chunk, pay, (b,), dtype=jnp.int8)
    got = tstream.receive_stream(cfg, cap, chunk, pay, lock=True, carry=carry, compute_dtype=torch.bfloat16,
                                 device="cpu")
    want = jstream.receive_stream(jcfg, jnp.asarray(cap), chunk, pay, lock=True, carry=jcarry,
                                  compute_dtype=jnp.bfloat16)
    assert calls["demod_probe_fused"] > 0 and calls["demod_at_fused"] > 0
    assert np.asarray(want.carry.frames_ok).tolist() == [3] * b
    det = got.steps.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(want.steps.detected))
    np.testing.assert_array_equal(got.steps.frame_start.numpy()[det], np.asarray(want.steps.frame_start)[det])
    for f in ("ok", "magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok"):
        np.testing.assert_array_equal(getattr(got.steps.frame, f).numpy(), np.asarray(getattr(want.steps.frame, f)))
    np.testing.assert_array_equal(got.steps.frame.payload.numpy()[det], np.asarray(want.steps.frame.payload)[det])
    for f in ("frames_detected", "frames_ok", "locked"):
        np.testing.assert_array_equal(getattr(got.carry, f).numpy(), np.asarray(getattr(want.carry, f)), f)
