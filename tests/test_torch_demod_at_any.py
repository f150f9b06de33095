"""csrc/demod_at_any.cu on the CPU: the align+demod kernels (demod_at_fused,
demod_at_energies_fused, demod_probe_fused's demod) at the geometries of
the reference's gate (128 % sps == 0) off demod_at.cu's compile-time walk:
sps 4, 8 and 16, and 32 or 64 tones at sps 64 and 128.

- Its basis, kernels._demod_at_any_basis, read back at the kernel's word
  index: the reference's block-diagonal layout cut to a k-step (r = E / sps
  symbols an A row, slot u's columns on rows u sps .. (u + 1) sps - 1), or
  32 tones a group for a row of one symbol; float32 as three bf16 terms
  summing to the entries exactly.
- A numpy transliteration of the walk (its launch geometry, the span's
  16-byte copies into staged rows with their pad, the zero fill past the
  row and before its start into stages of stale bytes, the funnel-shift A
  registers or the float32 samples split into three bf16 terms, the B words
  at the kernel's index, both epilogues lane by lane: slots, quad or pair
  shuffles, groups folded in order) against the plain versions.
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


def launch_geometry(dtype: torch.dtype, sps: int, m: int) -> dict:
    """demod_at_any.cu's dispatch: symbols an A row, its samples, k-steps,
    groups and n-tiles, the staged row and ring stage, the tile's rows."""
    e = 32 if dtype == torch.int8 else 16
    r = e // sps if sps < e else 1
    gm = m if r > 1 or m < GROUP else GROUP
    cols = r * 2 * gm
    rb = r * sps * ESIZE[dtype]
    mt = 1 if 16 * rb >= STAGE_TARGET else STAGE_TARGET // (16 * rb)
    return {
        "e": e, "r": r, "lsamp": r * sps, "ks": r * sps // e, "gm": gm, "ng": m // gm,
        "nt": 1 if cols <= 8 else 2 if cols <= 16 else 4 if cols <= 32 else 8,
        "rb": rb, "row": rb + 16, "cps": rb // 16, "wps": rb // 4, "mt": mt,
        "chunks": 16 * mt * (rb // 16) + 1, "stage": 16 * mt * (rb + 16) + 16,
    }


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


def _epilogue(g: dict, decide: bool, e: np.ndarray, b: int, row0: int, grp: int, fold: dict, out: dict, n_sym: int):
    """demod_at_any.cu's epilogue, lane by lane: e [32 lanes, nt, 2] float32,
    the energy of the group's pair 4 t + i of row row0 + lane / 4 + 8 h.
    Each store is recorded; a second store to one index fails."""
    lane = np.arange(32)
    gq, i = lane >> 2, lane & 3
    r, gm, ng, nt = g["r"], g["gm"], g["ng"], g["nt"]

    def store(key, idx, vals):
        for k, v in zip(idx, vals):
            assert (key, k) not in out, (key, k)
            out[(key, k)] = v

    for h in range(2):
        sym0 = (row0 + gq + 8 * h) * r
        if not decide:
            for t in range(nt):
                p = 4 * t + i
                u = p // gm
                ok = (u < r) & (sym0 + u < n_sym)
                idx = (b * n_sym + sym0 + u) * g["m"] + grp * gm + p - u * gm
                store("energies", idx[ok], e[ok, t, h])
            continue
        quad = gm >= 4
        tps = gm // 4 if quad else 1
        for t in range(nt):
            p = 4 * t + i
            c = p & (gm - 1)
            v = e[:, t, h]
            if t % tps == 0:
                bq, bt, tot = v.copy(), c.copy(), v.copy()
            else:
                up = v > bq
                bq, bt, tot = np.where(up, v, bq), np.where(up, c, bt), (tot + v).astype(np.float32)
            if (t + 1) % tps:
                continue
            for off in (1, 2):
                if off == 1 or quad:
                    oq, ot = bq[lane ^ off], bt[lane ^ off]
                    tot = (tot + tot[lane ^ off]).astype(np.float32)
                    win = (oq > bq) | ((oq == bq) & (ot < bt))
                    bq, bt = np.where(win, oq, bq), np.where(win, ot, bt)
            if grp == 0:
                fold[h] = (bq, bt, tot)
            else:
                fb, ft, fs = fold[h]
                up = bq > fb
                fold[h] = (np.where(up, bq, fb), np.where(up, grp * gm + bt, ft), (fs + tot).astype(np.float32))
            u = p // gm
            sym = sym0 + u
            ok = (grp == ng - 1) & ((i if quad else i & 1) == h) & (u < r) & (sym < n_sym)
            fb, ft, fs = fold[h]
            idx = b * n_sym + sym
            store("tone", idx[ok], ft[ok])
            store("best", idx[ok], fb[ok])
            store("total", idx[ok], fs[ok])


def emulate_walk(cfg, dtype, mem: np.ndarray, off: int, b: int, length: int, start: np.ndarray, n_sym: int,
                 decide: bool) -> dict:
    """demod_at_any.cu on a [b, length] buffer at byte ``off`` of the flat
    bytes ``mem``: every (stream, tile) item's span copied as cp.async's
    source size allows into a stage of stale bytes, the bytes before the
    row's start zeroed, every m16 tile and group through the products and
    the epilogue. Returns the stores by (output, flat index)."""
    sps, m, pre = cfg.samples_per_symbol, cfg.num_tones, cfg.preamble_samples
    es = ESIZE[dtype]
    ce = 16 // es  # samples a chunk
    g = launch_geometry(dtype, sps, m)
    g["m"] = m
    basis = basis_columns(g, dtype, tk._demod_at_any_basis(cfg, dtype, CPU))
    rows = -(-n_sym // g["r"])
    tile_rows = 16 * g["mt"]
    tiles = -(-rows // tile_rows)
    out = {}
    for j in range(b * tiles):
        bb, tidx = divmod(j, tiles)
        r0 = tidx * tile_rows
        n = min(tile_rows, rows - r0)
        pos = int(start[bb]) + pre + r0 * g["lsamp"]
        at = off + (bb * length + pos) * es
        rb = at % 16
        chunk0 = at - rb
        need = (rb + n * g["rb"] + 15) // 16
        p0 = pos - rb // es
        stage = np.full(g["stage"], 0xAB, np.uint8)  # a ring stage's stale bytes
        for c in range(g["chunks"]):
            p = p0 + c * ce
            left = length - p
            nbytes = es * min(left, ce) if (c < need and p + ce > 0 and left > 0) else 0
            dst = (c // g["cps"]) * g["row"] + (c % g["cps"]) * 16
            stage[dst : dst + 16] = 0  # cp.async zero-fills past its source size
            stage[dst : dst + nbytes] = mem[chunk0 + 16 * c : chunk0 + 16 * c + nbytes]
        if pos < 0:
            for y in range(min(rb - pos * es, g["chunks"] * 16)):
                stage[(y // g["rb"]) * g["row"] + y % g["rb"]] = 0
        for mt in range(g["mt"]):
            if 16 * mt >= n:
                break
            fold = {}
            for grp in range(g["ng"]):
                big = np.zeros((16, 8 * g["nt"]))
                small = np.zeros_like(big)
                for ks in range(g["ks"]):
                    a = _a_operand(g, dtype, stage, 16 * mt * g["row"], rb >> 2, 8 * (rb & 3), ks)
                    rows_k = slice(ks * g["e"], (ks + 1) * g["e"])
                    p_big, p_small = _iq(dtype, a, [t[rows_k] for t in basis[grp]])
                    big += p_big
                    if p_small is not None:
                        small += p_small
                iq = big.astype(np.float32)
                if dtype == torch.float32:
                    iq = (iq + small.astype(np.float32)).astype(np.float32)
                ii, qq = iq[:, 0::2], iq[:, 1::2]  # [16 rows, 4 nt pairs]
                e_rows = (ii * ii).astype(np.float32) + (qq * qq).astype(np.float32)
                lane = np.arange(32)
                e = np.stack([np.stack([e_rows[(lane >> 2) + 8 * h, 4 * t + (lane & 3)] for h in range(2)], -1)
                              for t in range(g["nt"])], 1)
                _epilogue(g, decide, e.astype(np.float32), bb, r0 + 16 * mt, grp, fold, out, n_sym)
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
    a span half past the row's end, one wholly past it and one beginning
    before the row's start."""
    sps, pre = cfg.samples_per_symbol, cfg.preamble_samples
    st = [37 + r for r in range(16 // es)] + [300 + 5 * r for r in range(4)]
    st += [length - pre - (n_sym * sps) // 2 - 3, length, -pre - 2 * sps - 5]
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


WALK_CASES = {  # (sps, tones, dtype, n_symbols, byte offset of the buffer): every layout of the A rows
    "sps4-bf16": (4, 2, torch.bfloat16, 67, 6),
    "sps4-int8": (4, 2, torch.int8, 67, 3),
    "sps8-m4-int8": (8, 4, torch.int8, 37, 5),
    "sps8-f32": (8, 2, torch.float32, 67, 4),
    "sps16-m4-int8": (16, 4, torch.int8, 67, 1),
    "sps16-m8-bf16": (16, 8, torch.bfloat16, 37, 2),
    "sps16-m4-f32": (16, 4, torch.float32, 37, 12),
    "sps64-m32-int8": (64, 32, torch.int8, 37, 7),
    "sps128-m32-bf16": (128, 32, torch.bfloat16, 17, 10),
    "sps128-m64-f32": (128, 64, torch.float32, 17, 8),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walk_matches_the_plain_versions(case):
    """The transliterated walk, both epilogues, against demod_at_fused_ref
    and demod_at_energies_fused_ref on buffers laid in a flat memory at an
    offset off 16 bytes (stale stage bytes and the bytes around the buffer
    are garbage: none may enter a sum). int8 energies and best bit-equal
    (exact int32 I/Q), bf16 within RTOL, float32 within the split's
    tolerance; tones equal but at near-ties."""
    sps, m, dt, n_sym, off = WALK_CASES[case]
    cfg = _config(sps, m)
    rng = np.random.default_rng(sps * 131 + m)
    length = cfg.preamble_samples + n_sym * sps + 300
    start = _starts(cfg, length, n_sym, ESIZE[dt])
    mem, buf = _buffer(cfg, dt, rng, len(start), length, off)
    b = len(start)
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
