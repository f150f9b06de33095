"""The batch-major filterbank at every geometry off tone_energies.cu's
compile-time walks (csrc/filterbank_any.cu: any samples_per_symbol, any
tone count, on the tensor cores). The kernel runs only on the card, so these
tests hold on the CPU:

- its basis operand, kernels._filterbank_any_basis: zero rows past sps,
  words in (group, k-step, n-tile, lane) order, entries those of
  _plain_basis (float32 compute: three bf16 terms summing to them);
- a numpy transliteration of the kernel's walk (the launch's slab
  geometry, fetch's 16-byte copies of each symbol's slab with their byte
  residue and the copy's source size, the lanes' A registers built from
  the staged words with a funnel shift or split from float32 samples, the
  samples past sps zeroed in registers, the B words read at the kernel's
  index, the groups' energies and their decisions' fold) against the plain
  version, on rows at odd pitches off 16 bytes whose gaps hold NaN: every
  copy inside its row, every read inside its staged row;
- the plain version against the JAX package's Pallas kernels (interpret
  mode) at sps 1,920, past the CUDA-core body's old ceiling of 1,536.

The card's own comparison: tests/test_torch_kernels_cuda.py -k any_geometry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anet.kernels as jk
from anet.dsp.params import ModemConfig as JModemConfig

from anet_torch import kernels as tk
from anet_torch.dsp.params import ModemConfig

CPU = torch.device("cpu")
GROUP = 32  # csrc/filterbank_any.cu


def _stage_target(split: bool) -> int:
    """filterbank_any.cu's stage_target: bytes a ring stage holds at most."""
    return 8192 if split else 4096


def _ring_depth(esize: int, long: bool) -> int:
    """filterbank_any.cu's ring_depth: 2 for float32 rows of one slab, else 3."""
    return 2 if esize == 4 and not long else 3


def _config(sps: int, m: int, rate: int = 48_000, cls=ModemConfig):
    """``m`` tones of ``sps`` samples a symbol at ``rate``, from half the
    symbol rate."""
    baud = rate // sps
    return cls(sample_rate_hz=rate, symbol_rate_hz=baud, num_tones=m, base_freq_hz=baud / 2)


GEOMETRIES = {  # odd sps, 44.1 kHz / 441, a long symbol, two and eight groups
    "sps15-m4": (15, 4, 48_000),
    "sps40-m4": (40, 4, 48_000),  # tests/test_torch_kernels_ref.py's custom config
    "sps40-m8": (40, 8, 48_000),
    "sps40-m16": (40, 16, 48_000),  # chip_smoke.py's stream-custom-f32 modem
    "sps100-m16": (100, 16, 44_100),
    "sps1920-m16": (1920, 16, 48_000),
    "sps160-m64": (160, 64, 48_000),
}


def _geometry(sps: int, m: int, esize: int, split: bool) -> dict:
    """filterbank_any.cu's launch(): tiles, slabs and staged rows."""
    gm = min(m, GROUP)
    nt = tk._demod_mma_tiles(gm)
    mt = 2 if nt <= 4 else 1
    syms, ks = 16 * mt, -(-sps // 16)

    def row_bytes(k):
        p = 16 * esize * k + 16
        return p if (p // 16) % 2 else p + 16

    ksl = ks
    while ksl > 1 and syms * row_bytes(ksl) > _stage_target(split):
        ksl -= 1
    nsl = -(-ks // ksl)
    ksl = -(-ks // nsl)
    cpr = (15 + min(16 * ksl, sps) * esize + 15) // 16
    return dict(gm=gm, ng=m // gm, nt=nt, mt=mt, syms=syms, ks=ks, ksl=ksl, nsl=nsl, row=row_bytes(ksl),
                cpr=cpr, rpp=32 // cpr)


def _unpack_words(w: np.ndarray) -> np.ndarray:
    """The [16 ks, 8 nt] matrix of bf16 words [ks, nt, 32, 2]: register r of
    lane (g, i) holds rows 16 s + 8 r + 2 i + (0, 1) of column 8 t + g."""
    ks, nt = w.shape[:2]
    bits = np.stack([w & 0xFFFF, w >> 16], -1).astype(np.uint32) << 16  # [ks, nt, 32, 2, e]
    v = bits.view(np.float32).reshape(ks, nt, 8, 4, 2, 2)  # [s, t, g, i, r, e]
    return v.transpose(0, 4, 3, 5, 1, 2).reshape(16 * ks, 8 * nt).astype(np.float64)


@pytest.mark.parametrize("compute", ["bf16", "float32"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_any_basis_layout(geometry, compute):
    """_filterbank_any_basis: bfloat16 compute, one term [ng, ks, nt, 32,
    2] whose words unpack to the interleaved basis of each group of 32
    tones with _plain_basis's bf16 entries; float32 compute, b0 in that
    layout then b1 and b2 interleaved a lane, three bf16 terms summing to
    the float32 entries exactly. Rows past sps are zero; cached per
    (config, dtype, device)."""
    sps, m, rate = GEOMETRIES[geometry]
    cfg = _config(sps, m, rate)
    dt = torch.bfloat16 if compute == "bf16" else torch.float32
    g = _geometry(sps, m, 2, compute == "float32")
    ng, ks, nt, gm = g["ng"], g["ks"], g["nt"], g["gm"]
    entry, route, basis = tk._filterbank_operands("tone_energies", cfg, dt, CPU)
    assert (entry, route) == (("tone_energies_any", "any") if compute == "bf16"
                              else ("tone_energies_any_f32", "any_split"))
    assert basis is tk._filterbank_any_basis(cfg, dt, CPU) and basis.dtype == torch.int32
    words = basis.numpy().view(np.uint32)
    n0 = ng * ks * nt * 64
    assert words.size == n0 * (1 if compute == "bf16" else 3)
    terms = [words[:n0].reshape(ng, ks, nt, 32, 2)]
    if compute == "float32":
        b12 = words[n0:].reshape(ng, ks, nt, 32, 2, 2)  # [..., lane, term, register]
        terms += [np.ascontiguousarray(b12[..., 0, :]), np.ascontiguousarray(b12[..., 1, :])]
    plain = tk._plain_basis(cfg, dt, CPU).double().numpy()  # [sps, 2M]
    total = sum(np.stack([_unpack_words(t[grp]) for grp in range(ng)]) for t in terms)  # [ng, 16 ks, 8 nt]
    assert not total[:, sps:].any()
    for grp in range(ng):
        tones = slice(grp * gm, (grp + 1) * gm)
        np.testing.assert_array_equal(total[grp, :sps, 0 : 2 * gm : 2], plain[:, :m][:, tones])
        np.testing.assert_array_equal(total[grp, :sps, 1 : 2 * gm : 2], plain[:, m:][:, tones])
        assert not total[grp, :, 2 * gm :].any()


def _memory(rows_dtype: torch.dtype, r: int, n: int, seed: int):
    """(flat bytes, base, pitch in bytes, rows [r, n]): r rows of n samples
    of noise, the first 6 bytes (bf16) or 4 (float32) into the memory, an
    odd pitch of n + 3 samples (so rows pass through every residue), the gaps
    NaN bytes, the last row ending at the memory's end."""
    esize = 2 if rows_dtype == torch.bfloat16 else 4
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(rng.standard_normal((r, n)).astype(np.float32)).to(rows_dtype)
    raw = rows.view(torch.int16 if esize == 2 else torch.int32).numpy().view(np.uint8).reshape(r, n * esize)
    base, pitch = 3 * esize if esize == 2 else esize, (n + 3) * esize
    mem = np.full(base + (r - 1) * pitch + n * esize, 0xFF, np.uint8)
    for b in range(r):
        mem[base + b * pitch : base + b * pitch + n * esize] = raw[b]
    return mem, base, pitch, rows


def _bf16_split(x: np.ndarray) -> list[np.ndarray]:
    """float32 x as three bf16 terms (round to nearest even), as bf16_pair."""
    terms, rest = [], torch.from_numpy(x.astype(np.float32))
    for _ in range(3):
        t = rest.to(torch.bfloat16).float()
        terms.append(t.double().numpy())
        rest = rest - t
    return terms


def emulate_walk(cfg, mem, base, pitch, r, s, rows_dtype, compute):
    """The energies [r, s, M] (float64 sums of the kernel's products) and
    decisions (tone, best, total) of filterbank_any.cu on the rows in
    ``mem``, one warp walking every item through its ring of _ring_depth
    stages that start as NaN bytes."""
    sps, m = cfg.samples_per_symbol, cfg.num_tones
    f32 = rows_dtype == torch.float32
    esize = 4 if f32 else 2
    split = compute == torch.float32
    g = _geometry(sps, m, esize, split)
    gm, ng, nt, mt_n, syms, ks = g["gm"], g["ng"], g["nt"], g["mt"], g["syms"], g["ks"]
    ksl, nsl, row, cpr, rpp = g["ksl"], g["nsl"], g["row"], g["cpr"], g["rpp"]
    assert 16 * cpr <= row and rpp >= 1 and syms * row <= _stage_target(split)
    # the lanes' copy map covers every (row, chunk) of a stage once
    lane = np.arange(32)
    cover = {(ro, c) for ro, c in zip(lane // cpr, lane % cpr) if ro < rpp}
    assert {(rr % rpp, c) for rr in range(syms) for c in range(cpr)} == cover
    words = tk._filterbank_any_basis(cfg, compute, CPU).numpy().view(np.uint32)
    n0 = ng * ks * nt * 64
    b_terms = [words[:n0].reshape(ng, ks, nt, 32, 2)]
    if split:
        b12 = words[n0:].reshape(ng, ks, nt, 32, 2, 2)
        b_terms += [np.ascontiguousarray(b12[..., 0, :]), np.ascontiguousarray(b12[..., 1, :])]
    tiles = -(-s // syms)
    ppi = 1 if nsl == 1 else ng * nsl
    n_pieces = r * tiles * ppi
    n_ring = _ring_depth(esize, nsl > 1)  # the kernel's LONG: past one slab
    ring = [np.full(syms * row, 0xFF, np.uint8) for _ in range(n_ring)]
    energies = np.full((r, s, m), np.nan)
    gq, i = lane >> 2, lane & 3

    def piece(q):
        n, rem = divmod(q, ppi)
        b, t = divmod(n, tiles)
        return b, t * syms, rem % nsl, rem

    def fetch(q):
        if q >= n_pieces:
            return
        stage = ring[q % n_ring]
        b, s0, sl, _ = piece(q)
        lo = sl * ksl * 16
        nbytes = min(ksl * 16, sps - lo) * esize
        row0 = base + b * pitch
        end = row0 + s * sps * esize
        for rr in range(min(syms, s - s0)):
            a = row0 + ((s0 + rr) * sps + lo) * esize
            rb = a & 15
            for c in range(cpr):
                if 16 * c < rb + nbytes:
                    src = a - rb + 16 * c
                    n_bytes = min(16, end - src)
                    assert src >= 0 and 1 <= n_bytes and src + n_bytes <= end <= mem.size
                    dst = rr * row + 16 * c
                    stage[dst : dst + 16] = 0
                    stage[dst : dst + n_bytes] = mem[src : src + n_bytes]

    fold = {}  # (b, symbol) -> [best, tone, total]
    acc = None
    for q in range(n_ring - 1):
        fetch(q)
    for q in range(n_pieces):
        fetch(q + n_ring - 1)
        stage = ring[q % n_ring]
        b, s0, sl, rem = piece(q)
        nk = min(ksl, ks - sl * ksl)
        a_res = base + b * pitch + ((s0 + gq[None, :] + 8 * np.arange(syms // 8)[:, None]) * sps + sl * ksl * 16) * esize
        rb = a_res[0] & 15
        assert (a_res & 15 == rb).all()  # rows g, g + 8, ... share the residue
        groups = range(ng) if nsl == 1 else [rem // nsl]
        for grp in groups:
            if sl == 0:
                acc = np.zeros((mt_n, 16, 8 * nt))
            for kk in range(nk):
                k_step = sl * ksl + kk
                left = sps - 16 * k_step - 2 * i
                b_mats = [_unpack_words(t[grp, k_step][None])[: 16] for t in b_terms]
                for mt in range(mt_n):
                    a_mat = np.zeros((16, 16))
                    for hk in range(2):
                        for h in range(2):
                            base_row = (16 * mt + 8 * h + gq) * row
                            if f32:
                                x = (rb >> 2) + 2 * i + 16 * kk + 8 * hk
                                assert ((x + 2) * 4 <= row).all()
                                fl = stage.view(np.float32)
                                lo_v = fl[base_row // 4 + x].astype(np.float64)
                                hi_v = fl[base_row // 4 + x + 1].astype(np.float64)
                                if k_step == ks - 1:
                                    lo_v = np.where(left - 8 * hk >= 1, lo_v, 0.0)
                                    hi_v = np.where(left - 8 * hk >= 2, hi_v, 0.0)
                                pair = (lo_v, hi_v)
                            else:
                                x = (rb >> 2) + i + 8 * kk + 4 * hk
                                assert ((x + 2) * 4 <= row).all()
                                w = stage.view(np.uint32)
                                lo_w = w[base_row // 4 + x].astype(np.uint64)
                                hi_w = w[base_row // 4 + x + 1].astype(np.uint64)
                                sh = (8 * (rb & 3)).astype(np.uint64)
                                reg = (((hi_w << np.uint64(32)) | lo_w) >> sh) & np.uint64(0xFFFFFFFF)
                                if k_step == ks - 1:
                                    lft = left - 8 * hk
                                    reg &= np.where(lft >= 2, 0xFFFFFFFF, np.where(lft == 1, 0xFFFF, 0)).astype(np.uint64)
                                halves = [((reg >> np.uint64(16 * e)) & np.uint64(0xFFFF)).astype(np.uint32) << 16
                                          for e in range(2)]
                                pair = tuple(v.view(np.float32).astype(np.float64) for v in halves)
                            for e in range(2):
                                a_mat[gq + 8 * h, 8 * hk + 2 * i + e] = pair[e]
                    if f32:  # float32 rows: three bf16 terms, six products
                        a_terms = _bf16_split(a_mat)
                        prod = sum(a_terms[u] @ b_mats[v] for u in range(3) for v in range(3) if u + v <= 2)
                    else:
                        prod = a_mat @ sum(b_mats)
                    acc[mt] += prod
            if sl != nsl - 1:
                continue
            for mt in range(mt_n):
                e = acc[mt][:, 0 : 2 * gm : 2] ** 2 + acc[mt][:, 1 : 2 * gm : 2] ** 2  # [16, gm]
                for rr in range(16):
                    sym = s0 + 16 * mt + rr
                    if sym >= s:
                        continue
                    energies[b, sym, grp * GROUP : grp * GROUP + gm] = e[rr]
                    best_g, tone_g, tot_g = e[rr].max(), int(e[rr].argmax()), e[rr].sum()
                    if grp == 0:
                        fold[b, sym] = [best_g, tone_g, tot_g]
                    else:
                        f = fold[b, sym]
                        if best_g > f[0]:
                            f[0], f[1] = best_g, grp * GROUP + tone_g
                        f[2] += tot_g
    tone = np.array([[fold[b, sym][1] for sym in range(s)] for b in range(r)])
    best = np.array([[fold[b, sym][0] for sym in range(s)] for b in range(r)])
    total = np.array([[fold[b, sym][2] for sym in range(s)] for b in range(r)])
    return energies, (tone, best, total)


WALKS = [("bf16", "bf16"), ("bf16", "float32"), ("float32", "float32")]  # (rows, compute)


@pytest.mark.parametrize("rows,compute", WALKS, ids=["bf16", "split-bf16-rows", "split-f32-rows"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulated_walk_matches_the_plain_version(geometry, rows, compute):
    """The transliterated walk on 3 rows (2 at sps 1,920) of 37 symbols (3 at
    sps 1,920: 120 k-steps in slabs) against tone_energies_fused_ref and
    decide_tones_fused_ref on the same rows: energies within 1e-5 of the
    symbol's largest (bfloat16 compute: bf16 products exact, float32 sums
    in another order) or the split's stated tolerance, every energy
    written, the decisions' tones equal to the plain argmax and best and
    total within the same bounds."""
    sps, m, rate = GEOMETRIES[geometry]
    cfg = _config(sps, m, rate)
    rdt = torch.bfloat16 if rows == "bf16" else torch.float32
    cdt = torch.bfloat16 if compute == "bf16" else torch.float32
    r, s = (2, 3) if sps == 1920 else (3, 37)
    mem, base, pitch, x = _memory(rdt, r, s * sps + 5, seed=sps + m)
    got, (tone, best, total) = emulate_walk(cfg, mem, base, pitch, r, s, rdt, cdt)
    want = tk.tone_energies_fused_ref(cfg, x, compute_dtype=cdt).double().numpy()
    assert not np.isnan(got).any()
    scale = want.max(-1, keepdims=True)
    rtol, atol = (0.0, 1e-5) if cdt == torch.bfloat16 else (tk.F32_SPLIT_RTOL, tk.F32_SPLIT_ATOL)
    assert (np.abs(got - want) <= rtol * np.abs(want) + atol * scale).all()
    np.testing.assert_array_equal(tone, want.argmax(-1))
    for v, w in ((best, want.max(-1)), (total, want.sum(-1))):
        assert (np.abs(v - w) <= rtol * np.abs(w) + atol * scale[..., 0]).all()


def test_plain_version_at_sps_1920_matches_pallas():
    """tone_energies_fused_ref and decide_tones_fused_ref at sps 1,920 with
    16 tones (the custom geometry the CUDA-core body refused past 1,536),
    B = 2 rows of 4 symbols (the JAX kernels take whole symbols), both
    compute dtypes, against
    the JAX package's Pallas kernels in interpret mode: energies within
    1e-5 of the largest under float32 compute (float32 sums of 1,920
    products in another order, bases an ulp apart: torch's and XLA's cos
    and sin), 1e-3 under bfloat16 compute (one of the 61,440 bf16 basis
    entries rounds the other way from those float32 values); tones equal."""
    cfg, jcfg = _config(1920, 16), _config(1920, 16, cls=JModemConfig)
    x = np.random.default_rng(1920).standard_normal((2, 4 * 1920)).astype(np.float32)
    for cdt, jdt, tol in ((torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 1e-3)):
        got = tk.tone_energies_fused_ref(cfg, torch.from_numpy(x), compute_dtype=cdt).numpy()
        want = np.asarray(jk.tone_energies_fused(jcfg, jnp.asarray(x), compute_dtype=jdt, interpret=True))
        assert got.shape == want.shape == (2, 4, 16)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(want.max()))
        tone, best, total = tk.decide_tones_fused_ref(cfg, torch.from_numpy(x), compute_dtype=cdt)
        jtone, jbest, jtotal = jk.decide_tones_fused(jcfg, jnp.asarray(x), compute_dtype=jdt, interpret=True)
        np.testing.assert_array_equal(tone.numpy(), np.asarray(jtone))
        np.testing.assert_allclose(best.numpy(), np.asarray(jbest), rtol=tol)
        np.testing.assert_allclose(total.numpy(), np.asarray(jtotal), rtol=tol)
