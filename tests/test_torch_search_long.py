"""Templates past the one-shot search stage (csrc/search_core.cuh's slab
route: sync_search_fused, sync_search_blockmax and correlate_fused at
preambles of 15,360 samples and up). The kernels run only on the card, so
these tests hold on the CPU:

- the slab route's geometry (make_slab_geometry mirrored): a slab a
  multiple of 8 k-steps, the slabs evened out, the block's shared memory
  within the card's 232,448 bytes at templates of 15,360 and 61,440
  samples in every dtype pair;
- a numpy transliteration of the route's walk, with slabs forced small so
  a short template crosses several: the template words a slab stages
  (a window of kernels._search_template_words, the operand the one-shot
  route reads whole), read back at the lanes' B-ring indices, equal the
  banded template; the span rows staged from the slab's first sample; the
  block energies and scales; the product and the rows' maxima, held
  against sync_search_fused_ref and correlate_fused_ref;
- the plain versions against the JAX package's Pallas kernels (interpret
  mode) at a template past the float32 x float32 limit, B and out_len
  small.

The card's own comparison: tests/test_torch_kernels_cuda.py -k
"past_the_one_shot or long_symbols".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anet.kernels as jk

from anet_torch import kernels as tk

ROW, PITCH, TPL_OFF, MAX_SMEM = 128, 136, 128, 232448  # search_core.cuh
NT, NTW, FOLD = 16, 8, 32  # n8 tiles of a row, of a slab warp's walk; k-steps between the slab route's folds
SLAB_ROWS = 64  # rows of a slab block: 4 row groups, two warps each
# a block's dynamic shared memory where two share a multiprocessor: half of 233,472 bytes less 1,024 a
# block, less the search's 64 static bytes
SLAB_SMEM = (233472 - 2 * 1024) // 2 - 64


def _split(n_rows: int, max_rows: int) -> tuple[int, int]:
    """(blocks, rows a block, a multiple of 16): the rows split evenly over
    the fewest blocks of at most max_rows."""
    n_tiles = -(-n_rows // max_rows)
    return n_tiles, -(-(-(-n_rows // n_tiles)) // 16) * 16


def one_shot_fits(k: int, out_len: int, a_lo: bool, b_lo: bool) -> bool:
    """search_core.cuh's make_geometry: the whole template and span staged."""
    _, mt = _split(-(-out_len // ROW), 96 if a_lo or b_lo else 128)
    nks = (k + ROW - 1 + 15) // 16
    nb = max(mt - 1 + (16 * nks + ROW - 1) // ROW, mt + (k + ROW - 1) // ROW)
    w = 8 * nks + 72
    w += (16 - w) % 32
    return (2 if b_lo else 1) * 2 * w * 4 + (2 if a_lo else 1) * nb * PITCH * 2 + (nb + mt) * 4 <= MAX_SMEM


def ring_rows(mt: int, ksl: int) -> int:
    """The span ring's slots: a slab's rows and the next slab's new ones,
    rounded up to 8 (search_core.cuh slab_ring_rows)."""
    return (mt - 1 + ksl // 4 + 7) // 8 * 8


def slab_smem(mt: int, nbe: int, ksl: int, a_lo: bool, b_lo: bool) -> int:
    """search_core.cuh's slab_smem: two template windows, the ring, the
    float32 samples on their way to it (the next slab's rows), or over
    these once the walk is done the float32 sums of the rows; the block
    energies and scales."""
    walk = (2 * (4 if b_lo else 2) * (8 * ksl + 80) * 4 + (2 if a_lo else 1) * ring_rows(mt, ksl) * PITCH * 2
            + (ksl // 8 * ROW * 4 if a_lo else 0))
    return max(mt * ROW * 4, walk) + (nbe + mt) * 4


def slab_geometry(k: int, out_len: int, a_lo: bool, b_lo: bool, ksl_max: int | None = None) -> dict:
    """search_core.cuh's make_slab_geometry: up to 64 rows a block (two
    warps a row group of 16), a slab of the most k-steps (a multiple of 8,
    at most 16 a warp, or ksl_max) that keeps the block within SLAB_SMEM,
    so that two blocks share a multiprocessor, evened out; else one block
    within MAX_SMEM, with fewer rows where it must."""
    n_rows = -(-out_len // ROW)
    nks = (k + ROW - 1 + 15) // 16
    kb = (k + ROW - 1) // ROW + 1
    n_steps = -(-nks // 8) * 8
    for budget in (SLAB_SMEM, MAX_SMEM):
        for max_rows in range(SLAB_ROWS, 15, -16):
            if budget == SLAB_SMEM and max_rows < SLAB_ROWS:
                break
            n_tiles, mt = _split(n_rows, max_rows)
            nbe = mt + kb - 1
            warps = mt // 16 * 2
            ksl = min(n_steps, 16 * warps, ksl_max or n_steps)
            while ksl > 8 and slab_smem(mt, nbe, ksl, a_lo, b_lo) > budget:
                ksl -= 8
            if slab_smem(mt, nbe, ksl, a_lo, b_lo) > budget:
                continue
            n_slabs = -(-n_steps // ksl)
            ksl = -(-(-(-n_steps // n_slabs)) // 8) * 8
            return dict(mt=mt, n_tiles=n_tiles, n_rows=n_rows, nks=nks, n_steps=n_steps, kb=kb, nbe=nbe, ksl=ksl,
                        ws=8 * ksl + 80, rr=ring_rows(mt, ksl), warps=warps, blocks=2 if budget == SLAB_SMEM else 1,
                        smem=slab_smem(mt, nbe, ksl, a_lo, b_lo))
    raise ValueError("no slab geometry")


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (to nearest even), as float64."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).double().numpy()


def _decode(words: np.ndarray) -> np.ndarray:
    """The bf16 pairs of uint32 words: [..., 2] float64, the low half first."""
    w = words.astype(np.uint32)
    bits = np.stack([w & 0xFFFF, w >> 16], -1).astype(np.uint32) << 16
    return bits.view(np.float32).astype(np.float64)


def emulate_slabs(seg: np.ndarray, template: torch.Tensor, out_len: int, te: float, a_lo: bool,
                  ksl_max: int) -> tuple[np.ndarray, np.ndarray]:
    """(corr [B, out_len], q [B, out_len]) as the slab route computes them
    (float64 sums of the same bf16 operands): per block of mt rows, the
    energies of blocks 0 .. nbe - 1 from its first sample and one scale a
    row; the first slab's span rows and template window staged, then per
    slab the next slab's window (into the other of two buffers, zero past
    the copy's words) and its new rows (into their ring slots) staged
    before this slab's walk, whose reads of a slot must find the row they
    want; each lane's B ring of 9 words a column half, loaded once
    and run on across slabs, its words checked against the banded
    template; per k-step the hi*hi, hi*lo, lo*hi products in that order,
    folded into the sum every FOLD k-steps."""
    words = tk._search_template_words(template).numpy().view(np.uint32)  # [P, 2, w]
    k = template.shape[-1]
    n_half = words.shape[0]
    b_lo = n_half == 2
    w = words.shape[-1]
    g = slab_geometry(k, out_len, a_lo, b_lo, ksl_max)
    mt, ksl, ws, rr, n_steps = g["mt"], g["ksl"], g["ws"], g["rr"], g["n_steps"]
    t_half = [_bf16(template.float().numpy())]
    if b_lo:
        t_half.append(_bf16(template.float().numpy() - t_half[0]))
    n_b, seg_len = seg.shape
    corr = np.zeros((n_b, g["n_tiles"] * mt * ROW))
    scale = np.zeros((n_b, g["n_tiles"] * mt))
    lane = np.arange(32)
    gq, gi = lane >> 2, lane & 3
    for b in range(n_b):
        for tile in range(g["n_tiles"]):
            base = tile * mt * ROW

            def samples(lo, n):  # seg[b, lo .. lo + n), zero past seg_len
                x = np.zeros(n)
                hi = min(lo + n, seg_len)
                if hi > lo:
                    x[: hi - lo] = seg[b, lo:hi]
                return x

            blk = (samples(base, g["nbe"] * ROW).astype(np.float32).astype(np.float64) ** 2).reshape(-1, ROW).sum(1)
            win = np.array([blk[r : r + g["kb"]].sum() for r in range(mt)])
            scale[b, tile * mt : (tile + 1) * mt] = 1.0 / np.sqrt(te * np.maximum(win, 1e-4 * te))
            ring = np.zeros((2, rr, ROW))  # hi, lo
            held = np.full(rr, -1)  # the span row each slot holds
            buf = np.zeros((2, n_half, 2, ws), np.uint32)  # the two template windows

            def stage_rows(r0, n):
                for r in range(r0, r0 + n):
                    x = samples(base + ROW * r, ROW)
                    ring[0, r % rr] = _bf16(x)
                    ring[1, r % rr] = _bf16(x - ring[0, r % rr])
                    held[r % rr] = r

            def stage_window(st0, nk, q):  # words 8 st0 .. 8 (st0 + nk) + 71, zero past w
                n = 8 * nk + 72
                assert n < ws
                buf[q] = 0
                got = words[:, :, 8 * st0 : min(8 * st0 + n, w)]
                buf[q, :, :, : got.shape[-1]] = got

            nk0 = min(ksl, n_steps)
            stage_window(0, nk0, 0)
            stage_rows(0, mt - 1 + nk0 // 8)
            # per column half, the lane's ring: rh[u] = H(16 s + 8 - 8 u) of the half's first tile
            h_off = [TPL_OFF // 2 + gi - (gq >> 1) - 4 * NTW * h for h in range(NT // NTW)]
            assert min(o.min() for o in h_off) + 4 - 4 * NTW >= 0
            rings = [[buf[0, half, gq & 1, h_off[h] + 4 - 4 * u] for u in range(NTW + 1)]
                     for h in range(NT // NTW) for half in range(n_half)]
            acc = np.zeros((mt, ROW))
            total = np.zeros((mt, ROW))
            for sl, st0 in enumerate(range(0, n_steps, ksl)):
                nk = min(ksl, n_steps - st0)
                nk1 = min(ksl, n_steps - st0 - ksl)
                if nk1 > 0:  # the next slab, staged before this slab's reads are checked
                    stage_window(st0 + ksl, nk1, (sl + 1) & 1)
                    stage_rows((st0 + ksl) // 8 + mt - 1, nk1 // 8)
                for st in range(st0, st0 + nk):
                    slots = (np.arange(mt) + st // 8) % rr
                    np.testing.assert_array_equal(held[slots], np.arange(mt) + st // 8)
                    a = ring[:, slots, 16 * (st % 8) : 16 * (st % 8) + 16]  # [hi/lo, mt, 16]
                    bmat = np.zeros((n_half, 16, ROW))
                    for h in range(NT // NTW):
                        for half in range(n_half):
                            rh = rings[h * n_half + half]
                            for j in range(NTW):  # tile NTW h + j: (rh[j + 1], rh[j])
                                for r, word in enumerate((rh[j + 1], rh[j])):
                                    pair = _decode(word)  # [32, 2]
                                    for e in range(2):
                                        bmat[half, 8 * r + 2 * gi + e, 8 * (NTW * h + j) + gq] = pair[:, e]
                            st_l = st - st0
                            tb = buf[sl & 1, half, gq & 1]
                            rings[h * n_half + half] = [tb[lane, h_off[h] + 8 * st_l + 12],
                                                        tb[lane, h_off[h] + 8 * st_l + 8]] + rh[:-2]
                    p = (16 * st + np.arange(16))[:, None] - np.arange(ROW)[None, :]  # p - n
                    for half in range(n_half):  # the band: t[p - n] for 0 <= p - n < k
                        want = np.where((p >= 0) & (p < k), t_half[half][np.clip(p, 0, k - 1)], 0.0)
                        np.testing.assert_array_equal(bmat[half], want)
                    acc += a[0] @ bmat[0]  # hi * hi, then hi * lo, then lo * hi
                    if b_lo:
                        acc += a[0] @ bmat[1]
                    if a_lo:
                        acc += a[1] @ bmat[0]
                    if st % FOLD == FOLD - 1 or st == n_steps - 1:
                        total += acc
                        acc[:] = 0.0
            corr[b, base : base + mt * ROW] = total.reshape(-1)
    q = np.abs(corr) * np.repeat(scale, ROW, axis=1)
    return corr[:, :out_len], q[:, :out_len]


@pytest.mark.parametrize("k", [15360, 61440])
@pytest.mark.parametrize("pair", ["bf16/bf16", "bf16/f32", "f32/bf16", "f32/f32"])
def test_slab_geometry_fits_shared_memory(pair, k):
    """At sps 480's and sps 1,920's preambles, wherever the one-shot stage
    does not take the template (every pair at 61,440; float32 x float32
    at 15,360 with a block of 96 rows), the slab route does: two slabs or
    more, each a multiple of 8 k-steps, the last one not empty, the
    block's shared memory within 232,448 bytes, the staged words a copy 16
    mod 32 (distinct banks)."""
    a_lo, b_lo = pair.startswith("f32"), pair.endswith("f32")
    assert not one_shot_fits(k, 36352, a_lo, b_lo) or (k == 15360 and pair != "f32/f32")
    for out_len in (4736, 36352, 272640):
        if one_shot_fits(k, out_len, a_lo, b_lo):
            continue
        g = slab_geometry(k, out_len, a_lo, b_lo)
        assert g["smem"] <= MAX_SMEM and g["ksl"] % 8 == 0 and g["ws"] % 32 == 16
        n_slabs = -(-g["n_steps"] // g["ksl"])
        assert n_slabs >= 2 and g["n_steps"] - (n_slabs - 1) * g["ksl"] > 0


@pytest.mark.parametrize("k", [15360, 61440])
@pytest.mark.parametrize("pair", ["bf16/bf16", "bf16/f32", "f32/bf16", "f32/f32"])
def test_slab_blocks_fit_two_a_multiprocessor(pair, k):
    """At sps 480's and sps 1,920's preambles and out_len 4,736, 36,352
    and 272,640 (stream-slow-f32's chunk), wherever the slab route takes
    the template, a block fits half a multiprocessor (115,712 bytes with
    the search's 64 static ones), so two share one, with 64 rows (8 warps,
    two a row group); its ring holds a slab's rows and the next slab's (the rows a
    slab reads and the ones staged under its products never share a
    slot), a multiple of 8 slots; a slab adds at most one 8-sample chunk
    a thread (2 ksl <= the block's threads)."""
    a_lo, b_lo = pair.startswith("f32"), pair.endswith("f32")
    for out_len in (4736, 36352, 272640):
        if one_shot_fits(k, out_len, a_lo, b_lo):
            continue
        g = slab_geometry(k, out_len, a_lo, b_lo)
        assert g["blocks"] == 2 and g["smem"] + 64 <= SLAB_SMEM + 64 == 115712
        assert (g["n_tiles"], g["mt"]) == _split(g["n_rows"], SLAB_ROWS) and g["warps"] == 2 * g["mt"] // 16
        assert g["rr"] % 8 == 0 and g["rr"] >= g["mt"] - 1 + 2 * g["ksl"] // 8
        assert 2 * g["ksl"] <= 32 * g["warps"]


@pytest.mark.parametrize("seg_f32", [False, True])
@pytest.mark.parametrize("tpl_f32", [False, True])
def test_slab_walk_matches_plain_versions(seg_f32, tpl_f32):
    """The slab route transliterated (slabs of at most 16 k-steps, so a
    1,500-sample template's 104 k-steps cross 7 slabs, the last one short,
    and the 24-slot span ring wraps; two warps a row group; 3
    streams, out_len 300 over 3 rows, the energy blocks and span reading
    zeros past the segments' out_len + k - 1 samples) against
    sync_search_fused_ref and correlate_fused_ref: every ring slot read
    holding its row, every B word the banded template's, the best lags
    equal to the plain version's and the planted ones, the qualities
    within rtol 1e-5 (bf16 operands exact; float32 ones as hi + lo, the lo
    x lo product dropped, about 2^-16 of each product), the correlation
    within 1e-5 of its scale."""
    rng = np.random.default_rng(700 + 2 * seg_f32 + tpl_f32)
    k, out_len, b = 1500, 300, 3
    t = rng.standard_normal(k).astype(np.float32)
    seg = rng.standard_normal((b, out_len + k - 1)).astype(np.float32)
    lags = np.array([5, 150, 299])
    for i, lag in enumerate(lags):
        n = min(k, seg.shape[1] - lag)
        seg[i, lag : lag + n] += 2.0 * t[:n]
    tpl = torch.from_numpy(t).to(torch.float32 if tpl_f32 else torch.bfloat16)
    seg_t = torch.from_numpy(seg).to(torch.float32 if seg_f32 else torch.bfloat16)
    seg_np = seg_t.float().numpy().astype(np.float64)
    te = float((tpl.float() ** 2).sum())
    g = slab_geometry(k, out_len, seg_f32, tpl_f32, ksl_max=16)
    assert g["ksl"] == 16 and g["n_steps"] == 104 and g["rr"] == 24 < g["mt"] - 1 + g["n_steps"] // 8
    corr, q = emulate_slabs(seg_np, tpl, out_len, te, seg_f32, ksl_max=16)
    rq, ri = tk.sync_search_fused_ref(seg_t, tpl, out_len, te)
    assert np.array_equal(q.argmax(-1), ri.numpy()) and np.array_equal(ri.numpy(), lags)
    np.testing.assert_allclose(q.max(-1), rq.numpy(), rtol=1e-5)
    want = tk.correlate_fused_ref(seg_t, tpl, out_len).numpy()
    np.testing.assert_allclose(corr, want, rtol=1e-5, atol=1e-5 * np.sqrt((want ** 2).mean()))


def test_search_plain_versions_match_pallas_past_the_limit():
    """sync_search_fused_ref and correlate_fused_ref against the Pallas
    kernels (interpret mode) at a 15,360-sample template (sps 480's
    preamble, past the float32 x float32 one-shot limit of about 14,400),
    float32, B = 2, out_len 256: lags equal (the planted ones), qualities
    within rtol 1e-5, correlations within 1e-5 of their scale sqrt(k)."""
    rng = np.random.default_rng(15360)
    k, out_len, b = 15360, 256, 2
    t = rng.standard_normal(k).astype(np.float32)
    seg = rng.standard_normal((b, out_len + k - 1)).astype(np.float32)
    for i, lag in enumerate((17, 200)):
        seg[i, lag : lag + k] += 0.5 * t
    te = float((t.astype(np.float64) ** 2).sum())
    q, i = tk.sync_search_fused_ref(torch.from_numpy(seg), torch.from_numpy(t), out_len, te)
    jq, ji = jk.sync_search_fused(jnp.asarray(seg), jnp.asarray(t), out_len, te, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), [17, 200])
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5)
    got = tk.correlate_fused_ref(torch.from_numpy(seg), torch.from_numpy(t), out_len).numpy()
    want = np.asarray(jk.correlate_fused(jnp.asarray(seg), jnp.asarray(t), out_len, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.sqrt(k) * 4)
