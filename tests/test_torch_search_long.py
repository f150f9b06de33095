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


def one_shot_fits(k: int, out_len: int, a_lo: bool, b_lo: bool) -> bool:
    """search_core.cuh's make_geometry: the whole template and span staged."""
    g = slab_geometry(k, out_len, a_lo, b_lo)
    mt, nks = g["mt"], g["nks"]
    nb = max(mt - 1 + (16 * nks + ROW - 1) // ROW, g["nbe"])
    w = 8 * nks + 72
    w += (16 - w) % 32
    return (2 if b_lo else 1) * 2 * w * 4 + (2 if a_lo else 1) * nb * PITCH * 2 + (nb + mt) * 4 <= MAX_SMEM


def slab_geometry(k: int, out_len: int, a_lo: bool, b_lo: bool, ksl_max: int | None = None) -> dict:
    """search_core.cuh's make_slab_geometry: the one-shot row split, then a
    slab of the most k-steps (a multiple of 8) that keeps the block's
    shared memory within MAX_SMEM (or ksl_max), evened out."""
    n_rows = -(-out_len // ROW)
    max_rows = 96 if a_lo or b_lo else 128
    n_tiles = -(-n_rows // max_rows)
    mt = -(-(-(-n_rows // n_tiles)) // 16) * 16
    nks = (k + ROW - 1 + 15) // 16
    kb = (k + ROW - 1) // ROW + 1
    nbe = mt + kb - 1

    def smem(ksl):
        return ((2 if b_lo else 1) * 2 * (8 * ksl + 80) * 4 + (2 if a_lo else 1) * (mt - 1 + ksl // 8) * PITCH * 2
                + (nbe + mt) * 4)

    ksl = -(-nks // 8) * 8
    while ksl > 8 and (smem(ksl) > MAX_SMEM or (ksl_max is not None and ksl > ksl_max)):
        ksl -= 8
    n_slabs = -(-nks // ksl)
    ksl = -(-(-(-nks // n_slabs)) // 8) * 8
    return dict(mt=mt, n_tiles=n_tiles, n_rows=n_rows, nks=nks, kb=kb, nbe=nbe, ksl=ksl, ws=8 * ksl + 80,
                smem=smem(ksl))


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
    row; per slab the staged template words and span, the B operand read
    at product_slab's indices (and checked against the banded template),
    the hi (+ lo) products."""
    words = tk._search_template_words(template).numpy().view(np.uint32)  # [P, 2, w]
    k = template.shape[-1]
    b_lo = words.shape[0] == 2
    g = slab_geometry(k, out_len, a_lo, b_lo, ksl_max)
    mt, ksl, nks = g["mt"], g["ksl"], g["nks"]
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
            acc = np.zeros((mt, ROW))
            for st0 in range(0, nks, ksl):
                nk = min(ksl, nks - st0)
                staged = words[:, :, 8 * st0 : 8 * st0 + 8 * nk + 72]  # stage_slab's window of each copy
                assert staged.shape[-1] == 8 * nk + 72 <= g["ws"]
                # B [16 nk, 128] read at product_slab's indices: b0 = tb[8 st - 4 j], b1 = tb[8 st + 4 - 4 j]
                bmat = [np.zeros((16 * nk, ROW)) for _ in range(words.shape[0])]
                for st in range(nk):
                    for j in range(ROW // 8):
                        w0 = TPL_OFF // 2 + gi - (gq >> 1) + 8 * st - 4 * j
                        assert w0.min() >= 0 and w0.max() + 4 < staged.shape[-1]
                        for half in range(words.shape[0]):
                            for r, wi in enumerate((w0, w0 + 4)):
                                pair = _decode(staged[half, gq & 1, wi])  # [32, 2]
                                for e in range(2):
                                    bmat[half][16 * st + 8 * r + 2 * gi + e, 8 * j + gq] = pair[:, e]
                p = (16 * st0 + np.arange(16 * nk))[:, None] - np.arange(ROW)[None, :]  # p - n
                for half in range(words.shape[0]):  # the band: t[p - n] for 0 <= p - n < k
                    want = np.where((p >= 0) & (p < k), t_half[half][np.clip(p, 0, k - 1)], 0.0)
                    np.testing.assert_array_equal(bmat[half], want)
                span = samples(base + 16 * st0, (mt - 1 + -(-nk // 8)) * ROW)
                hi = _bf16(span)
                rows = np.stack([hi[r * ROW : r * ROW + 16 * nk] for r in range(mt)])
                acc += rows @ bmat[0]
                if b_lo:
                    acc += rows @ bmat[1]
                if a_lo:
                    lo = _bf16(span - hi)
                    acc += np.stack([lo[r * ROW : r * ROW + 16 * nk] for r in range(mt)]) @ bmat[0]
            corr[b, base : base + mt * ROW] = acc.reshape(-1)
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
        n_slabs = -(-g["nks"] // g["ksl"])
        assert n_slabs >= 2 and g["nks"] - (n_slabs - 1) * g["ksl"] > 0


@pytest.mark.parametrize("seg_f32", [False, True])
@pytest.mark.parametrize("tpl_f32", [False, True])
def test_slab_walk_matches_plain_versions(seg_f32, tpl_f32):
    """The slab route transliterated (slabs of 8 k-steps, so a 700-sample
    template crosses 7 and the last is short; 3 streams, out_len 300 over
    3 rows, the energy blocks and span reading zeros past the segments'
    out_len + k - 1 samples) against sync_search_fused_ref and
    correlate_fused_ref: every
    staged B word the banded template's, the best lags equal to the plain
    version's and the planted ones, the qualities within rtol 1e-5 (bf16
    operands exact; float32 ones as hi + lo, the lo x lo product dropped,
    about 2^-16 of each product), the correlation within 1e-5 of its
    scale."""
    rng = np.random.default_rng(700 + 2 * seg_f32 + tpl_f32)
    k, out_len, b = 700, 300, 3
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
    corr, q = emulate_slabs(seg_np, tpl, out_len, te, seg_f32, ksl_max=8)
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
