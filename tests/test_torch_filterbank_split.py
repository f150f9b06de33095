"""The batch-major filterbank's float32-compute route on the tensor cores
(csrc/demod_core.cuh's SplitTerms): the float32 basis as three bf16 terms,
float32 rows split into three bf16 terms on load, six of the nine products
kept, the largest in an accumulator of its own. The kernel runs only on the
card, so these tests hold its operand (kernels._demod_split_basis) and a
plain-torch emulation of its arithmetic against the plain version
(tone_energies_fused_ref) and the Pallas kernel, with the stated tolerance
(kernels.F32_SPLIT_RTOL, F32_SPLIT_ATOL). The card's own comparison:
test_torch_kernels_cuda.py -k split."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anet.kernels as jk
from anet.models import get_model as jget_model

from anet_torch import kernels as tk
from anet_torch.dsp.mod import synthesize_tones
from anet_torch.models import get_model

# every MFSK preset the tensor cores take: sps 32, 64 or 128, at most 16 tones
FAST_PRESETS = ("fsk2-robust", "mfsk16-fast", "mfsk16-ultra", "mfsk4-coded", "mfsk4-coded-stream", "mfsk4-voice")
CPU = torch.device("cpu")


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """The [sps, 8 n] matrix that bf16 B fragments [ks, n, 2, 32] hold:
    register r of lane (g, i) at k-step s and n8 tile t holds rows 16 s +
    8 r + 2 i + (0, 1), column 8 t + g, the first in the word's low half."""
    ks, n = words.shape[:2]
    e = words.reshape(ks, n, 2, 8, 4).contiguous().view(torch.bfloat16).reshape(ks, n, 2, 8, 4, 2).float()
    return e.permute(0, 2, 4, 5, 1, 3).reshape(ks * 16, n * 8)


def _interleaved(cfg, b: torch.Tensor) -> torch.Tensor:
    """[sps, 2M] (cos columns, then sin) as the fragments' [sps, 8 n]
    columns: 2c the cos of tone c, 2c + 1 its sin, zeros past the tones."""
    m = cfg.num_tones
    out = torch.zeros(cfg.samples_per_symbol, 8 * tk._demod_mma_tiles(m))
    out[:, 0 : 2 * m : 2], out[:, 1 : 2 * m : 2] = b[:, :m], b[:, m:]
    return out


def emulate_iq(cfg, rows: torch.Tensor, basis_terms: int = 3) -> torch.Tensor:
    """I/Q [R, S, 2M] (cos columns, then sin) of the kernel's arithmetic on
    rows [R, >= S * sps] of float32 or bf16 samples: the float32 basis as
    ``basis_terms`` bf16 terms; bf16 rows as they are, float32 rows split
    into three bf16 terms; of the products a_i b_j those with i + j <= 2,
    a0 b0 in one float32 accumulator and the rest in another, smallest
    first, each m16n8k16 k-step (16 samples) added to its accumulator with
    one rounding (its 16 products are exact in float32 and summed here in
    float64); I/Q = big + small."""
    sps = cfg.samples_per_symbol
    r, s = rows.shape[0], rows.shape[-1] // sps
    x = rows[:, : s * sps].float().reshape(r * s, sps)
    b = tk._split_terms(tk._plain_basis(cfg, torch.float32, CPU), basis_terms)
    a = tk._split_terms(x) if rows.dtype == torch.float32 else [x]
    small = sorted(((i, j) for i in range(len(a)) for j in range(len(b)) if 0 < i + j <= 2),
                   key=lambda ij: -sum(ij))
    acc_big = torch.zeros(r * s, 2 * cfg.num_tones)
    acc_small = torch.zeros_like(acc_big)
    for k in range(0, sps, 16):
        ks = slice(k, k + 16)
        for i, j in small:
            acc_small = (acc_small.double() + a[i][:, ks].double() @ b[j][ks].double()).float()
        acc_big = (acc_big.double() + a[0][:, ks].double() @ b[0][ks].double()).float()
    return (acc_big + acc_small).reshape(r, s, -1)


def emulate_energies(cfg, rows: torch.Tensor) -> torch.Tensor:
    """Energies [R, S, M] of emulate_iq: I*I + Q*Q, a rounding after each."""
    iq = emulate_iq(cfg, rows)
    i, q = iq[..., : cfg.num_tones], iq[..., cfg.num_tones :]
    return i * i + q * q


def _bound(want: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The stated tolerance of the float32-compute route: F32_SPLIT_RTOL of
    the plain value plus F32_SPLIT_ATOL of its symbol's largest energy."""
    return tk.F32_SPLIT_RTOL * want.abs() + tk.F32_SPLIT_ATOL * scale


def _frames(cfg, rows_dtype, seed: int, r: int = 6, s: int = 37) -> torch.Tensor:
    """[r, s * sps] symbols of random tones at noise 0.5, then rounded to
    ``rows_dtype``."""
    rng = np.random.default_rng(seed)
    tones = torch.from_numpy(rng.integers(0, cfg.num_tones, (r, s))).int()
    x = synthesize_tones(cfg, tones)
    x = x + 0.5 * torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    return x.to(rows_dtype)


@pytest.mark.parametrize("name", FAST_PRESETS)
def test_split_terms_sum_to_the_float32_basis(name):
    """The three bf16 terms of the float32 basis (the CUDA-core kernels'
    entries) sum to it exactly in float64, each term is exact in bf16, and
    no term is larger than the one before it; the same split of float32
    samples (the kernel's A operand) sums to them exactly too."""
    cfg = get_model(name).config
    b = tk._plain_basis(cfg, torch.float32, CPU)
    terms = tk._split_terms(b)
    assert torch.equal(terms[0] + terms[1] + terms[2], b)
    assert torch.equal(sum(t.double() for t in terms), b.double())
    for hi, lo in zip(terms, terms[1:]):
        assert bool((lo.abs() <= hi.abs() * 2.0**-8).all())
    assert all(torch.equal(t.to(torch.bfloat16).float(), t) for t in terms)
    assert terms[2].abs().max() > 0  # the third term carries bits
    x = _frames(cfg, torch.float32, len(name))
    assert torch.equal(sum(t.double() for t in tk._split_terms(x)), x.double())


@pytest.mark.parametrize("name", FAST_PRESETS)
def test_split_basis_unpacks_to_the_terms(name):
    """The packed operand, int32 [3, ks, n, 2, 32], once a config and
    device, unpacks (as the kernel's fragments read it) to the [sps, 8 n]
    matrix of each term; its first term is the bf16 route's operand (the
    bf16 basis is the float32 one rounded to nearest)."""
    cfg = get_model(name).config
    sps, n = cfg.samples_per_symbol, tk._demod_mma_tiles(cfg.num_tones)
    words = tk._demod_split_basis(cfg, CPU)
    assert words is tk._demod_split_basis(cfg, CPU)
    assert words.dtype == torch.int32 and words.shape == (3, sps // 16, n, 2, 32)
    terms = tk._split_terms(tk._plain_basis(cfg, torch.float32, CPU))
    for w, t in zip(words, terms):
        assert torch.equal(_unpack(w), _interleaved(cfg, t))
    assert torch.equal(sum(_unpack(w).double() for w in words),
                       _interleaved(cfg, tk._plain_basis(cfg, torch.float32, CPU)).double())
    assert torch.equal(words[0], tk._demod_mma_basis(cfg, torch.bfloat16, CPU))


@pytest.mark.parametrize("rows", ["float32", "bf16"])
@pytest.mark.parametrize("name", ["mfsk16-fast", "mfsk16-ultra", "mfsk4-coded", "fsk2-robust"])
def test_emulated_split_within_tolerance_of_the_plain_version(name, rows):
    """The emulated kernel arithmetic on seeded rows against the plain
    version under float32 compute: every energy within the stated
    tolerance; tones equal but where the plain version's two largest
    energies lie within it (counted); best and total within the same
    bounds."""
    cfg = get_model(name).config
    rdt = {"float32": torch.float32, "bf16": torch.bfloat16}[rows]
    x = _frames(cfg, rdt, len(name) + len(rows))
    got = emulate_energies(cfg, x)
    want = tk.tone_energies_fused_ref(cfg, x, compute_dtype=torch.float32)
    scale = want.amax(-1, keepdim=True)
    assert bool(((got - want).abs() <= _bound(want, scale)).all())
    top2 = want.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= _bound(top2[..., 0], top2[..., 0])
    tone_w, best_w, total_w = tk.decide_tones_fused_ref(cfg, x, compute_dtype=torch.float32)
    tone_g = got.argmax(-1).int()
    assert bool(((tone_g == tone_w) | near).all())
    assert int(near.sum()) < tone_w.numel() // 100  # ties are rare at this noise
    smax = scale[..., 0]
    assert bool(((got.amax(-1) - best_w).abs() <= _bound(best_w, smax)).all())
    assert bool(((got.sum(-1) - total_w).abs() <= _bound(total_w, smax)).all())


@pytest.mark.parametrize("rows", ["float32", "bf16"])
def test_emulated_split_within_tolerance_of_pallas(rows):
    """The same emulation against anet's batch-major Pallas kernel
    (interpret mode, float32 compute) on the same mfsk16-fast rows: every
    energy within the stated tolerance, the winning tones equal."""
    name = "mfsk16-fast"
    cfg, jcfg = get_model(name).config, jget_model(name).config
    rdt = {"float32": torch.float32, "bf16": torch.bfloat16}[rows]
    x = _frames(cfg, rdt, 7, r=2, s=21)
    got = emulate_energies(cfg, x)
    want = torch.from_numpy(np.array(jk.tone_energies_fused(
        jcfg, jnp.asarray(x.float().numpy()), compute_dtype=jnp.float32, interpret=True)))
    assert bool(((got - want).abs() <= _bound(want, want.amax(-1, keepdim=True))).all())
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("basis_terms,holds", [(3, True), (2, False)])
def test_weak_tone_needs_three_basis_terms(basis_terms, holds):
    """The trap a two-term basis falls into: a weak tone 2^-16 below a
    strong one (float32 rows, mfsk16-fast) loses its I/Q, since b0 + b1
    leaves about 2^-17 of each basis entry, which the strong tone carries
    into every column. The energy tolerance cannot see it (the weak
    energy is 2^-32 of the largest), so this holds each weak tone's I and
    Q to the float64 product within 2^-8 of its own magnitude: over 64
    seeded (strong, weak, phases) draws three terms do, two do not."""
    cfg = get_model("mfsk16-fast").config
    m = cfg.num_tones
    rng = np.random.default_rng(16)
    b = tk._plain_basis(cfg, torch.float32, CPU).double()
    worst = 0.0
    for _ in range(64):
        c, d = rng.choice(m, 2, replace=False)
        p, q = rng.uniform(0.0, 2 * np.pi, 2)
        x = b[:, c] * np.cos(p) + b[:, m + c] * np.sin(p)
        x = x + 2.0**-16 * (b[:, d] * np.cos(q) + b[:, m + d] * np.sin(q))
        x = x.float()[None]
        iq = emulate_iq(cfg, x, basis_terms)[0, 0].double()
        exact = x[0].double() @ b
        err = torch.stack([iq[d] - exact[d], iq[m + d] - exact[m + d]]).abs().max()
        worst = max(worst, float(err / torch.hypot(exact[d], exact[m + d])))
    assert (worst <= 2.0**-8) == holds, worst


@pytest.mark.parametrize("name", tk.F32_ROUTES)
def test_float32_launches_count_apart(monkeypatch, name):
    """A launch of a kernel's float32 route counts under "<name>:f32" (the
    batch-major filterbank's by its compute dtype), its bf16 launches under
    the name, int8 ones under "<name>:int8" where the kernel has them;
    kernels without a float32 route of their own count float32 launches
    under the name."""
    monkeypatch.setattr(tk, "launch_counts", dict.fromkeys(tk.launch_counts, 0))
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        if dtype != torch.int8 or f"{name}:int8" in tk.launch_counts:
            tk._count_launch(name, dtype)
    tk._count_launch("gather_rows_fused", torch.float32)
    want = {f"{name}:f32": 1, name: 1, "gather_rows_fused": 1}
    if f"{name}:int8" in tk.launch_counts:
        want[f"{name}:int8"] = 1
    assert {k: v for k, v in tk.launch_counts.items() if v} == want
