"""The coded part of anet_torch.dsp.fec and bit_llrs against the JAX package
on the CPU: the same numpy inputs, made from a seed, go through both. The
encoder, the interleaver pair and the decoded bits must be bit-equal; the
LLRs agree within 1e-6. The decoders are held against JAX's jnp scan and
against its Pallas trellis kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anet.dsp import demod as jdemod
from anet.dsp import fec as jfec
from anet.models import get_model as jget_model

from anet_torch.dsp import demod as tdemod
from anet_torch.dsp import fec as tfec
from anet_torch.models import get_model


def test_conv_tables_and_constants_match():
    for name in ("CONV_K", "CONV_POLY1", "CONV_POLY2", "CONV_STATES", "CONV_TAIL_BITS"):
        assert getattr(tfec, name) == getattr(jfec, name), name
    for got, want in zip(tfec._conv_tables(), jfec._conv_tables()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfec._branch_signs(), jfec._branch_signs())
    for n in (0, 1, 96, 2144):
        assert tfec.conv_encoded_bits(n) == jfec.conv_encoded_bits(n)


@pytest.mark.parametrize("shape", [(1, 1), (5, 96), (2, 3, 201), (4, 2144)])
def test_conv_encode_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    bits = rng.integers(0, 2, shape, dtype=np.uint8)
    got = tfec.conv_encode(torch.from_numpy(bits))
    want = jfec.conv_encode(jnp.asarray(bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("depth", [0, 1, 24, 7])  # 7 does not divide 4300
@pytest.mark.parametrize("n", [4300, 24, 5])
def test_interleave_pair_matches_jax(depth, n):
    rng = np.random.default_rng(depth * 10007 + n)
    bits = rng.integers(0, 2, (3, n), dtype=np.uint8)
    got = tfec.interleave(torch.from_numpy(bits), depth)
    want = jfec.interleave(jnp.asarray(bits), depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape[-1] == tfec.interleaved_bits(n, depth) == jfec.interleaved_bits(n, depth)
    # the inverse alone, on float soft values, against JAX's inverse
    soft = rng.standard_normal((3, got.shape[-1])).astype(np.float32)
    back = tfec.deinterleave(torch.from_numpy(soft), depth, n)
    jback = jfec.deinterleave(jnp.asarray(soft), depth, n)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    np.testing.assert_array_equal(tfec.deinterleave(got, depth, n).numpy(), bits)


@pytest.mark.parametrize("name", ["mfsk4-coded", "mfsk16-fast"])  # M = 4 and 16
def test_bit_llrs_match_jax(name):
    cfg, jcfg = get_model(name).config, jget_model(name).config
    rng = np.random.default_rng(cfg.num_tones)
    e = rng.random((3, 50, cfg.num_tones)).astype(np.float32) * 40.0
    e[0, 0] = 1.0  # every tone tied
    got = tdemod.bit_llrs(cfg, torch.from_numpy(e))
    want = jdemod.bit_llrs(jcfg, jnp.asarray(e))
    assert got.dtype == torch.float32 and got.shape == (3, 50 * cfg.bits_per_symbol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # a transposed (non-contiguous) view gives the same values
    got_t = tdemod.bit_llrs(cfg, torch.from_numpy(np.ascontiguousarray(e.transpose(1, 2, 0))).permute(2, 0, 1))
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


def _llr_cases():
    """(label, batch, data bits, noise): clean, noisy, past the code's
    strength (near-ties decide), odd batch sizes."""
    return [
        ("clean", 1, 17, 0.0),
        ("noisy", 5, 96, 0.3),
        ("noisier", 3, 201, 0.5),
        ("broken", 7, 130, 1.5),
        ("frame", 2, 2144, 0.6),
    ]


@pytest.mark.parametrize("label,b,nbits,noise", _llr_cases())
def test_viterbi_soft_matches_jax_scan_and_pallas(label, b, nbits, noise):
    rng = np.random.default_rng(nbits)
    data = rng.integers(0, 2, (b, nbits), dtype=np.uint8)
    coded = np.asarray(jfec.conv_encode(jnp.asarray(data)))
    llrs = (coded * 2.0 - 1.0 + rng.normal(0, noise, coded.shape)).astype(np.float32)
    got = tfec.viterbi_decode_soft(torch.from_numpy(llrs), nbits)
    assert got.dtype == torch.uint8 and got.shape == (b, nbits)
    scan = jfec.viterbi_decode_soft(jnp.asarray(llrs), nbits, use_pallas=False)
    pallas = jfec.viterbi_decode_soft(jnp.asarray(llrs), nbits, use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(scan))
    if label != "broken":
        np.testing.assert_array_equal(got.numpy(), data)


@pytest.mark.parametrize("b,nbits", [(1, 17), (3, 96), (5, 201)])
def test_viterbi_hard_matches_jax(b, nbits):
    rng = np.random.default_rng(b)
    data = rng.integers(0, 2, (b, nbits), dtype=np.uint8)
    coded = np.array(jfec.conv_encode(jnp.asarray(data)))
    coded[:, 10] ^= 1  # one channel error, corrected
    got = tfec.viterbi_decode(torch.from_numpy(coded), nbits)
    scan = jfec.viterbi_decode(jnp.asarray(coded), nbits, use_pallas=False)
    pallas = jfec.viterbi_decode(jnp.asarray(coded), nbits, use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(scan))
    np.testing.assert_array_equal(got.numpy(), data)


@pytest.mark.parametrize("kind", ["zeros", "hard_flips", "coarse"])
def test_viterbi_ties_match_jax(kind):
    """All-zero LLRs tie every compare (ties keep j = 0, so the all-zero
    path survives); hard +-1 inputs with flipped bits and coarsely
    quantized LLRs tie many. The decoded bits equal JAX's in both forms."""
    rng = np.random.default_rng(len(kind))
    nbits, b = 64, 3
    n_coded = jfec.conv_encoded_bits(nbits)
    if kind == "zeros":
        llrs = np.zeros((b, n_coded), np.float32)
    else:
        data = rng.integers(0, 2, (b, nbits), dtype=np.uint8)
        llrs = np.asarray(jfec.conv_encode(jnp.asarray(data))) * 2.0 - 1.0
        if kind == "hard_flips":
            llrs[rng.random(llrs.shape) < 0.15] *= -1.0
        else:
            llrs = np.round(llrs + rng.normal(0, 1.0, llrs.shape))
        llrs = llrs.astype(np.float32)
    got = tfec.viterbi_decode_soft(torch.from_numpy(llrs), nbits)
    scan = jfec.viterbi_decode_soft(jnp.asarray(llrs), nbits, use_pallas=False)
    pallas = jfec.viterbi_decode_soft(jnp.asarray(llrs), nbits, use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(scan))
    if kind == "zeros":
        assert not got.any()


def test_viterbi_takes_leading_batch_axes():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 2, (2, 3, 40), dtype=np.uint8)
    coded = tfec.conv_encode(torch.from_numpy(data))
    assert coded.shape == (2, 3, 92)
    got = tfec.viterbi_decode(coded, 40)
    np.testing.assert_array_equal(got.numpy(), data)


# --- crc32_device(length=): the per-message-length CRC without a scan ---------


@pytest.mark.parametrize("n", [0, 1, 7, 48, 256])
def test_masked_crc_matches_host_for_every_length(n):
    """crc32_device(data, length=p) is zlib's CRC-32 over exactly the first p
    bytes, for every p in 0..n, and equals the JAX package's masked scan;
    lengths outside 0..n clip as the scan's mask does."""
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (n + 3, n), dtype=np.uint8)
    lens = np.concatenate([np.arange(n + 1), [-2, n + 5]]).astype(np.int32)
    got = tfec.crc32_device(torch.from_numpy(data), length=torch.from_numpy(lens))
    assert got.dtype == torch.int64 and got.shape == (n + 3,)
    want = [tfec.crc32_host(data[i, : int(np.clip(p, 0, n))].tobytes()) for i, p in enumerate(lens)]
    np.testing.assert_array_equal(got.numpy(), want)
    scan = jfec.crc32_device(jnp.asarray(data), length=jnp.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(scan).astype(np.int64))


def test_masked_crc_ignores_the_padding_and_takes_batch_shapes():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (2, 3, 40), dtype=np.uint8)
    lens = rng.integers(0, 41, (2, 3)).astype(np.int64)
    got = tfec.crc32_device(torch.from_numpy(data), length=torch.from_numpy(lens))
    noisy = data.copy()
    for i in range(2):
        for j in range(3):
            noisy[i, j, lens[i, j] :] ^= 0xA5
    again = tfec.crc32_device(torch.from_numpy(noisy), length=torch.from_numpy(lens))
    assert torch.equal(got, again)
    full = tfec.crc32_device(torch.from_numpy(data), length=torch.full((2, 3), 40))
    assert torch.equal(full, tfec.crc32_device(torch.from_numpy(data)))
