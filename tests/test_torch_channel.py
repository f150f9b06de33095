"""The channel simulator, anet_torch.channel against anet.channel on the CPU.

The deterministic impairments (multipath, clip, gain, snr_scale, the clock
drift) take the same numpy input in both packages: multipath, clip, gain and
snr_scale agree within 1e-6 relative, sample_rate_drift bit for bit (and
profile_stream.drift_rows, the drift of chip_smoke.py's tracked paths, bit for
bit with it). The random ones draw from a torch.Generator where the reference
draws from jax.random, so they are held to the reference statistically: the
AWGN's noise deviation within 2% of snr_scale at N = 2^16 per stream, a
dropout's drop fraction within 4 sigma of the binomial, whole bursts only."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anet import channel as jch

from anet_torch import channel as tch

CPU = "cpu"


def _x(seed, shape=(3, 4000)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _gen(seed=0):
    return torch.Generator(device=CPU).manual_seed(seed)


@pytest.mark.parametrize("taps", [(1.0, 0.0, 0.0, 0.5), (0.8, -0.3, 0.1), (1.0,)])
def test_multipath_clip_gain_and_snr_scale_match_jax(taps):
    x = _x(1)
    want = np.asarray(jch.multipath(jnp.asarray(x), jnp.asarray(taps)))
    got = tch.multipath(x, taps, device=CPU)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(tch.clip(x, 0.7, device=CPU).numpy(), np.asarray(jch.clip(jnp.asarray(x), 0.7)))
    cfg = tch.ChannelConfig(snr_db=None, gain=0.37)
    jcfg = jch.ChannelConfig(snr_db=None, gain=0.37)
    np.testing.assert_allclose(
        tch.apply_channel(_gen(), x, cfg, device=CPU).numpy(),
        np.asarray(jch.apply_channel(jax.random.PRNGKey(0), jnp.asarray(x), jcfg)), rtol=1e-6,
    )
    power = np.array([0.01, 0.5, 2.0], np.float32)
    snr = np.array([-6.0, 10.0, 31.5], np.float32)
    np.testing.assert_allclose(
        tch.snr_scale(torch.from_numpy(power), torch.from_numpy(snr)).numpy(),
        np.asarray(jch.snr_scale(jnp.asarray(power), jnp.asarray(snr))), rtol=1e-6,
    )
    assert abs(float(tch.snr_scale(0.5, 10.0)) - float(jch.snr_scale(0.5, 10.0))) <= 1e-6 * 0.23


@pytest.mark.parametrize("ppm", [0.0, 37.5, -120.0, 850.25, -1000.0, 2500.0])
def test_sample_rate_drift_bit_equal_to_jax(ppm):
    x = _x(2, (2, 9000))
    want = np.asarray(jch.sample_rate_drift(jnp.asarray(x), ppm))
    got = tch.sample_rate_drift(x, ppm, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    one = tch.sample_rate_drift(x[0], ppm, device=CPU)  # a 1-D capture
    np.testing.assert_array_equal(one.numpy(), want[0])


def test_drift_rows_is_sample_rate_drift_row_by_row():
    """profile_stream.drift_rows (a per-row offset, rows a pass) is the
    channel's sample_rate_drift with a tensor ppm, and each of its rows the
    reference's with that row's float ppm, bit for bit."""
    from anet_torch.profile_stream import drift_rows

    x = _x(3, (5, 6000))
    ppm = np.array([-1000.0, -733.5, 0.0, 701.25, 999.0], np.float32)
    got = drift_rows(torch.from_numpy(x), torch.from_numpy(ppm), rows=2)
    batched = tch.sample_rate_drift(torch.from_numpy(x), torch.from_numpy(ppm), device=CPU)
    assert torch.equal(got, batched)
    for i, p in enumerate(ppm):
        want = np.asarray(jch.sample_rate_drift(jnp.asarray(x[i]), float(p)))
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(snr_db=None, multipath_taps=(1.0, 0.0, 0.5), gain=0.5, drop_rate=0.1, drop_burst_samples=128,
         clip_level=0.9, drift_ppm=-80.0),
    dict(snr_db=3.5, multipath_taps=None, clip_level=None),
])
def test_channel_config_json_both_ways(cfg):
    mine, theirs = tch.ChannelConfig(**cfg), jch.ChannelConfig(**cfg)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.to_json() == theirs.to_json()
    assert tch.ChannelConfig.from_json(theirs.to_json()) == mine
    assert jch.ChannelConfig.from_json(mine.to_json()) == theirs


def test_awgn_noise_std_per_stream():
    """A batched snr_db (one per stream): each stream's added noise has the
    deviation snr_scale gives for its own power, within 2% at N = 2^16, as
    the reference's does."""
    n = 1 << 16
    x = _x(4, (3, n)) * np.array([[0.1], [1.0], [3.0]], np.float32)
    snr = np.array([0.0, 10.0, 25.0], np.float32)
    power = (x * x).mean(-1)
    sigma = np.sqrt(power / 10 ** (snr / 10))
    got = tch.awgn(_gen(4), x, torch.from_numpy(snr), device=CPU).numpy() - x
    want = np.asarray(jch.awgn(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(snr))) - x
    for noise in (got, want):
        np.testing.assert_allclose(noise.std(-1), sigma, rtol=0.02)
        assert np.abs(noise.mean(-1)).max() < 0.02 * sigma.max()
    scalar = tch.awgn(_gen(5), x[1], 10.0, device=CPU).numpy() - x[1]
    assert abs(scalar.std() / sigma[1] - 1) < 0.02


def test_dropout_zeros_whole_bursts_at_the_rate():
    """Every dropped sample lies in a burst zeroed whole, the rest pass
    unchanged, and the fraction of dropped bursts lies within 4 sigma of the
    binomial (the reference's within the same band)."""
    burst, rate = 64, 0.2
    x = _x(6, (4, 64 * 1000 + 17)) + 5.0  # no sample is 0 by chance
    got = tch.dropout(_gen(6), x, rate, burst, device=CPU).numpy()
    want = np.asarray(jch.dropout(jax.random.PRNGKey(6), jnp.asarray(x), rate, burst))
    n_blocks = -(-x.shape[-1] // burst)
    sd = np.sqrt(rate * (1 - rate) / (x.shape[0] * n_blocks))
    for out in (got, want):
        pad = np.pad(out, ((0, 0), (0, n_blocks * burst - x.shape[-1])), constant_values=np.nan)
        blocks = pad.reshape(x.shape[0], n_blocks, burst)
        valid = ~np.isnan(blocks)
        dropped = ((blocks == 0) | ~valid).all(-1)
        kept = np.where(valid, blocks, 1.0) != 0
        assert (dropped | kept.all(-1)).all()  # whole bursts only
        np.testing.assert_array_equal(out[out != 0], x[out != 0])
        assert abs(dropped.mean() - rate) < 4 * sd


def test_apply_channel_without_randomness_matches_jax():
    """Noise and dropout off: drift, multipath, gain and clip in the
    reference's order, within 1e-6 of it."""
    x = _x(7, (2, 5000))
    kw = dict(snr_db=None, multipath_taps=(1.0, 0.0, 0.0, 0.5), gain=1.7, drop_rate=0.0, clip_level=1.2,
              drift_ppm=300.0)
    got = tch.apply_channel(_gen(), x, tch.ChannelConfig(**kw), device=CPU)
    want = np.asarray(jch.apply_channel(jax.random.PRNGKey(0), jnp.asarray(x), jch.ChannelConfig(**kw)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert float(got.abs().max()) == float(np.float32(1.2))  # clipped


def test_apply_channel_seeds_and_order():
    """The same generator seed gives the same output; the chain draws the
    dropout mask, then the noise, from one generator (the reference splits
    one key the same way); snr_db overrides config.snr_db."""
    x = _x(8, (2, 3000))
    cfg = tch.ChannelConfig(snr_db=8.0, multipath_taps=(1.0, 0.3), drop_rate=0.25, drop_burst_samples=100)
    a = tch.apply_channel(_gen(9), x, cfg, device=CPU)
    assert torch.equal(a, tch.apply_channel(_gen(9), x, cfg, device=CPU))
    assert not torch.equal(a, tch.apply_channel(_gen(10), x, cfg, device=CPU))
    g = _gen(9)
    y = tch.multipath(x, cfg.multipath_taps, device=CPU)
    y = tch.dropout(g, y, cfg.drop_rate, cfg.drop_burst_samples, device=CPU)
    assert torch.equal(a, tch.awgn(g, y, cfg.snr_db, device=CPU))
    b = tch.apply_channel(_gen(9), x, cfg, snr_db=torch.tensor([8.0, 30.0]), device=CPU)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1])
