"""Modulation-family dispatch (mirrors ``anet.dsp.family``): one place that
knows MFSK (ModemConfig) from OFDM (OfdmConfig). A config of neither family
raises."""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from anet_torch.dsp.params import ModemConfig


def is_ofdm(config) -> bool:
    """True for an OfdmConfig, False for a ModemConfig; anything else
    raises NotImplementedError."""
    from anet_torch.dsp.ofdm import OfdmConfig

    if isinstance(config, OfdmConfig):
        return True
    if not isinstance(config, ModemConfig):
        raise NotImplementedError(
            f"{type(config).__name__}: not a config of a ported family "
            "(ModemConfig for MFSK, OfdmConfig for OFDM)"
        )
    return False


def transmit_fn(config, device="cuda") -> Callable:
    """payload uint8[..., N] -> frame waveforms on ``device``."""
    if is_ofdm(config):
        from anet_torch.dsp import ofdm

        return lambda p: ofdm.transmit(config, p, device=device)
    from anet_torch.dsp.pipeline import transmit

    return lambda p: transmit(config, p, device=device)


def aligned_demod_fn(config, payload_len: int, compute_dtype=torch.float32, device="cuda") -> Callable:
    """Symbol-aligned batch-major frame waveform -> FrameResult. OFDM
    widens its samples to float32 whatever ``compute_dtype``, as the
    reference does."""
    if is_ofdm(config):
        from anet_torch.dsp import ofdm

        return lambda w: ofdm.demodulate_frame(config, w, payload_len, device=device)
    from anet_torch.dsp.frame import demodulate_frame

    return lambda w: demodulate_frame(
        config, w, payload_len, compute_dtype=compute_dtype, device=device
    )


def aligned_demod_dynamic_fn(
    config, max_payload_len: int, compute_dtype=torch.float32, device="cuda"
) -> Callable:
    """Symbol-aligned max-length window -> DynamicFrameResult (payload
    length read from the frame header)."""
    if is_ofdm(config):
        from anet_torch.dsp import ofdm

        return lambda w: ofdm.demodulate_frame_dynamic(config, w, max_payload_len, device=device)
    from anet_torch.dsp.frame import demodulate_frame_dynamic

    return lambda w: demodulate_frame_dynamic(
        config, w, max_payload_len, compute_dtype=compute_dtype, device=device
    )


def frame_samples(config, payload_len: int) -> int:
    if is_ofdm(config):
        return config.frame_num_samples(payload_len)
    from anet_torch.dsp.frame import frame_num_samples

    return frame_num_samples(config, payload_len)


def waveform_snr_db(config, snr_db):
    """A demodulator's SNR estimate on the waveform-scale AWGN dB of
    anet_torch.channel.awgn and models.OPERATING_SNR_DB, so either family's
    estimate feeds models.suggest_model. MFSK's FrameResult.snr_db is the
    in-bin SNR, which holds the filterbank's coherent processing gain of
    10 log10(sps / 2) dB: that is taken off. OFDM's EVM-based estimate is
    waveform-scale already and passes through. ``snr_db`` is a float or a
    tensor."""
    if is_ofdm(config):
        return snr_db
    return snr_db - 10.0 * math.log10(config.samples_per_symbol / 2.0)


def preamble_template(config, device="cuda") -> torch.Tensor:
    if is_ofdm(config):
        from anet_torch.dsp import ofdm

        return ofdm.preamble_waveform(config, device=device)
    from anet_torch.dsp.sync import preamble_waveform

    return preamble_waveform(config, device=device).float()


def geometry(
    config, payload_len: int, compute_dtype=torch.float32, device="cuda"
) -> Tuple[int, torch.Tensor, Callable]:
    """(frame_samples, preamble_template, aligned_demod_fn) in one call."""
    return (
        frame_samples(config, payload_len),
        preamble_template(config, device),
        aligned_demod_fn(config, payload_len, compute_dtype, device),
    )
