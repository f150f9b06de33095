"""Transmitter: session orchestration, pacing, audio ingest."""

from anet_torch.tx.session import MulticastAudioOutput, MulticastOutputStream, ReceiverStats
from anet_torch.tx.audio import (
    convert,
    normalize_for_opus,
    pcm_bytes,
    read_audio,
    read_aiff,
    read_au,
    read_wav,
    resample_sinc,
)

__all__ = [
    "MulticastAudioOutput",
    "MulticastOutputStream",
    "ReceiverStats",
    "convert",
    "normalize_for_opus",
    "pcm_bytes",
    "read_audio",
    "read_aiff",
    "read_au",
    "read_wav",
    "resample_sinc",
]
