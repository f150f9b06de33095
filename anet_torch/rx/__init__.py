"""Receiver runtime: module fabric, playback pipeline, assembled receiver."""

from anet_torch.rx.runtime import Module, PanicError, ReceiverRuntime
from anet_torch.rx.playback import PacedSink, PlaybackPipeline, PlaybackSink, BufferSink, WavSink

__all__ = [
    "BufferSink",
    "PacedSink",
    "Module",
    "PanicError",
    "PlaybackPipeline",
    "PlaybackSink",
    "ReceiverRuntime",
    "WavSink",
]
