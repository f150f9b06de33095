"""End-to-end frame pipeline (mirrors ``anet.dsp.pipeline``): ``transmit``
turns payload bytes into frame waveforms. The one-shot receivers
(``receive_frame`` and its tracked and dynamic forms) arrive with later
slices of the port; the aligned and streaming receivers are in
``anet_torch.dsp.frame`` and ``anet_torch.stream``."""

from __future__ import annotations

import torch

from anet_torch.dsp.frame import modulate_frame
from anet_torch.dsp.params import ModemConfig


def transmit(
    config: ModemConfig, payload, dtype=torch.float32, device="cuda"
) -> torch.Tensor:
    """payload uint8[..., N] -> waveform float[..., frame_num_samples] on
    ``device``."""
    return modulate_frame(config, payload, dtype=dtype, device=device)
