"""anet_torch: the modem data plane of ``anet`` in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``).

The JAX package ``anet`` is the reference; this package imports nothing of
it (it keeps its own copies of the jax-free modules it needs) and mirrors its
module paths and function names, so ``anet.dsp.frame.demodulate_frame_tm``
is ``anet_torch.dsp.frame.demodulate_frame_tm`` here.

Covered so far, for the MFSK and the OFDM family: transmit, the aligned
receivers, the one-shot receivers, and the streaming receivers with fixed
and header-declared frame lengths (always-search and frame-lock), uncoded
and coded (``fec="conv"``: convolutional code, interleaver, soft Viterbi);
the channel simulator and the model helpers; the scale-out layer
(``anet_torch.parallel``: meshes of positions, sharded demod, BER sweeps,
time-sharded receivers); the host edge (``proto``, ``codec``, ``net`` with
its C++ framer core built from source at first use, ``tx``, ``rx``,
``config``, ``obs`` with a ``torch.profiler`` trace, ``utils``), which runs
no device code and interoperates with the reference's over the LAN; and the
CLI (``python -m anet_torch.cli``) but ``bench``. Every public entry point
of the modem takes ``device=``
(a sharded one, a mesh of devices) and defaults to ``"cuda"``; it raises
when CUDA is absent unless the caller passes ``device="cpu"``. On the CPU
each kernel wrapper runs its plain PyTorch version.
"""

from anet_torch._device import resolve_device

__all__ = ["resolve_device"]
