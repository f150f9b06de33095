"""Signal chain of the port: bits, CRC, modulation, sync, demodulation,
framing, and the OFDM family (mirrors ``anet.dsp``)."""
