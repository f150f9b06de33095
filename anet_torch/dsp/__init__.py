"""Signal chain of the port: bits, CRC, modulation, sync, demodulation,
framing (mirrors ``anet.dsp``)."""
