"""Protocol-wide constants of the modem's wire contract.

A copy of ``anet/constants.py`` (the JAX package's): the port keeps its own
so that ``anet_torch`` imports nothing of ``anet``. Both packages must hold
the same values; ``tests/test_torch_dsp.py`` checks that they do.
"""

# --- discovery / transport ---------------------------------------------------
MAGIC_WORD = 0x2C5DA044
UDP_DISCOVERY_PORT = 58765
TCP_AUDIO_PORT = 58764
PROTOCOL_VERSION = 1
DISCOVERY_TIMEOUT_S = 2.0

# --- frame geometry ----------------------------------------------------------
MAX_ENCODED_FRAME_SIZE = 4096
MAX_DECODED_FRAME_SIZE = 11520  # 60 ms @ 48 kHz, 16-bit, stereo

DECODE_SAMPLE_RATE_HZ = 48_000
DECODE_BITS_PER_SAMPLE = 16
DECODE_CHANNELS = 2

# --- receiver pipeline -------------------------------------------------------
RX_FRAME_QUEUE_DEPTH = 40  # ~2.4 s of audio at 60 ms frames

# --- transmitter pacing ------------------------------------------------------
PACING_BUCKET_CAPACITY_MS = 1200.0
PACING_DRAIN_MS_PER_S = 1000.0

# --- connection recovery -----------------------------------------------------
RECONNECT_MAX_IMMEDIATE_RETRIES = 10
RECONNECT_COOLDOWN_MS = 1000

# --- nanopb-compatible string limits ----------------------------------------
# protobuf_ip.options:1-2 sets max_size:128, but nanopb's max_size counts
# the NUL terminator: the firmware's pb_decode rejects a 128-byte string
# with "string overflow" (pb_decode.c pb_dec_string; verified against the
# real codec by tests/test_nanopb_cross.py). 127 usable bytes.
MAX_DEVICE_NAME_BYTES = 127
MAX_OPUS_VERSION_BYTES = 127

# --- codec envelope (reference OpusEncoder.kt:54,195-203) --------------------
DEFAULT_OPUS_BITRATE_BPS = 92_000
SUPPORTED_SAMPLE_RATES_HZ = (8_000, 12_000, 16_000, 24_000, 48_000)
SUPPORTED_FRAME_DURATIONS_MS = (2.5, 5.0, 10.0, 20.0, 40.0, 60.0)
DEFAULT_FRAME_DURATION_MS = 60.0
