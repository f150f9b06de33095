"""Opus error-code mapping (the opus.kt:6-17 analog)."""

from __future__ import annotations

_OPUS_ERRORS = {
    0: "OPUS_OK",
    -1: "OPUS_BAD_ARG",
    -2: "OPUS_BUFFER_TOO_SMALL",
    -3: "OPUS_INTERNAL_ERROR",
    -4: "OPUS_INVALID_PACKET",
    -5: "OPUS_UNIMPLEMENTED",
    -6: "OPUS_INVALID_STATE",
    -7: "OPUS_ALLOC_FAIL",
}


class OpusError(RuntimeError):
    def __init__(self, code: int, context: str = "") -> None:
        name = _OPUS_ERRORS.get(code, f"unknown({code})")
        msg = f"{name} (code {code})"
        if context:
            msg = f"{context}: {msg}"
        super().__init__(msg)
        self.code = code


def check(code: int, context: str = "") -> int:
    """Raise on negative Opus return codes; pass through otherwise."""
    if code < 0:
        raise OpusError(code, context)
    return code
