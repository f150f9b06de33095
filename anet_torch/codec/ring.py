"""Fixed-capacity circular byte buffer.

Capability parity with the reference transmitter's ByteRingBuffer
(ByteRingBuffer.kt:7-72): strict overflow/underflow errors, wrap-around
put/get. Backed by a bytearray with two indices instead of the reference's
recursive split-at-the-wrap-point approach.
"""

from __future__ import annotations


class RingBufferError(RuntimeError):
    """Overflow (put past capacity) or underflow (get past fill)."""


class ByteRingBuffer:
    def __init__(self, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._buf = bytearray(capacity)
        self._capacity = capacity
        self._read = 0
        self._size = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def remaining_read(self) -> int:
        """Bytes available to get."""
        return self._size

    @property
    def remaining_write(self) -> int:
        """Bytes of free space."""
        return self._capacity - self._size

    def put(self, data: bytes) -> None:
        n = len(data)
        if n > self.remaining_write:
            raise RingBufferError(
                f"overflow: putting {n} bytes with only {self.remaining_write} free"
            )
        write = (self._read + self._size) % self._capacity
        first = min(n, self._capacity - write)
        self._buf[write : write + first] = data[:first]
        if first < n:
            self._buf[: n - first] = data[first:]
        self._size += n

    def get(self, n: int) -> bytes:
        if n > self._size:
            raise RingBufferError(
                f"underflow: getting {n} bytes with only {self._size} available"
            )
        first = min(n, self._capacity - self._read)
        out = bytes(self._buf[self._read : self._read + first])
        if first < n:
            out += bytes(self._buf[: n - first])
        self._read = (self._read + n) % self._capacity
        self._size -= n
        return out

    def peek(self, n: int) -> bytes:
        """get() without consuming."""
        if n > self._size:
            raise RingBufferError(
                f"underflow: peeking {n} bytes with only {self._size} available"
            )
        first = min(n, self._capacity - self._read)
        out = bytes(self._buf[self._read : self._read + first])
        if first < n:
            out += bytes(self._buf[: n - first])
        return out

    def clear(self) -> None:
        self._read = 0
        self._size = 0
