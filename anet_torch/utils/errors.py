"""Error aggregation (the utils.kt:3-19 doAllAndThrowCombined analog)."""

from __future__ import annotations

from typing import Callable, Iterable, List


class CombinedError(Exception):
    """Carries every failure from a fan-out operation."""

    def __init__(self, errors: List[BaseException]) -> None:
        self.errors = errors
        super().__init__(
            "; ".join(f"{type(e).__name__}: {e}" for e in errors) or "no errors"
        )


def do_all_and_raise_combined(actions: Iterable[Callable[[], None]]) -> None:
    """Run every action; if any raised, raise one CombinedError afterwards.

    Used by the transmitter's fan-out so one dead receiver doesn't stop
    frames reaching the others.
    """
    errors: List[BaseException] = []
    for action in actions:
        try:
            action()
        except BaseException as e:  # noqa: BLE001 — aggregate everything
            errors.append(e)
    if errors:
        raise CombinedError(errors)
