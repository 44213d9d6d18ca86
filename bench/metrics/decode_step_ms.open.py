"""decode_step_ms.open: wall ms per decode step of the engine's decode windows (readers.decode_step_ms)."""

from readers import decode_step_ms as read  # noqa: F401
