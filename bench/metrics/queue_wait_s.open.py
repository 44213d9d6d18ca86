"""queue_wait_s.open: mean wall seconds from an inference's submission to its admission (readers.queue_wait_s)."""

from readers import queue_wait_s as read  # noqa: F401
