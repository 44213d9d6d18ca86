"""mfu.open: the useful model FLOPs of the traced window over its seconds at the bf16 peak (readers.mfu)."""

from readers import mfu as read  # noqa: F401
