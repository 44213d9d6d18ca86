"""prefill_pad_share.closed: share of the prefill passes' padded rows x bucket that is padding, from the program's prefill spans (program_trace.prefill_pad_share)."""

from program_trace import prefill_pad_share as read  # noqa: F401
