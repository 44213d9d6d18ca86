"""step_mfu.open: useful FLOPs of the program's step spans over their wall at the bf16 peak (program_trace.step_mfu)."""

from program_trace import step_mfu as read  # noqa: F401
