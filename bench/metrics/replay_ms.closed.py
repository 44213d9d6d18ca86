"""replay_ms.closed: host ms inside the program's decode.replay spans per decode step (program_trace.replay_ms)."""

from program_trace import replay_ms as read  # noqa: F401
