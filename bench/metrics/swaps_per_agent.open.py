"""swaps_per_agent.open: the engine's swaps over the agents completed (readers.swaps_per_agent)."""

from readers import swaps_per_agent as read  # noqa: F401
