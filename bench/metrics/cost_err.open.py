"""cost_err.open: the cost predictor's mean relative error over the agents-open window's agents (readers.cost_err)."""

from readers import cost_err as read  # noqa: F401
