"""idle_share.open: share of the traced window with no operation on the device (readers.idle_share)."""

from readers import idle_share as read  # noqa: F401
