"""The card's idle share over the traced launches, in percent
(``trace.idle_pct``)."""

from portbench.trace import idle_pct as read  # noqa: F401
