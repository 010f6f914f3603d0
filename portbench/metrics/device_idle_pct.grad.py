"""The card's idle share over the traced inverse-rendering steps, in
percent (``trace.idle_pct``; each step's forward and backward are
synchronised at their ends there)."""

from portbench.trace import idle_pct as read  # noqa: F401
