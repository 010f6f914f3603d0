"""The card's idle share over the traced wavefront launches, in percent
(``trace.idle_pct`` over ``spans.SpanTracer``'s reading, which leaves out
the card's copies of the host's annotations)."""

from portbench.trace import idle_pct as read  # noqa: F401
