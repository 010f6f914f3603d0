"""Percent of the traced launches' wall in which the card was idle while
the host was inside the program's ``mega.draws`` spans (profiler trace:
each idle gap of the card put down to the innermost span open when it
began, ``spans.attribute``)."""

from portbench.spans import attribution


def read(rec):
    t = rec.trace
    a = attribution(t)
    if a is None or t.window_s <= 0:
        return None
    return 100.0 * a["idle_s"]["mega.draws"] / t.window_s
