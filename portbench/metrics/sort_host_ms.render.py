"""Host ms per traced launch inside the program's ``mega.sort`` spans:
the issue of the coherence sort between the early bounces (Morton key,
argsort, permutations; the recorder's spans over the traced launches)."""

from portbench.spans import host_ms_per_launch


def read(rec):
    return host_ms_per_launch(rec, "mega.sort")
