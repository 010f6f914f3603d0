"""Host ms per traced launch inside the program's ``mega.draws`` spans:
the issue of each segment's threefry draws
(``rng.tagged_uniform_planes``; the recorder's spans over the traced
launches)."""

from portbench.spans import host_ms_per_launch


def read(rec):
    return host_ms_per_launch(rec, "mega.draws")
