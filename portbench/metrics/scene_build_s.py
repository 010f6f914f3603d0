"""Seconds of the scene build in set-up: ``SceneBuilder.build`` (the numpy
LBVH, its sub-boxes, the light table, the copy to the card) and
``ops/mega.prepare_tables``, synchronised (the benchmark's span)."""


def read(rec):
    return rec.spans.get("scene_build_s")
