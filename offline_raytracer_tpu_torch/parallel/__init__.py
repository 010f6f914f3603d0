"""Multi-process rendering on ``torch.distributed`` (counterpart of
``offline_raytracer_tpu/parallel/``): rays split over ranks
(``shard.py``), and the triangles too, with ray blocks rotating over a
ring of ranks (``ring.py``)."""
