"""The least time one H100 could take for the wavefront route's
closest-hit queries, counted from the work they must do whatever the
search: each live ray's origin and direction read once (24 bytes) and its
distance and winner id written once (8 bytes), and the sphere table
(centre, radius and material, 20 bytes a sphere) read once a query, at
the data sheet's device-memory bandwidth. No sphere test is counted, so a
search that tests fewer spheres (a BVH over them) is read against the same
work and cannot read over its bound.
"""

# NVIDIA H100 SXM data sheet: device memory bytes/s
PEAK_BYTES = 3.35e12
RAY_BYTES = 24 + 8
SPHERE_BYTES = 12 + 4 + 4


def hit_bound_ms(live_rays: float, queries: int, spheres: int) -> float:
    """Least ms for ``queries`` closest-hit queries over ``live_rays``
    live ray-bounces in all and a table of ``spheres`` spheres."""
    nbytes = RAY_BYTES * float(live_rays) + SPHERE_BYTES * spheres * queries
    return nbytes / PEAK_BYTES * 1e3
