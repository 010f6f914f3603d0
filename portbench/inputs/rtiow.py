"""The final scene of *Ray Tracing in One Weekend* as recipe entries.

Peter Shirley, Trevor David Black, Steve Hollasch, *Ray Tracing in One
Weekend*, v4.0, section 14.1 "A Final Render" (``main.cc``): a lambertian
ground sphere of radius 1000, a 22x22 grid of radius-0.2 spheres with
randomised centres and materials, and three radius-1 spheres, lit only by
the sky. ``rtiow_spheres`` draws the grid in the book's order from numpy's
``default_rng(seed)`` (the book's own generator is not reproducible) and
returns the ``material`` and ``sphere`` entries of ``inputs/recipe.py``,
each sphere with a material of its own, in the port's z-up frame:
(x, y, z) of the book is (x, -z, y) here, a rotation.

The book's three materials map onto the port's three-lobe BSDF (with
``roughness_from_material``, GGX alpha = sqrt(2 / (spec_exp + 2))):

- lambertian: ``diffuse`` = albedo;
- metal: ``specular`` = albedo, ``spec_exp`` = 2 / fuzz^2 - 2, so alpha =
  fuzz, with fuzz at least ``MIN_ALPHA``;
- dielectric: ``specular`` 0.04 (Schlick's F0 for ior 1.5),
  ``transmission`` 1, ``ior`` 1.5, alpha ``MIN_ALPHA``.

``SKY`` is the book's ``ray_color`` background in the same frame, for
``SceneBuilder.set_sky``. Numbers are rounded to 6 decimals, so a
configuration file written from these entries holds them exactly.

    python3 portbench/inputs/rtiow.py --seed 2026 > scene.json

prints the entries as a JSON list, one per line.
"""

from __future__ import annotations

import json
import sys

import numpy as np

# the smallest GGX alpha the mapping gives (a mirror and glass)
MIN_ALPHA = 0.01
GLASS_F0 = 0.04
# the book's background: white at the horizon's bottom, blue at the top
SKY = {"bottom": [1.0, 1.0, 1.0], "top": [0.5, 0.7, 1.0],
       "up": [0.0, 0.0, 1.0]}


def _r(x) -> list:
    return [round(float(v), 6) for v in np.atleast_1d(x)]


def to_port(p) -> list:
    """A point of the book's y-up frame in the port's z-up frame."""
    x, y, z = p
    return _r([x, -z, y])


def spec_exp(alpha: float) -> float:
    """The Phong exponent whose GGX alpha is ``alpha`` (at least
    ``MIN_ALPHA``)."""
    a = max(float(alpha), MIN_ALPHA)
    return round(2.0 / (a * a) - 2.0, 6)


def lambertian(albedo) -> dict:
    return {"material": {"diffuse": _r(albedo)}}


def metal(albedo, fuzz) -> dict:
    return {"material": {"specular": _r(albedo),
                         "spec_exp": spec_exp(fuzz)}}


def dielectric(ior: float) -> dict:
    return {"material": {"specular": [GLASS_F0] * 3,
                         "spec_exp": spec_exp(0.0),
                         "transmission": [1.0, 1.0, 1.0],
                         "ior": float(ior)}}


def sphere(center_book, radius) -> dict:
    return {"sphere": {"center": to_port(center_book),
                       "radius": round(float(radius), 6)}}


def rtiow_spheres(seed: int) -> list:
    """The final scene's recipe entries: ground, grid, three large
    spheres, each sphere after its own material."""
    rng = np.random.default_rng(seed)
    out = [lambertian([0.5, 0.5, 0.5]), sphere([0, -1000, 0], 1000)]
    skip = np.array([4.0, 0.2, 0.0])
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2,
                               b + 0.9 * rng.random()])
            if np.linalg.norm(center - skip) <= 0.9:
                continue
            if choose < 0.8:
                mat = lambertian(rng.random(3) * rng.random(3))
            elif choose < 0.95:
                mat = metal(rng.uniform(0.5, 1.0, 3), rng.uniform(0.0, 0.5))
            else:
                mat = dielectric(1.5)
            out += [mat, sphere(center, 0.2)]
    out += [dielectric(1.5), sphere([0, 1, 0], 1.0),
            lambertian([0.4, 0.2, 0.1]), sphere([-4, 1, 0], 1.0),
            metal([0.7, 0.6, 0.5], 0.0), sphere([4, 1, 0], 1.0)]
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, required=True)
    a = p.parse_args(argv)
    entries = rtiow_spheres(a.seed)
    sys.stdout.write("[\n" + ",\n".join(
        "  " + json.dumps(e) for e in entries) + "\n]\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
