"""The port's scene entry points build on the card unless the caller asks
for the CPU, and without a card they raise instead of building on the CPU.
"""

import inspect

import pytest
import torch

from offline_raytracer_tpu_torch.convert import scene_from_arrays
from offline_raytracer_tpu_torch.models import scenes
from offline_raytracer_tpu_torch.scene.build import SceneBuilder


def _builder_build(**kw):
    b = SceneBuilder()
    b.add_material(diffuse=(0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, 0.0), 1.0)
    return b.build(8, 8, **kw)


ENTRY_POINTS = {
    "SceneBuilder.build": (SceneBuilder.build, _builder_build),
    "scenes.analytic": (scenes.analytic,
                        lambda **kw: scenes.analytic(8, 8, **kw)),
    "scenes.bunny": (scenes.bunny,
                     lambda **kw: scenes.bunny(8, 8, data_dir="absent", **kw)),
    "convert.scene_from_arrays": (scene_from_arrays,
                                  lambda **kw: scene_from_arrays({}, **kw)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    fn, _ = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_card_raises_instead_of_building_on_the_cpu(name, monkeypatch):
    _, call = ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


def test_cpu_on_request():
    scene = _builder_build(device="cpu")
    assert scene.spheres.center.device.type == "cpu"
    assert scenes.analytic(8, 8, device="cpu").materials.ior.device.type \
        == "cpu"
