"""What the benchmark may import: no JAX, no JAX package anywhere under
portbench/, and nothing of the program in the reference. Top-level module
names are compared whole (the port's name begins with the JAX
package's)."""

import ast
import os

import pytest

from pb_cases import ROOT

BENCH = os.path.join(ROOT, "portbench")
NEVER = {"jax", "jaxlib", "flax", "optax", "offline_raytracer_tpu"}
PROGRAM = "offline_raytracer_tpu_torch"


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_jax_anywhere():
    bad = {(os.path.relpath(p, ROOT), n) for p in _py_files(BENCH)
           for n in _top_names(p) if n in NEVER}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    bad = {(os.path.relpath(p, ROOT), n)
           for p in _py_files(os.path.join(BENCH, "reference"))
           for n in _top_names(p) if n in NEVER | {PROGRAM}}
    assert not bad


def test_names_are_compared_whole(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import offline_raytracer_tpu_torch.render\n"
                 "from offline_raytracer_tpu import render\n")
    assert list(_top_names(str(p))) == [PROGRAM, "offline_raytracer_tpu"]


@pytest.mark.parametrize("loaded,want", [
    (["offline_raytracer_tpu_torch.render", "jaxtyping"], []),
    (["jax.numpy", "jaxlib"], ["jax.numpy", "jaxlib"]),
    (["offline_raytracer_tpu.ops"], ["offline_raytracer_tpu.ops"]),
])
def test_forbidden_modules_whole_names(loaded, want):
    from portbench import harness

    assert harness.forbidden_modules(loaded) == want
