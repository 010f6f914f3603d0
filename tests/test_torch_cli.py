"""The port's command-line renderer (``offline_raytracer_tpu_torch/cli.py``)
on the CPU (``--device cpu``): its .hdr against ``render_image``'s image,
its JSON line, ``--checkpoint``, ``--meter``, ``--config``, the JAX CLI's
image, and its refusal to render without a card when none is asked for.

"Within RGBE rounding": the .hdr read back equals the image passed
through the RGBE encoder and decoder, bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from offline_raytracer_tpu_torch import cli
from offline_raytracer_tpu_torch.models.scenes import analytic
from offline_raytracer_tpu_torch.render import render_image
from offline_raytracer_tpu_torch.utils import checkpoint as ckpt
from offline_raytracer_tpu_torch.utils import hdr

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
BASE = ["--preset", "analytic", "--width", "16", "--height", "16",
        "--max-bounces", "4", "--no-dof"]


def _run(capsys, *extra):
    """cli.main on the CPU -> (JSON line, stderr)."""
    assert cli.main(BASE + ["--device", "cpu", *extra]) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def _rgbe(img):
    return hdr.rgbe_to_float(hdr.float_to_rgbe(img))


def test_main_writes_render_image_as_hdr(capsys, tmp_path):
    out, png = str(tmp_path / "o" / "a.hdr"), str(tmp_path / "a.png")
    line, _ = _run(capsys, "--spp", "2", "--out", out, "--png", png)
    assert sorted(line) == ["height", "mpaths_per_s", "seconds", "spp",
                            "width"]
    assert (line["width"], line["height"], line["spp"]) == (16, 16, 2)
    assert line["seconds"] > 0 and line["mpaths_per_s"] > 0
    args = cli.build_parser().parse_args(BASE + ["--spp", "2"])
    img = render_image(analytic(16, 16, device="cpu"),
                       cli.config_from_args(args, 16, 16))
    got = hdr.read_hdr(out)
    assert got.shape == (16, 16, 3) and img.max() > 0
    np.testing.assert_array_equal(got, _rgbe(img))
    assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_preset_default_size(capsys, tmp_path):
    """Without --width/--height the preset's own size (analytic: 256)."""
    argv = ["--preset", "analytic", "--spp", "1", "--max-bounces", "1",
            "--device", "cpu", "--out", str(tmp_path / "a.hdr")]
    assert cli.main(argv) == 0
    line = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert (line["width"], line["height"]) == (256, 256)
    assert hdr.read_hdr(str(tmp_path / "a.hdr")).shape == (256, 256, 3)


def test_checkpoint_resumes(capsys, tmp_path):
    """--checkpoint: a 2-spp run relabelled as a paused 4-spp run, then
    resumed, writes bitwise the uninterrupted 4-spp run's .hdr."""
    every = ["--checkpoint-every", "2"]
    _run(capsys, "--spp", "4", "--checkpoint", str(tmp_path / "a.npz"),
         "--out", str(tmp_path / "a.hdr"), *every)
    path = str(tmp_path / "b.npz")
    _run(capsys, "--spp", "2", "--checkpoint", path, "--out",
         str(tmp_path / "half.hdr"), *every)
    cfg = cli.config_from_args(
        cli.build_parser().parse_args(BASE + ["--spp", "4"]), 16, 16)
    acc, done = ckpt.load_accum(path, cfg.replace(spp=2))
    assert done == 2
    ckpt.save_accum(path, acc, 2, cfg)
    assert cli.main(BASE + ["--device", "cpu", "--spp", "4", "--checkpoint",
                            path, "--out", str(tmp_path / "b.hdr"),
                            "--progress", *every]) == 0
    assert f"resumed {path} at spp 2" in capsys.readouterr()[0]
    np.testing.assert_array_equal(hdr.read_hdr(str(tmp_path / "b.hdr")),
                                  hdr.read_hdr(str(tmp_path / "a.hdr")))
    assert ckpt.load_accum(path, cfg)[1] == 4


def test_meter_prints_its_line(capsys, tmp_path):
    _, err = _run(capsys, "--spp", "2", "--meter", "--out",
                  str(tmp_path / "a.hdr"))
    rec = [json.loads(x) for x in err.splitlines() if x.startswith("{")]
    assert len(rec) == 1 and rec[0]["event"] == "render_meter"
    assert rec[0]["paths"] == 16 * 16 * 2
    assert rec[0]["rays"] > rec[0]["segments"] >= rec[0]["paths"]


def test_config_file(capsys, tmp_path):
    """--config: RenderConfig fields from YAML under the flags; unknown
    keys refused."""
    pytest.importorskip("yaml")
    good = tmp_path / "good.yaml"
    good.write_text("aperture_radius: 0.05\nspp: 99\n")
    args = cli.build_parser().parse_args(BASE + ["--config", str(good)])
    cfg = cli.config_from_args(args, 16, 16)
    assert cfg.aperture_radius == 0.05 and cfg.spp == 64      # flags win
    bad = tmp_path / "bad.yaml"
    bad.write_text("spp: 3\nbogus_knob: 1\n")
    with pytest.raises(SystemExit, match="bogus_knob"):
        cli.main(BASE + ["--device", "cpu", "--config", str(bad), "--out",
                         str(tmp_path / "x.hdr")])


def test_matches_the_jax_cli(capsys, tmp_path):
    """The same flags through the JAX CLI (its plain path, --no-pallas) and
    the port's: every pixel within one RGBE step plus 2e-3 relative, and
    means within 2e-4 relative (the packages' images agree to float32
    rounding, then each is RGBE-rounded on its own)."""
    from offline_raytracer_tpu import cli as jax_cli
    from offline_raytracer_tpu.utils import hdr as jax_hdr

    flags = BASE + ["--spp", "2", "--no-pallas"]
    jax_cli.main(flags + ["--out", str(tmp_path / "j.hdr")])
    capsys.readouterr()
    _run(capsys, "--spp", "2", "--no-pallas", "--out",
         str(tmp_path / "t.hdr"))
    want = jax_hdr.read_hdr(str(tmp_path / "j.hdr"))
    got = hdr.read_hdr(str(tmp_path / "t.hdr"))
    step = np.maximum(want, got).max(-1, keepdims=True) / 128.0
    assert (np.abs(got - want) <= step + 2e-3 * np.abs(want)).all()
    assert abs(got.mean() - want.mean()) <= 2e-4 * want.mean()


@pytest.mark.parametrize("device", ["cpu", None])
def test_python_m_entry_point(tmp_path, device):
    """``python -m offline_raytracer_tpu_torch.cli``: with --device cpu it
    renders and prints its JSON line; with the default device and no card
    it fails and writes nothing, rather than render on the CPU."""
    if device is None and torch.cuda.is_available():
        pytest.skip("a card is present: the default device renders")
    out = tmp_path / "a.hdr"
    argv = [sys.executable, "-m", "offline_raytracer_tpu_torch.cli",
            "--preset", "analytic", "--width", "8", "--height", "8", "--spp",
            "1", "--max-bounces", "2", "--out", str(out)]
    if device:
        argv += ["--device", device]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    r = subprocess.run(argv, capture_output=True, text=True, env=env,
                       timeout=300)
    if device:
        assert r.returncode == 0, r.stderr
        assert json.loads(r.stdout.strip().splitlines()[-1])["width"] == 8
        assert out.exists()
    else:
        assert r.returncode != 0 and "no CUDA device" in r.stderr
        assert not out.exists()


def test_main_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device renders")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(BASE + ["--spp", "1", "--out", str(tmp_path / "a.hdr")])
    assert not (tmp_path / "a.hdr").exists()
