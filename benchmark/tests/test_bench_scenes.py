"""The frozen scenes: each configuration's scene, written by the
benchmark's own generator and read by the reference's own reader, has the
triangles and lights its configuration states."""

from __future__ import annotations

import json

import pytest

from benchmark import run
from benchmark.reference import scene as ref_scene

CONFIGS = sorted(p.stem for p in (run.BENCH / "configs").glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_scene_counts(name, tmp_path):
    conf = json.loads((run.BENCH / "configs" / f"{name}.json").read_text())
    spec = dict(conf["scene"])
    path = tmp_path / "scene.gltf"
    run.load_module(run.BENCH / "scenes"
                    / f"{spec.pop('generator')}.py").write(path, **spec)
    sc = ref_scene.read(path, "cpu")
    assert (sc.num_triangles, sc.num_lights) == (conf["triangles"],
                                                 conf["lights"])


def test_stated_counts():
    """The counts the configurations state are the scenes' known ones."""
    got = {n: json.loads((run.BENCH / "configs" / f"{n}.json").read_text())
           for n in CONFIGS}
    assert (got["demo_1080p"]["triangles"], got["demo_1080p"]["lights"]) \
        == (7090, 4)
    assert got["city24_1080p"]["triangles"] == 207234


def test_png_round_trip():
    from benchmark.scenes.gltf_writer import checker_texture, png_encode

    img = checker_texture(16)
    assert (ref_scene.decode_png(png_encode(img)) == img).all()
