"""The port's visualisers (``sylph_tpu_torch/tools/visualize_class_codes.py``
and ``visualize_result.py``) against ``tools/visualize_class_codes.py`` and
``tools/visualize_result.py``: the same codes read from the same ``.npz``
directory, PCA coordinates equal to ``embed(x, "pca")``, the coordinates
file where matplotlib is missing equal to JAX's, and ``draw`` writing a
pixel-equal image.
"""

import builtins
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from sylph_tpu_torch.tools import visualize_class_codes, visualize_result

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import visualize_class_codes as jax_codes  # noqa: E402
import visualize_result as jax_result  # noqa: E402


@pytest.fixture
def code_dir(tmp_path):
    rng = np.random.RandomState(0)
    d = tmp_path / "codes"
    d.mkdir()
    for i in range(7):
        np.savez(d / f"class_{i:02d}.npz",
                 cls_conv=rng.randn(1, 256).astype(np.float32),
                 cls_bias=rng.randn(1).astype(np.float32))
    return str(d)


def test_codes_and_pca_equal_jax(code_dir):
    names, vecs = visualize_class_codes.load_codes(code_dir)
    jnames, jvecs = jax_codes.load_codes(code_dir)
    assert names == jnames
    np.testing.assert_array_equal(vecs, jvecs)
    np.testing.assert_array_equal(visualize_class_codes.embed(vecs, "pca"),
                                  jax_codes.embed(jvecs, "pca"))


def _no_matplotlib(monkeypatch):
    real = builtins.__import__

    def fake(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", fake)


def test_coordinates_file_without_matplotlib(code_dir, tmp_path,
                                             monkeypatch):
    _no_matplotlib(monkeypatch)
    got, want = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    visualize_class_codes.main(["--code-dir", code_dir, "--out", got,
                                "--method", "pca"])
    monkeypatch.setattr(sys, "argv", ["visualize_class_codes.py",
                                      "--code-dir", code_dir, "--out", want,
                                      "--method", "pca"])
    jax_codes.main()
    with open(got + ".txt") as f, open(want + ".txt") as g:
        assert f.read() == g.read()


def test_scatter_png_written(code_dir, tmp_path):
    out = str(tmp_path / "codes.png")
    visualize_class_codes.main(["--code-dir", code_dir, "--out", out,
                                "--method", "pca"])
    assert Image.open(out).size[0] > 0


def test_draw_pixel_equal(tmp_path):
    rng = np.random.RandomState(0)
    root = tmp_path / "images"
    root.mkdir()
    for img_id in (3, 9):
        Image.fromarray(rng.randint(0, 256, (90, 120, 3), np.uint8)).save(
            root / f"{img_id:012d}.jpg")
    dets = [{"image_id": img_id, "category_id": int(rng.randint(1, 90)),
             "bbox": [float(v) for v in rng.uniform(0, 50, 4)],
             "score": float(rng.rand())}
            for img_id in (3, 9, 11) for _ in range(6)]
    results = tmp_path / "dets.json"
    results.write_text(json.dumps(dets))
    for name, mod in (("port", visualize_result), ("jax", jax_result)):
        src = str(root / f"{3:012d}.jpg")
        mod.draw(src, [d for d in dets if d["image_id"] == 3],
                 str(tmp_path / f"{name}.png"), 0.3, names={5: "five"})
    a = np.asarray(Image.open(tmp_path / "port.png"))
    b = np.asarray(Image.open(tmp_path / "jax.png"))
    np.testing.assert_array_equal(a, b)
    visualize_result.main(["--results", str(results), "--image-root",
                           str(root), "--out-dir", str(tmp_path / "vis"),
                           "--thresh", "0.3"])
    assert sorted(os.listdir(tmp_path / "vis")) == [f"{3:012d}.jpg",
                                                    f"{9:012d}.jpg"]
