"""The port's learnable synthetic sets against the JAX package's.

Every quality record in ``artifacts/`` was trained and scored on sets
written by ``sylph_tpu/data/synthetic.py``. The port's quality loop writes
its own with ``sylph_tpu_torch/data/synthetic.py``; at the recipes'
arguments (``tools/quality_loop_variants.py`` :632-637 and :446-449) both
builders must write the same files: the JSON equal, every image equal byte
for byte and pixel for pixel.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from sylph_tpu.data import synthetic as jax_synthetic
from sylph_tpu_torch.data import synthetic

# (builder, keyword arguments) of each recipe
CASES = {
    "coco_hard": ("make_learnable_coco",
                  dict(n_train=180, n_val=45, img_hw=(128, 128),
                       n_empty_val=2, hard=True)),
    "coco_default": ("make_learnable_coco",
                     dict(n_train=80, n_val=16, img_hw=(128, 128),
                          n_empty_val=2)),
    "lvis_default": ("make_learnable_lvis", {}),
    "lvis_wheel": ("make_learnable_lvis",
                   dict(n_train=180, n_val=45, wheel=True)),
}


def _write(module, builder, kwargs, root):
    fn = getattr(module, builder)
    if builder == "make_learnable_lvis":
        fn(os.path.join(root, "lvis"), os.path.join(root, "coco"), **kwargs)
    else:
        fn(os.path.join(root, "coco"), **kwargs)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, root)] = path
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_learnable_set_equals_jax(case, tmp_path):
    builder, kwargs = CASES[case]
    _write(jax_synthetic, builder, kwargs, str(tmp_path / "jax"))
    _write(synthetic, builder, kwargs, str(tmp_path / "port"))
    want, got = _files(str(tmp_path / "jax")), _files(str(tmp_path / "port"))
    assert sorted(got) == sorted(want)
    images = [rel for rel in want if not rel.endswith(".json")]
    jsons = [rel for rel in want if rel.endswith(".json")]
    assert jsons and len(images) >= 16
    for rel in jsons:
        with open(want[rel]) as f, open(got[rel]) as g:
            assert json.load(g) == json.load(f), rel
    for rel in images:
        with open(want[rel], "rb") as f, open(got[rel], "rb") as g:
            assert g.read() == f.read(), rel
        assert np.array_equal(np.asarray(Image.open(got[rel])),
                              np.asarray(Image.open(want[rel]))), rel
