"""The seeded weights (``lib/weights.py``): the benchmarked configurations
draw the same bits at any seed, and every module type the port builds has
its rule, found from the built detector; any other type raises, naming it.
"""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from conftest import ROOT

from port_bench.lib import model as pb_model
from port_bench.lib.weights import kind, kinds, seeded_state_dict

# SHA-256 of the seeded state dicts at the published widths on the CPU, as
# the cells have drawn them since the benchmark's first commit: every cell
# reads the same weights, bit for bit, at any seed.
DIGESTS = {
    ("meta_fcos_r50", 5):
        "08ac4e7f105701e8d0cdb5eb276932f21063998b7e05dc2ef3d2309306d203db",
    ("meta_fcos_r50", 3141600572):
        "d5f7eaf60ef39d638055cf3333f8328ecd60cc8c36aed8fe7a310511f3b3a286",
    ("meta_rcnn_r50", 5):
        "fb09baccb2d23a5603dd47fb785decade0e20a35f31b1bc4307e3d2aa4ef8446",
    ("meta_rcnn_r50", 3141600572):
        "67de6ec8f02e21fe8c194797c34d6b789dab5a34b8624813f3a89ba2ac14fdd9",
}

# (runner, published YAML, opts) of each detector the port builds
MODELS = {
    "meta_fcos_coco": ("MetaFCOSRunner",
                       "COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml", []),
    "roi_encoder_lvis": (
        "MetaFCOSROIEncoderRunner",
        "LVISv1-Detection/Meta-FCOS/Meta-FCOS-ROI-Encoder-finetune.yaml", []),
    "roi_encoder_coco": (
        "MetaFCOSROIEncoderRunner",
        "COCO-Detection/Meta-FCOS-ROIEncoder/Meta-FCOS-finetune.yaml", []),
    "meta_rcnn": ("MetaFasterRCNNRunner",
                  "LVISv1-Detection/Meta-RCNN/Meta-RCNN-FPN-finetune.yaml", []),
    "tfa": ("TFAFewShotDetectionRunner", "COCO-Detection/TFA/tfa-finetune.yaml",
            []),
    "dcn_towers": ("MetaFCOSRunner",
                   "COCO-Detection/Meta-FCOS/Meta-FCOS-finetune.yaml",
                   ["MODEL.FCOS.USE_DEFORMABLE", True]),
}


def _digest(sd) -> str:
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(f"{k}{tuple(v.shape)}{v.dtype}".encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(DIGESTS))
def test_benchmarked_weights_are_bit_identical(name, seed):
    conf = json.loads((ROOT / f"port_bench/configs/{name}.json").read_text())
    conf["name"] = name
    _, _, sd = pb_model.build(conf, seed, "cpu")
    assert _digest(sd) == DIGESTS[(name, seed)]


def _r18(name):
    runner, yaml, opts = MODELS[name]
    conf = {"name": name, "runner": runner, "yaml": f"sylph://{yaml}",
            "opts": [*opts, "MODEL.RESNETS.DEPTH", 18, "TPU.COMPUTE_DTYPE",
                     "float32"], "cfg": {}}
    cls, cfg = pb_model.merged_cfg(conf)
    return cls(device="cpu").build_model(cfg)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_every_key_classified(name):
    model = _r18(name)
    rule = kinds(model)
    assert list(rule) == list(model.state_dict())
    sd = seeded_state_dict(model, 7, "cpu")
    norms = [k for k in sd if isinstance(
        model.get_submodule(k.rpartition(".")[0]),
        (torch.nn.GroupNorm, torch.nn.LayerNorm)) and k.endswith(".weight")]
    assert norms and all(rule[k] == "norm" for k in norms)
    for k in norms:
        assert abs(float(sd[k].mean()) - 1.0) < 0.05, k
    if name.startswith("roi_encoder"):
        assert any(isinstance(model.get_submodule(k.rpartition(".")[0]),
                              torch.nn.LayerNorm) for k in norms)
        heads = [k for k in sd if k.endswith("self_attn.query.bias")]
        assert heads and all(sd[k].dim() == 2 and rule[k] == "bias"
                             for k in heads)


def test_an_unknown_type_raises_naming_it():
    class Odd(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = torch.nn.Parameter(torch.zeros(3, 3))

    model = torch.nn.Module()
    model.odd = Odd()
    with pytest.raises(ValueError, match="odd.weight.*of a Odd"):
        kinds(model)
    with pytest.raises(ValueError, match="of a BatchNorm2d"):
        kind("bn.weight", torch.nn.BatchNorm2d(4))
