"""``jax_params_from_state_dict`` is ``state_dict_from_jax``'s inverse,
leaf for leaf.

A stage of the quality loops hands its weights to the next as a flat
``.npz`` of flax params (``save_flat_npz``). For every model the port
builds (Meta-FCOS with the CodeGenerator and with the ROIEncoder, the TFA
cosine head, DCNv2 towers, the two-stage detector linear and cosine,
episodic and plain), ``state_dict_from_jax`` takes the tree back to the
same state_dict. For the models whose leaves the one-stage pretrain of
tests/test_torch_quality_loop.py does not already hold against JAX (the
ROIEncoder's attention, LayerNorm and Dense leaves; the two-stage box
head's Dense, cosine and background leaves), the tree written from a model
holding JAX's weights is JAX's own tree: the same paths, shapes and
values.
"""

import numpy as np
import pytest
import torch

from sylph_tpu_torch import build_model_from_cfg, get_default_cfg
from sylph_tpu_torch.meta_faster_rcnn_runner import MetaFasterRCNNRunner
from sylph_tpu_torch.utils.convert_weights import (flatten_params,
                                                   jax_params_from_state_dict,
                                                   save_flat_npz,
                                                   state_dict_from_jax)

from torch_port_util import (few_torch_threads,  # noqa: F401
                             flat_paths, rcnn_pair, shrink_meta_cfg,
                             shrink_rcnn_cfg, tiny_model_pair)


def _roi_encoder(cfg):
    cfg.MODEL.META_LEARN.CODE_GENERATOR.NAME = "ROIEncoder"
    cfg.MODEL.META_LEARN.CODE_GENERATOR.TRANSFORMER_ENCODER.LAYERS = 2


def _cosine(cfg):
    cfg.MODEL.FCOS.L2_NORM_CLS_WEIGHT = True


def _deformable(cfg):
    cfg.MODEL.FCOS.USE_DEFORMABLE = True


def _one_stage(episodic, tweak=None):
    cfg = shrink_meta_cfg(get_default_cfg(), episodic)
    if tweak is not None:
        tweak(cfg)
    return build_model_from_cfg(cfg, device="cpu", seed=3)


def _two_stage(episodic, cosine=False):
    cfg = shrink_rcnn_cfg(MetaFasterRCNNRunner.get_default_cfg(), episodic,
                          cosine)
    return MetaFasterRCNNRunner(device="cpu").build_model(cfg)


MODELS = {
    "meta_fcos": lambda: _one_stage(True),
    "roi_encoder": lambda: _one_stage(True, _roi_encoder),
    "pretrain": lambda: _one_stage(False),
    "tfa_cosine": lambda: _one_stage(False, _cosine),
    "dcn": lambda: _one_stage(False, _deformable),
    "rcnn_episodic": lambda: _two_stage(True),
    "rcnn_plain": lambda: _two_stage(False),
    "rcnn_cosine": lambda: _two_stage(False, cosine=True),
}
PAIRS = {
    "roi_encoder": lambda: tiny_model_pair(tweak=_roi_encoder),
    "rcnn_cosine": lambda: rcnn_pair(episodic=False, cosine=True),
}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_flax_tree_back_to_the_same_state_dict(model):
    sd = MODELS[model]().state_dict()
    back = state_dict_from_jax(jax_params_from_state_dict(sd))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.float()), k


@pytest.mark.parametrize("model", sorted(PAIRS))
def test_state_dict_back_to_the_flax_tree(model, tmp_path):
    _, _, params, _, tmodel = PAIRS[model]()
    want = flat_paths(params)
    got = flat_paths(jax_params_from_state_dict(tmodel.state_dict()))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == np.shape(w), k
        assert np.array_equal(got[k], np.asarray(w, np.float32)), k
    # the flat file keys leaves as the JAX quality loops' _flatten does
    path = save_flat_npz(str(tmp_path / "w.npz"), tmodel.state_dict())
    flat = np.load(path)
    assert sorted(flat.files) == sorted(flatten_params(params))
    for k in flat.files:
        assert np.array_equal(flat[k], got[k]), k
