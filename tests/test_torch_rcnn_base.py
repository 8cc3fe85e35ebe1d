"""The port's plain two-stage path against the JAX package's FewShotRCNN on
the same weights and inputs, in float32 on the CPU: the detections of
``forward_base_instances`` with the linear and the TFA cosine classifier,
and the two-stage heads' training initializers.

Tolerances: detections boxes 1e-3, scores 1e-4, classes and valid equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.models import rcnn as jrcnn
from sylph_tpu_torch.models import rcnn

from test_torch_rcnn import assert_detections_close, query_images
from torch_port_util import few_torch_threads, rcnn_pair  # noqa: F401


@pytest.mark.parametrize("cosine", [False, True])
def test_forward_base_instances_matches_jax(cosine):
    """The plain two-stage path with the linear and the TFA cosine
    classifier (6 classes + background)."""
    jcfg, jmodel, params, _, tmodel = rcnn_pair(episodic=False,
                                                cosine=cosine, seed=5)
    assert ("cosine_weight" in params["box_head"]) == cosine
    rng = np.random.RandomState(9)
    imgs = query_images(rng, 2, (64, 96))
    sizes = np.array([[64, 96], [64, 70]], np.int32)
    grid = rcnn.build_anchor_grid((64, 96))
    kw = dict(rpn_post_nms=50, score_thresh=1e-4, nms_thresh=0.5,
              max_dets=20, rpn_pre_nms=100)
    want = jmodel.apply({"params": params}, jnp.asarray(imgs),
                        jnp.asarray(grid.anchors), grid.level_splits,
                        jnp.asarray(sizes),
                        method=jrcnn.FewShotRCNN.forward_base_instances, **kw)
    with torch.no_grad():
        got = tmodel.forward_base_instances(
            torch.from_numpy(imgs), torch.from_numpy(grid.anchors),
            grid.level_splits, torch.from_numpy(sizes), **kw)
    assert_detections_close(got, want)



def test_train_init_follows_flax_distributions():
    """``init="train"``: the flax initializers' distributions on the
    two-stage heads (normal 0.01 RPN and cls_score, 0.001 bbox_pred, zero
    biases, cosine scale 20)."""
    from sylph_tpu_torch.meta_faster_rcnn_runner import (
        MetaFasterRCNNRunner, build_rcnn_model_from_cfg)
    from torch_port_util import shrink_rcnn_cfg

    cfg = shrink_rcnn_cfg(MetaFasterRCNNRunner.get_default_cfg(), False,
                          cosine=True)
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 512
    model = build_rcnn_model_from_cfg(cfg, device="cpu", init="train")
    sd = model.state_dict()
    assert abs(float(sd["rpn_head.conv.weight"].std()) - 0.01) < 5e-4
    assert abs(float(sd["box_head.bbox_pred.weight"].std()) - 0.001) < 1e-4
    assert abs(float(sd["box_head.cosine_weight"].std()) - 0.01) < 5e-4
    fc1 = sd["box_head.fc1.weight"]
    assert abs(float(fc1.std()) * np.sqrt(fc1.shape[1]) - 1.0) < 0.02
    assert float(sd["box_head.cosine_scale_param"]) == 20.0
    assert not sd["box_head.fc1.bias"].any()
    assert not sd["rpn_head.objectness.bias"].any()
