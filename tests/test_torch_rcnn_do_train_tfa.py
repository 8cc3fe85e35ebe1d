"""``TFAFasterRCNNRunner.do_train`` of the port against the JAX runner's:
the TFA-RCNN finetune, 2 iterations on coco_pretrain_train_all of a tiny
synthetic COCO tree from the same weights (tiny R-18, fp32), with the cosine
classifier (MODEL.FCOS.L2_NORM_CLS_WEIGHT) and the backbone, the proposal
generator and the box head's FC layers frozen. JAX on its 8-device test
mesh, the port with ``TPU.GRAD_ACCUM = 8`` and JAX's keys replayed: losses
rtol 1e-3, the trained rows atol 1e-4, everything else bit-identical.
"""

from sylph_tpu.runner.meta_faster_rcnn_runner import \
    TFAFasterRCNNRunner as JaxTFARunner
from sylph_tpu_torch.meta_faster_rcnn_runner import TFAFasterRCNNRunner

from test_torch_rcnn_do_train_plain import coco, train_both  # noqa: F401
from torch_port_util import (few_torch_threads,  # noqa: F401
                             jax_draws, rcnn_pair)


def test_tfa_do_train_matches_jax_runner(coco, monkeypatch):  # noqa: F811
    pair_ = rcnn_pair(episodic=False, cosine=True, seed=10)
    freeze = {"MODEL": {"BACKBONE": {"FREEZE": True},
                        "PROPOSAL_GENERATOR": {"FREEZE": True},
                        "ROI_HEADS": {"FREEZE_FEAT": True}}}
    trainable = train_both(pair_, JaxTFARunner(), TFAFasterRCNNRunner(
        device="cpu", draws=jax_draws(8)), monkeypatch, **freeze)
    assert trainable == {"box_head.cosine_weight",
                         "box_head.cosine_scale_param",
                         "box_head.bbox_pred.weight",
                         "box_head.bbox_pred.bias"}
