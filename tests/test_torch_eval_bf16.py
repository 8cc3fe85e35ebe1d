"""``TPU.EVAL_BF16_RESIDENT`` in the port against the JAX package's policy
(``sylph_tpu/utils/precision.py``), on the CPU:

  * ``bf16_resident`` casts what JAX's casts (tests/test_evaluation.py's
    cases: float32 leaves to bfloat16; integers, bools and bfloat16 left);
  * ``eval_resident_params`` is a no-op on the CPU, as JAX's on its CPU
    backend, and when the switch is off; off the CPU (a meta-device model
    stands in for the card) it casts, and ``eval_resident`` gives the same
    tensors their float32 storage back;
  * a bf16-held detector against JAX's ``bf16_resident`` params, from the
    supports to the dense outputs, within tests/test_torch_bf16.py's 5% of
    each output's range;
  * the ROIEncoder and the two-stage box head run on bf16-held weights
    within 5% of the float32-held ones;
  * an evaluation inside training, the policy forced on as on a card,
    leaves the float32 weights, the EMA and the momentum bit for bit as a
    run without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from sylph_tpu.config import get_default_cfg as jax_default_cfg
from sylph_tpu.models.meta_arch import MetaOneStageDetector as JaxDetector
from sylph_tpu.utils import precision as jprecision
from sylph_tpu_torch import build_model_from_cfg, get_default_cfg
from sylph_tpu_torch import runner as trunner
from sylph_tpu_torch.data import catalog
from sylph_tpu_torch.data.synthetic import make_synthetic_coco
from sylph_tpu_torch.meta_faster_rcnn_runner import (MetaFasterRCNNRunner,
                                                     eval_anchor_grid)
from sylph_tpu_torch.utils import precision

from torch_port_util import (few_torch_threads,  # noqa: F401
                             shrink_meta_cfg, shrink_rcnn_cfg,
                             tiny_model_pair)

REL_TOL = 0.05


def _images(seed, b=2, hw=(64, 64)):
    mean = np.array([103.530, 116.280, 123.675], np.float32)
    rng = np.random.RandomState(seed)
    return (mean + 2.0 * rng.randn(b, *hw, 3)).astype(np.float32)


class _Leaves(nn.Module):
    """tests/test_evaluation.py's tree as a module: a float32 parameter, an
    int32 and a bool buffer, a bf16 parameter, and a float32 buffer (the
    port's FrozenBN scale, a flax param there)."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(2, 2))
        self.low = nn.Parameter(torch.ones(2, dtype=torch.bfloat16))
        self.register_buffer("step", torch.zeros((), dtype=torch.int32))
        self.register_buffer("mask", torch.ones(2, dtype=torch.bool))
        self.register_buffer("scale", torch.ones(2))


def test_bf16_resident_casts_what_jax_casts():
    tree = {"w": jnp.ones((2, 2), jnp.float32),
            "low": jnp.ones((2,), jnp.bfloat16),
            "step": jnp.zeros((), jnp.int32),
            "mask": jnp.ones((2,), bool),
            "scale": jnp.ones((2,), jnp.float32)}
    want = jprecision.bf16_resident(tree)
    m = precision.bf16_resident(_Leaves())
    got = dict(m.named_parameters()) | dict(m.named_buffers())
    for k, v in want.items():
        assert got[k].dtype == {
            jnp.dtype(jnp.bfloat16): torch.bfloat16,
            jnp.dtype(jnp.int32): torch.int32,
            jnp.dtype(jnp.bool_): torch.bool}[v.dtype], k
    assert isinstance(m.w, nn.Parameter) and m.w.requires_grad


def test_eval_resident_params_policy():
    cfg = get_default_cfg()
    assert cfg.TPU.EVAL_BF16_RESIDENT == jax_default_cfg().TPU \
        .EVAL_BF16_RESIDENT is True
    # on the CPU: a no-op, as JAX's on its CPU backend
    assert precision.eval_resident_params(cfg, _Leaves()).w.dtype \
        == torch.float32
    with precision.eval_resident(cfg, _Leaves()) as m:
        assert m.w.dtype == torch.float32
    # off the CPU (a meta-device model stands in for the card): cast, and
    # the scope gives the same tensors their float32 storage back
    m = _Leaves().to("meta")
    w = m.w
    with precision.eval_resident(cfg, m):
        assert m.w is w and w.dtype == torch.bfloat16
        assert m.scale.dtype == torch.bfloat16
        assert m.step.dtype == torch.int32 and m.mask.dtype == torch.bool
    assert m.w is w and w.dtype == torch.float32
    assert m.scale.dtype == torch.float32
    assert precision.eval_resident_params(cfg, m).w.dtype == torch.bfloat16
    cfg.TPU.EVAL_BF16_RESIDENT = False
    assert precision.eval_resident_params(cfg, _Leaves().to("meta")) \
        .w.dtype == torch.float32


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def test_bf16_held_detector_matches_jax():
    """The tiny pair in bf16 activations: the port's weights held in bf16
    (``bf16_resident``) against JAX's ``bf16_resident`` params, from the
    supports to the dense outputs."""
    def bf16(cfg):
        cfg.TPU.COMPUTE_DTYPE = "bfloat16"

    jcfg, jmodel, params, tcfg, tmodel = tiny_model_pair(seed=8, tweak=bf16)
    rng = np.random.RandomState(8)
    sup = (rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
    boxes = np.array([[4, 6, 50, 44], [10, 8, 60, 58]], np.float32)
    valid = np.ones((2,), bool)
    query = (rng.rand(2, 128, 160, 3) * 255).astype(np.float32)

    def jax_chain(p, q, s, b):
        raw = jmodel.apply({"params": p}, s, b, jnp.asarray(valid), 2,
                           False, method=JaxDetector.forward_class_code)
        code = jmodel.apply({"params": p}, raw,
                            method=JaxDetector.normalize_code)
        return raw, code, jmodel.apply({"params": p}, q, code,
                                       method=JaxDetector.forward_instances)

    raw, code, out = jax.jit(jax_chain)(
        jprecision.bf16_resident(jax.tree.map(jnp.asarray, params)),
        jnp.asarray(query), jnp.asarray(sup), jnp.asarray(boxes))
    model = precision.bf16_resident(tmodel)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    with torch.no_grad():
        t_raw = model.forward_class_code(torch.from_numpy(sup),
                                         torch.from_numpy(boxes),
                                         torch.from_numpy(valid), 2)
        t_code = model.normalize_code(t_raw)
        t_out = model.forward_instances(torch.from_numpy(query), t_code)
    errs = {f"code {k}": _rel_err(t_code[k], code[k])
            for k in ("cls_conv", "cls_bias")}
    errs.update({f"raw {k}": _rel_err(t_raw[k], raw[k])
                 for k in ("cls_conv", "cls_bias")})
    for name in ("logits", "reg", "ctrness", "iou"):
        assert getattr(t_out, name).dtype == torch.float32
        errs[name] = _rel_err(getattr(t_out, name), getattr(out, name))
    assert max(errs.values()) <= REL_TOL, errs


def _close(got, want):
    return _rel_err(got.float(), want.float().numpy()) <= REL_TOL


def test_roi_encoder_codes_on_bf16_held_weights():
    """The ROIEncoder's Linear and LayerNorm layers run in float32 on
    bf16-held weights."""
    def roi(cfg):
        cfg.MODEL.META_LEARN.CODE_GENERATOR.NAME = "ROIEncoder"

    cfg = shrink_meta_cfg(get_default_cfg())
    roi(cfg)
    model = build_model_from_cfg(cfg, device="cpu")
    rng = np.random.RandomState(9)
    sup = torch.from_numpy((rng.rand(2, 64, 64, 3) * 255).astype(np.float32))
    boxes = torch.tensor([[4, 6, 50, 44], [10, 8, 60, 58.]])
    valid = torch.ones(2, dtype=torch.bool)
    with torch.no_grad():
        want = model.forward_class_code(sup, boxes, valid, 2)
        got = precision.bf16_resident(model).forward_class_code(
            sup, boxes, valid, 2)
    for k in ("cls_conv", "cls_bias"):
        assert got[k].dtype == torch.float32 and _close(got[k], want[k]), k


@pytest.mark.parametrize("episodic", [True, False])
def test_two_stage_on_bf16_held_weights(episodic):
    """The box head's Linear layers and background row run in float32 on
    bf16-held weights: its scores and deltas for the same pooled features
    within 5% of the float32-held head's range; the whole query path runs
    and gives finite float32 detections."""
    runner = MetaFasterRCNNRunner(device="cpu")
    cfg = shrink_rcnn_cfg(runner.get_default_cfg(), episodic)
    model = runner.build_model(cfg)
    head = model.box_head
    res = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    gen = torch.Generator().manual_seed(10)
    pooled = torch.randn(16, head.fc1.in_features // res ** 2, res, res,
                         generator=gen)
    code = ({"cls_conv": torch.randn(3, head.fc_dim, generator=gen)
             / head.fc_dim ** 0.5,
             "cls_bias": torch.randn(3, generator=gen)}
            if episodic else None)
    with torch.no_grad():
        want = head(pooled, code)
        precision.bf16_resident(model)
        got = head(pooled, code)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and _close(g, w)

    grid = eval_anchor_grid(cfg)
    args = (torch.as_tensor(grid.anchors), tuple(grid.level_splits),
            torch.tensor([[64, 96]], dtype=torch.int32), 50)
    q = torch.from_numpy(_images(11, b=1, hw=(64, 96)))
    with torch.no_grad():
        if episodic:
            det = model.forward_instances(q, model.normalize_code(
                model.forward_class_code(
                    torch.from_numpy(_images(12, hw=(64, 64))),
                    torch.tensor([[5, 5, 50, 50.]] * 2),
                    torch.ones(2, dtype=torch.bool), 2)), *args)
        else:
            det = model.forward_base_instances(q, *args)
    assert det.scores.dtype == torch.float32
    assert torch.isfinite(det.scores).all() and torch.isfinite(det.boxes).all()


# ------------------------------------- evaluation inside a training run
@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    make_synthetic_coco(root, n_train=24, n_val=4, img_hw=(96, 128))
    catalog.DatasetCatalog.clear()
    catalog.MetadataCatalog.clear()
    catalog.register_all_coco(root)
    return root


def test_eval_in_training_keeps_float32_weights(coco, monkeypatch):
    """The bf16 policy forced on, as on a card: a run of 3 steps that
    evaluates after steps 1 and 2 ends with the bits of the same run with
    evaluation off (weights, EMA, momentum), and each evaluation saw its
    weights in bf16."""
    cfg = shrink_meta_cfg(get_default_cfg())
    cfg.DATASETS.TRAIN = ["coco_meta_train_base"]
    cfg.DATASETS.TEST = ["coco_meta_val_novel"]
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.MAX_ITER = 3
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.CHECKPOINT_PERIOD = 100
    cfg.MODEL_EMA.ENABLED = True
    cfg.TPU.TRAIN_CANVAS = [96, 96]
    cfg.INPUT.MIN_SIZE_TRAIN = [80]
    monkeypatch.setattr(precision, "_policy_on", lambda cfg, model: True)
    seen = []
    orig = trunner.MetaFCOSRunner._do_test_episodic

    def recording(self, cfg, model):
        seen.append({p.dtype for p in model.parameters()})
        return orig(self, cfg, model)

    monkeypatch.setattr(trunner.MetaFCOSRunner, "_do_test_episodic",
                        recording)
    states = {}
    for period in (1, 0):
        cfg.TEST.EVAL_PERIOD = period
        runner = trunner.MetaFCOSRunner(device="cpu")
        model = build_model_from_cfg(cfg, device="cpu", init="train")
        _, state = runner.do_train(cfg, model)
        states[period] = state.state_dict()
    assert seen == [{torch.bfloat16}] * 2
    a, b = states[1], states[0]
    assert a["step"] == b["step"] == 3
    for part in ("model", "ema"):
        for k, v in a[part].items():
            assert v.dtype == b[part][k].dtype
            assert torch.equal(v, b[part][k]), (part, k)
    for k, v in a["tx"]["trace"].items():
        assert torch.equal(v, b["tx"]["trace"][k]), k
