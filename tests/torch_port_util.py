"""Helpers shared by the tests that hold sylph_tpu_torch against sylph_tpu.

Weights are made once, as flax param trees of numpy arrays, and carried to
the port with ``sylph_tpu_torch.utils.convert_weights.state_dict_from_jax``;
inputs are made from a seed with numpy and handed to both packages.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads for the module's tests, restored after: the suite
    runs in several worker processes on one host, and each worker's torch
    would otherwise start a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def to_numpy(tree):
    """A flax param tree as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def merge_trees(a, b):
    """Deep union of two nested dicts (``b`` wins on shared leaves)."""
    out = dict(a)
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_trees(out[k], v)
        else:
            out[k] = v
    return out


def randomize(params, rng, gains=None):
    """Replace every leaf by detectron2-scaled random values: fan-in scaled
    conv and Dense kernels (times ``gains[module path]`` where given),
    scales near 1, biases near 0; the two-stage box head's rows at unit
    norm and its cosine scale near 20."""

    def leaf(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            gain = (gains or {}).get("/".join(str(k.key) for k in path[:-1]),
                                     1.0)
            return (rng.randn(*shape) * gain
                    / np.sqrt(fan_in)).astype(np.float32)
        if name in ("cosine_weight", "bg_weight"):
            return (rng.randn(*shape) / np.sqrt(shape[-1])).astype(np.float32)
        if name == "cosine_scale_param":
            return np.asarray(20.0 + rng.randn(), np.float32)
        if name == "meta_bias_value":
            return np.asarray(-4.6 + 0.1 * rng.randn(), np.float32)
        if name == "scale":
            return np.asarray(1.0 + 0.1 * rng.randn(*shape), np.float32)
        return np.asarray(0.1 * rng.randn(*shape), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, to_numpy(params))


def shrink_meta_cfg(cfg, episodic: bool = True):
    """The finetune (or, with ``episodic=False``, the pretrain) config at
    test size: R-18, one-conv towers, 2 shots, 64x64 support and 128x160
    eval canvases, fp32, the thresholds opened so that random weights give
    detections, and no output directory."""
    cfg.merge_from_file("sylph://COCO-Detection/Meta-FCOS/Meta-FCOS-"
                        + ("finetune" if episodic else "pretrain") + ".yaml")
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.FCOS.NUM_CLS_CONVS = 1
    cfg.MODEL.FCOS.NUM_BOX_CONVS = 1
    cfg.MODEL.FCOS.NUM_CLASSES = 6
    cfg.MODEL.FCOS.INFERENCE_TH_TEST = 0.015
    cfg.MODEL.META_LEARN.SHOT = 2
    cfg.MODEL.META_LEARN.EVAL_SHOT = 2
    cfg.MODEL.META_LEARN.CODE_GENERATOR.TOWER_LAYERS = [["GN", "ReLU"]]
    cfg.TPU.TRAIN_CANVAS = [128, 128]
    cfg.TPU.EVAL_CANVAS = [128, 160]
    cfg.TPU.SUPPORT_CANVAS = [64, 64]
    cfg.TPU.MAX_GT_BOXES = 10
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.EVAL_BATCH = 4
    cfg.INPUT.MIN_SIZE_TRAIN = [96]
    cfg.INPUT.MIN_SIZE_TEST = 96
    cfg.INPUT.MAX_SIZE_TEST = 160
    cfg.TEST.REPEAT_TEST = 1
    cfg.OUTPUT_DIR = ""
    return cfg


def tiny_model_pair(episodic: bool = True, seed: int = 0, tweak=None):
    """The same random weights in a JAX model and a port model (CPU) on
    ``shrink_meta_cfg`` configs, each passed through ``tweak(cfg)`` when
    given: (jax cfg, jax model, params, port cfg, port model). Params are
    the union of the base, the code-generation and (but for the ROIEncoder,
    whose codes are final) the normalization init, randomized
    detectron2-style."""
    import jax.numpy as jnp

    from sylph_tpu.config import get_default_cfg as jax_default_cfg
    from sylph_tpu.models.meta_arch import MetaOneStageDetector
    from sylph_tpu.runner.meta_fcos_runner import build_model_from_cfg
    from sylph_tpu_torch import build_model_from_cfg as torch_build
    from sylph_tpu_torch import get_default_cfg
    from sylph_tpu_torch.utils.convert_weights import load_jax_params

    jcfg = shrink_meta_cfg(jax_default_cfg(), episodic)
    tcfg = shrink_meta_cfg(get_default_cfg(), episodic)
    if tweak is not None:
        tweak(jcfg)
        tweak(tcfg)
    jmodel = build_model_from_cfg(jcfg)
    key = jax.random.PRNGKey(seed)
    query = jnp.zeros((1, *jcfg.TPU.EVAL_CANVAS, 3))
    params = to_numpy(jax.jit(lambda r: jmodel.init(r, query))(key)["params"])
    if episodic:
        shot = jcfg.MODEL.META_LEARN.SHOT
        sup = jnp.zeros((shot, *jcfg.TPU.SUPPORT_CANVAS, 3))
        code = jax.jit(lambda r: jmodel.init(
            r, sup, jnp.zeros((shot, 4)), jnp.ones((shot,), bool), shot,
            method=MetaOneStageDetector.forward_class_code))(key)
        params = merge_trees(params, to_numpy(code["params"]))
        if jmodel.code_generator_name != "ROIEncoder":
            norm = jax.jit(lambda r: jmodel.init(
                r, {"cls_conv": jnp.zeros((1, 256)),
                    "cls_bias": jnp.zeros((1,))},
                method=MetaOneStageDetector.normalize_code))(key)
            params = merge_trees(params, to_numpy(norm["params"]))
    params = randomize(params, np.random.RandomState(seed))
    tmodel = load_jax_params(torch_build(tcfg, device="cpu"), params)
    return jcfg, jmodel, params, tcfg, tmodel


def register_both(root: str) -> None:
    """Register one synthetic COCO root in both packages' catalogs."""
    from sylph_tpu.data import catalog as jax_catalog
    from sylph_tpu_torch.data import catalog

    for cat in (jax_catalog, catalog):
        cat.DatasetCatalog.clear()
        cat.MetadataCatalog.clear()
        cat.register_all_coco(root)


def make_meta_env(root: str):
    """The meta-test fixture: a synthetic COCO tree at ``root`` registered
    in both catalogs, ``tiny_model_pair(seed=2)`` and both mappers."""
    from sylph_tpu.runner.meta_fcos_runner import _mapper as jax_mapper
    from sylph_tpu_torch.data.synthetic import make_synthetic_coco
    from sylph_tpu_torch.runner import _mapper

    make_synthetic_coco(root, n_train=24, n_val=8, img_hw=(96, 128),
                        n_empty_val=2)
    register_both(root)
    jcfg, jmodel, params, tcfg, tmodel = tiny_model_pair(seed=2)
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, tcfg=tcfg,
                tmodel=tmodel, jmapper=jax_mapper(jcfg),
                mapper=_mapper(tcfg))


def datasets_both(name: str):
    """One registered dataset from each package's catalog; the global
    numpy RNG (the split "all" samples novel support from it) is seeded
    alike before each load."""
    from sylph_tpu.data import catalog as jax_catalog
    from sylph_tpu_torch.data import catalog

    np.random.seed(5)
    jd = jax_catalog.DatasetCatalog.get(name)
    np.random.seed(5)
    return jd, catalog.DatasetCatalog.get(name)


def assert_results_close(got, want, atol=1e-4):
    """Two ``eval_results`` dicts: the same keys, every value within
    ``atol`` (NaN where the other is NaN)."""
    import math

    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if math.isnan(w):
            assert math.isnan(got[k]), k
        else:
            assert abs(got[k] - w) <= atol, (k, got[k], w)


# ------------------------------------------------------------ train steps
# shared by tests/test_torch_train.py and tests/test_torch_train_episodic.py
CANVAS = (64, 96)
SUPPORT = (64, 64)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def flat_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat_paths(v, p))
        else:
            out[p] = v
    return out


def freeze_with(jcfg, **kw):
    from sylph_tpu.runner import meta_fcos_runner as jrunner
    f = jrunner._freeze_cfg(jcfg)
    f.update(kw)
    return f


FROZEN_BN = re.compile(r"/(bn\d+|stem_bn1|shortcut_bn)/(scale|bias)$")


def jax_mask(params, fcfg):
    """JAX's freeze mask with every FrozenBN leaf frozen."""
    from sylph_tpu.train import optimizer as jopt
    mask = jopt.build_freeze_mask(params, fcfg)
    return jax.tree_util.tree_map_with_path(
        lambda path, m: bool(m) and not FROZEN_BN.search(
            "/" + "/".join(str(k.key) for k in path)), mask)


def jax_tx(params, kw):
    """``jopt.build_optimizer`` with its freeze mask taken from
    ``jax_mask``: the same chain, masked the same way."""
    from sylph_tpu.train import optimizer as jopt
    kw = dict(kw)
    fcfg = kw.pop("freeze_cfg")
    inner, _ = jopt.build_optimizer(params, **kw)
    mask = jax_mask(params, fcfg)
    return optax.chain(
        optax.masked(optax.set_to_zero(), jax.tree.map(lambda m: not m,
                                                       mask)),
        optax.masked(inner, mask))


def _aug(rng, n):
    ops = np.stack([rng.choice(8, 2, replace=False) for _ in range(n)])
    params = np.zeros((n, 2), np.float32)
    for i, row in enumerate(ops):
        for j, op in enumerate(row):
            params[i, j] = {6: 4.0, 7: 128.0}.get(int(op),
                                                  1.0 + rng.uniform(-.4, .4))
    sizes = np.stack([rng.randint(40, CANVAS[0] + 1, n),
                      rng.randint(50, CANVAS[1] + 1, n)], -1).astype(np.int32)
    return ops.astype(np.int32), params, sizes


def _gt(rng, b, m=4):
    xy = rng.uniform(0, 40, (b, m, 2))
    wh = rng.uniform(12, 50, (b, m, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, 5, (b, m)).astype(np.int32)
    valid = np.ones((b, m), bool)
    valid[:, -1] = False
    return boxes, labels, valid


def _images(rng, b, hw):
    return rng.randint(60, 200, (b, *hw, 3)).astype(np.uint8)


def pretrain_batch(seed=0, b=4):
    rng = np.random.RandomState(seed)
    boxes, labels, valid = _gt(rng, b)
    ops, params, sizes = _aug(rng, b)
    return {"images": _images(rng, b, CANVAS), "gt_boxes": boxes,
            "gt_labels": labels, "gt_valid": valid, "aug_ops": ops,
            "aug_params": params, "image_sizes": sizes}


def episodic_batch(seed=0, e=4, shot=2):
    rng = np.random.RandomState(seed)
    boxes, labels, valid = _gt(rng, e)
    ids = np.array([0, 2, 3, 4], np.int32)[:e]
    labels[:, 0] = ids  # each query shows its own class
    labels[:, 1] = ids[::-1]
    ops, params, sizes = _aug(rng, e)
    sx = rng.uniform(2, 20, (e * shot, 2))
    return {
        "support_images": _images(rng, e * shot, SUPPORT),
        "support_boxes": np.concatenate([sx, sx + 30], -1).astype(np.float32),
        "support_box_valid": np.ones((e * shot,), bool),
        "query_images": _images(rng, e, CANVAS), "query_gt_boxes": boxes,
        "query_gt_labels": labels, "query_gt_valid": valid,
        "episode_class_ids": ids, "query_aug_ops": ops,
        "query_aug_params": params, "query_image_sizes": sizes}


def torch_batch(batch):
    from sylph_tpu_torch.data.loader import batch_to_device
    return batch_to_device(batch, "cpu")


def opt_kw(jcfg, freeze):
    return dict(base_lr=0.02, momentum=0.9, weight_decay=1e-4,
                warmup_iters=2, warmup_factor=0.25, steps=(2,), gamma=0.5,
                clip_grad_norm=1.0, freeze_cfg=freeze)


def run_steps(pair_, episodic, batch, n=3, grad_accum=1, freeze_kw=None,
              snnl=False, distill=0.0):
    """n steps in both packages from the same weights; returns the losses
    per step as (jax, port) pairs, JAX's parameters after as a port
    state_dict, the port's model and its train state."""
    from sylph_tpu.ops.locations import build_location_grid as jax_grid
    from sylph_tpu.parallel.mesh import create_mesh, shard_batch
    from sylph_tpu.runner import meta_fcos_runner as jrunner
    from sylph_tpu.train import steps as jsteps
    from sylph_tpu.train.train_state import create_train_state as jax_state
    from sylph_tpu_torch import runner as trunner
    from sylph_tpu_torch.train import optimizer as topt
    from sylph_tpu_torch.train import steps as tsteps
    from sylph_tpu_torch.train.train_state import TrainState
    from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax
    jcfg, jmodel, params, tcfg, tmodel = pair_
    jcfg, tcfg = jcfg.clone(), tcfg.clone()
    for c in (jcfg, tcfg):
        c.defrost()
        c.MODEL.META_LEARN.CODE_GENERATOR.CONTRASTIVE_LOSS = \
            "snnl" if snnl else ""
        c.MODEL.META_LEARN.CODE_GENERATOR.DISTILLATION_LOSS_WEIGHT = distill
    freeze = freeze_with(jcfg, **(freeze_kw or {}))
    lc_j, lc_t = jrunner._loss_cfg(jcfg), trunner._loss_cfg(tcfg)
    grid = jax_grid(CANVAS, (8, 16, 32, 64, 128), [64, 128, 256, 512])
    kw = opt_kw(jcfg, freeze)

    if snnl:
        jmodel = jrunner.build_model_from_cfg(jcfg)
    tx = jax_tx(params, kw)
    jst = jax_state(jax.tree.map(jnp.array, params), tx)
    mesh = create_mesh(1)
    model = copy.deepcopy(tmodel)
    if snnl:
        model.code_generator.contrastive_loss = "snnl"
    ttx, _ = topt.build_optimizer(model, **kw)
    tst = TrainState(model, ttx)
    if episodic:
        kernel_t = (trunner.MetaFCOSRunner._cls_logits_kernel(model)
                    if distill else None)
        kernel_j = (jrunner.MetaFCOSRunner._cls_logits_kernel(params)
                    if distill else None)
        jstep = jsteps.make_episodic_train_step(
            jmodel, tx, grid, lc_j, mesh, num_shots=2,
            pretrained_kernel=kernel_j, grad_accum=grad_accum)
        tstep = tsteps.make_episodic_train_step(
            model, grid, lc_t, num_shots=2, pretrained_kernel=kernel_t,
            grad_accum=grad_accum)
    else:
        jstep = jsteps.make_pretrain_train_step(
            jmodel, tx, grid, lc_j, mesh, grad_accum=grad_accum)
        tstep = tsteps.make_pretrain_train_step(model, grid, lc_t,
                                                grad_accum=grad_accum)
    losses = []
    for i in range(n):
        sb = shard_batch(mesh, batch)
        if episodic:
            jst, jm = jstep(jst, sb, jax.random.PRNGKey(i))
        else:
            jst, jm = jstep(jst, sb)
        _, tm = tstep(tst, torch_batch(batch))
        losses.append(({k: float(v) for k, v in jm.items()},
                       {k: float(v) for k, v in tm.items()}))
    js = jst.unpack() if hasattr(jst, "unpack") else jst
    return (losses, state_dict_from_jax(jax.tree.map(np.asarray, js.params)),
            model, tst)


def check_run(result, start_model):
    """Losses within rtol 1e-4, trainable parameters within PARAM_TOL of
    JAX's, frozen ones bit-identical in both packages; returns the
    trainable names."""
    losses, want, model, tst = result
    for jm, tm in losses:
        assert sorted(jm) == sorted(tm)
        for k in jm:
            assert np.isfinite(tm[k])
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    start = dict(start_model.named_parameters())
    trainable = set(tst.tx.names)
    moved = 0
    for n, p in model.named_parameters():
        if n in trainable:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       err_msg=n, **PARAM_TOL)
            moved += int(not torch.equal(p, start[n]))
        else:
            assert torch.equal(p, start[n]), n
            assert torch.equal(want[n], start[n]), n
    assert moved > 0 and tst.step == len(losses)
    return trainable


def check_episodic_steps(pair_, **kw):
    """``run_steps`` on the episodic batch, checked by ``check_run``; the
    finetune freeze leaves the code generator trainable and the bbox tower
    frozen, and the snnl and distillation losses show when asked for."""
    result = run_steps(pair_, True, episodic_batch(1), **kw)
    trainable = check_run(result, pair_[4])
    assert "code_generator.tower_conv0.weight" in trainable
    assert "fcos_head.bbox_tower.conv0.weight" not in trainable
    if kw.get("snnl"):
        assert "loss_snnl" in result[0][0][1]
    if kw.get("distill"):
        assert "loss_gen_distill" in result[0][0][1]


# ------------------------------------------------------------- two-stage
# The two-stage heads read FPN maps of O(100) without a normalization: their
# first layers and their box regressions are scaled down as the port's
# init_random_weights scales them, so that proposals stay near the anchors
# and the class softmax stays spread.
RCNN_GAINS = {"rpn_head/conv": 0.01, "rpn_head/anchor_deltas": 0.1,
              "box_head/fc1": 0.01, "box_head/bbox_pred": 0.1}


def shrink_rcnn_cfg(cfg, episodic: bool = True, cosine: bool = False):
    """The LVIS Meta-RCNN finetune (or pretrain) config at test size: R-18,
    fc_dim and codes of 64, one-conv code tower, 6 classes, 2 shots, 64x64
    train and support canvases, a 64x96 eval canvas, RPN top-k 100 / 50,
    20 detections, fp32, query batches of 2, no output directory."""
    cfg.merge_from_file("sylph://LVISv1-Detection/Meta-RCNN/Meta-RCNN-FPN-"
                        + ("finetune" if episodic else "pretrain") + ".yaml")
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
    cfg.MODEL.META_LEARN.CODE_GENERATOR.OUT_CHANNEL = 64
    cfg.MODEL.META_LEARN.CODE_GENERATOR.TOWER_LAYERS = [["GN", "ReLU"]]
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 6
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.FCOS.L2_NORM_CLS_WEIGHT = cosine
    cfg.MODEL.META_LEARN.SHOT = 2
    cfg.MODEL.META_LEARN.EVAL_SHOT = 2
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 100
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 50
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 100
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 50
    cfg.TEST.DETECTIONS_PER_IMAGE = 20
    cfg.TPU.TRAIN_CANVAS = [64, 64]
    cfg.TPU.SUPPORT_CANVAS = [64, 64]
    cfg.TPU.EVAL_CANVAS = [64, 96]
    cfg.TPU.MAX_GT_BOXES = 10
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.EVAL_BATCH = 2
    cfg.INPUT.MIN_SIZE_TEST = 64
    cfg.INPUT.MAX_SIZE_TEST = 96
    cfg.TEST.REPEAT_TEST = 1
    cfg.OUTPUT_DIR = ""
    return cfg


def rcnn_pair(episodic: bool = True, cosine: bool = False, seed: int = 0):
    """The same random weights in a JAX ``FewShotRCNN`` (initialised by the
    JAX runner through ``forward_episodic_train`` or
    ``forward_pretrain_train``) and the port's (CPU), on ``shrink_rcnn_cfg``
    configs: (jax cfg, jax model, params, port cfg, port model)."""
    from sylph_tpu.runner.meta_faster_rcnn_runner import \
        MetaFasterRCNNRunner as JaxRunner
    from sylph_tpu_torch.meta_faster_rcnn_runner import MetaFasterRCNNRunner
    from sylph_tpu_torch.utils.convert_weights import load_jax_params

    jcfg = shrink_rcnn_cfg(JaxRunner.get_default_cfg(), episodic, cosine)
    tcfg = shrink_rcnn_cfg(MetaFasterRCNNRunner.get_default_cfg(), episodic,
                           cosine)
    jmodel, params = JaxRunner().build_model(jcfg)
    params = randomize(params, np.random.RandomState(seed), RCNN_GAINS)
    tmodel = load_jax_params(
        MetaFasterRCNNRunner(device="cpu").build_model(tcfg), params)
    return jcfg, jmodel, params, tcfg, tmodel


# ------------------------------------------------------- two-stage training
def rcnn_train_cfg(cfg):
    """A ``shrink_rcnn_cfg`` config at the two-stage training tests' size:
    a 128x128 train canvas, RPN top-k 100 / 64, ROI batches of 32."""
    cfg = cfg.clone()
    cfg.defrost()
    cfg.TPU.TRAIN_CANVAS = [128, 128]
    cfg.INPUT.MIN_SIZE_TRAIN = [96]
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 100
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 64
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 32
    return cfg


class JaxDraws:
    """A draw source (``sylph_tpu_torch.models.rcnn.SampleDraws``' methods)
    that replays the JAX two-stage step's keys: the step key (the train
    loop's ``fold_in(PRNGKey(7), iteration)``), folded with the rank on a
    mesh of more than one device, then ``fold_in(., 1)`` split into the RPN
    key (split per image) and the ROI key (folded with the image, split into
    the subsample and tie-break keys)."""

    def __init__(self, step_key, rank=None):
        if rank is not None:
            step_key = jax.random.fold_in(step_key, rank)
        self.k_rpn, self.k_roi = jax.random.split(
            jax.random.fold_in(step_key, 1))

    def rpn(self, b, k):
        keys = jax.random.split(self.k_rpn, b)
        return torch.from_numpy(np.stack(
            [np.asarray(jax.random.uniform(key, (k,))) for key in keys]))

    def roi(self, b, n):
        sub, tie = [], []
        for i in range(b):
            k_sub, k_tie = jax.random.split(jax.random.fold_in(self.k_roi, i))
            sub.append(np.asarray(jax.random.uniform(k_sub, (n,))))
            tie.append(np.asarray(jax.random.uniform(k_tie, (n,))))
        return torch.from_numpy(np.stack(sub)), torch.from_numpy(np.stack(tie))


def train_loop_key(iteration):
    """The JAX train loop's key for ``iteration``."""
    return jax.random.fold_in(jax.random.PRNGKey(7), iteration)


def jax_draws(mesh_size):
    """The port's draws factory replaying a JAX run on ``mesh_size``
    devices, one micro-group per device."""
    return lambda it, g, m: JaxDraws(train_loop_key(it),
                                     g if mesh_size > 1 else None)


def rcnn_train_batch(episodic, seed=0, n=2, shot=2, canvas=(128, 128),
                     support=(64, 64), max_gt=10):
    """A two-stage training batch from a numpy seed: ``n`` images (or
    episodes of ``shot`` supports and one query each) with 4-6 valid GT
    boxes of 20-70 px, pixels near the BGR mean, drawn RandAugment ops that
    the two-stage steps do not read; episode ``i`` shows class ``ids[i]``
    in its query."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, canvas[0] - 72, (n, max_gt, 2))
    wh = rng.uniform(20, 70, (n, max_gt, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, 6, (n, max_gt)).astype(np.int32)
    valid = np.zeros((n, max_gt), bool)
    for i in range(n):
        valid[i, :4 + i % 3] = True
    mean = np.float32([103.530, 116.280, 123.675])
    images = (mean + rng.uniform(-20, 20, (n, *canvas, 3))).astype(np.uint8)
    ops = np.zeros((n, 2), np.int32)
    aug = dict(aug_ops=ops, aug_params=np.ones((n, 2), np.float32),
               image_sizes=np.tile(np.int32(canvas), (n, 1)))
    if not episodic:
        return {"images": images, "gt_boxes": boxes, "gt_labels": labels,
                "gt_valid": valid, **aug}
    ids = np.arange(1, n + 1, dtype=np.int32)
    labels[:, 0] = ids
    sx = rng.uniform(2, 20, (n * shot, 2))
    return {
        "support_images": (mean + rng.uniform(
            -20, 20, (n * shot, *support, 3))).astype(np.uint8),
        "support_boxes": np.concatenate([sx, sx + 36], -1).astype(np.float32),
        "support_box_valid": np.ones((n * shot,), bool),
        "query_images": images, "query_gt_boxes": boxes,
        "query_gt_labels": labels, "query_gt_valid": valid,
        "episode_class_ids": ids,
        **{"query_" + k: v for k, v in aug.items()}}


def jax_rcnn_loss_apply(jmodel, jcfg, episodic):
    """``loss_apply(params, batch, rng, axis)`` as the JAX runner's
    ``do_train`` builds it for the config's mode."""
    from sylph_tpu.models.rcnn import FewShotRCNN, build_anchor_grid
    from sylph_tpu.structures import GTBoxes

    tc = tuple(jcfg.TPU.TRAIN_CANVAS)
    grid = build_anchor_grid(tc)
    anchors = jnp.asarray(grid.anchors)
    rpn = jcfg.MODEL.RPN
    roi_batch = jcfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE

    def loss_apply(p, batch, rng, axis):
        key = "query_images" if episodic else "images"
        sizes = jnp.tile(jnp.asarray([list(tc)]), (batch[key].shape[0], 1))
        if not episodic:
            gt = GTBoxes(batch["gt_boxes"], batch["gt_labels"],
                         batch["gt_valid"])
            return jmodel.apply(
                {"params": p}, batch["images"], gt, rng, anchors,
                grid.level_splits, sizes, axis, rpn.POST_NMS_TOPK_TRAIN,
                roi_batch, rpn_pre_nms=rpn.PRE_NMS_TOPK_TRAIN,
                method=FewShotRCNN.forward_pretrain_train)
        labels = batch["query_gt_labels"]
        in_ep = jnp.any(labels[..., None]
                        == batch["episode_class_ids"][None, None, :], -1)
        gt = GTBoxes(batch["query_gt_boxes"], labels,
                     batch["query_gt_valid"] & in_ep)
        return jmodel.apply(
            {"params": p}, batch["support_images"], batch["support_boxes"],
            batch["support_box_valid"], batch["query_images"], gt,
            batch["episode_class_ids"], rng, anchors, grid.level_splits,
            sizes, jcfg.MODEL.META_LEARN.SHOT, axis,
            rpn.POST_NMS_TOPK_TRAIN, roi_batch,
            rpn_pre_nms=rpn.PRE_NMS_TOPK_TRAIN,
            method=FewShotRCNN.forward_episodic_train)

    return loss_apply


def run_rcnn_steps(pair_, episodic, batch, n=2, grad_accum=1, freeze_kw=None,
                   snnl=False):
    """``n`` two-stage steps in both packages from the same weights: JAX's
    ``_sgd_step_factory`` on a mesh of ``grad_accum`` devices, the port's
    step with as many micro-groups and the replayed draws. Returns what
    ``run_steps`` returns."""
    from sylph_tpu.parallel.mesh import create_mesh, shard_batch
    from sylph_tpu.runner.meta_faster_rcnn_runner import \
        MetaFasterRCNNRunner as JaxRunner
    from sylph_tpu.train.steps import finalize_step
    from sylph_tpu.train.train_state import create_train_state as jax_state
    from sylph_tpu_torch.meta_faster_rcnn_runner import MetaFasterRCNNRunner
    from sylph_tpu_torch.train import optimizer as topt
    from sylph_tpu_torch.train.train_state import TrainState
    from sylph_tpu_torch.utils.convert_weights import state_dict_from_jax
    jcfg, jmodel, params, tcfg, tmodel = pair_
    jcfg, tcfg = rcnn_train_cfg(jcfg), rcnn_train_cfg(tcfg)
    model = copy.deepcopy(tmodel)
    if snnl:
        for c in (jcfg, tcfg):
            c.MODEL.META_LEARN.CODE_GENERATOR.CONTRASTIVE_LOSS = "snnl"
        jmodel = jmodel.clone(code_generator_kwargs=dict(
            jmodel.code_generator_kwargs, contrastive_loss="snnl"))
        model.code_generator.contrastive_loss = "snnl"
    tcfg.TPU.GRAD_ACCUM = grad_accum
    kw = opt_kw(jcfg, freeze_with(jcfg, **(freeze_kw or {})))
    tx = jax_tx(params, kw)
    jst = jax_state(jax.tree.map(jnp.array, params), tx)
    mesh = create_mesh(grad_accum)
    jstep = finalize_step(JaxRunner._sgd_step_factory(
        tx, jax_rcnn_loss_apply(jmodel, jcfg, episodic)), mesh,
        with_rng=True)
    ttx, _ = topt.build_optimizer(model, **kw)
    tst = TrainState(model, ttx)
    tstep = MetaFasterRCNNRunner(device="cpu", draws=jax_draws(
        grad_accum)).make_train_step(tcfg, model)
    losses = []
    for i in range(n):
        jst, jm = jstep(jst, shard_batch(mesh, batch), train_loop_key(i))
        _, tm = tstep(tst, torch_batch(batch))
        losses.append(({k: float(v) for k, v in jm.items()},
                       {k: float(v) for k, v in tm.items()}))
    js = jst.unpack() if hasattr(jst, "unpack") else jst
    return (losses, state_dict_from_jax(jax.tree.map(np.asarray, js.params)),
            model, tst)


# ------------------------------------------------------ data-parallel ranks
# Each rank is a fresh interpreter that imports the test file by its path,
# joins a gloo group through a file:// store under the test's tmp_path (no
# port to race for between xdist workers), calls the file's ``fn(group,
# out_dir, **kwargs)`` and saves what it returns. Test files that hold
# rank functions import nothing of JAX at module level.
RANK_MAIN = r"""
import importlib.util, sys
import torch
torch.set_num_threads(1)
path, fn, rank, world, url, out = sys.argv[1:7]
spec = importlib.util.spec_from_file_location("rank_module", path)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
from sylph_tpu_torch.parallel import create_mesh
group = create_mesh("cpu", init_method=url, rank=int(rank),
                    world_size=int(world))
kwargs = torch.load(f"{out}/kwargs.pt", weights_only=False)
result = getattr(mod, fn)(group, out, **kwargs)
torch.save(result, f"{out}/rank{rank}.pt")
group.close()
"""


def spawn_ranks(script, fn, out_dir, world=2, timeout=300, **kwargs):
    """Run ``fn`` of the test file ``script`` in ``world`` gloo processes on
    the CPU, one thread each; returns each rank's result in rank order. A
    rank that fails, or a run that outlives ``timeout``, fails the test and
    ends every rank."""
    import os
    import subprocess
    import sys
    import time

    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(kwargs, os.path.join(out_dir, "kwargs.pt"))
    url = "file://" + os.path.join(out_dir, "rendezvous")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    logs = [os.path.join(out_dir, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_MAIN, os.path.abspath(script),
                 fn, str(r), str(world), url, out_dir], env=env, cwd=repo,
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        with open(logs[r]) as log:
            assert p.returncode == 0, f"rank {r}:\n{log.read()[-6000:]}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
