"""The port's host-side copies and plumbing against the JAX package.

The port keeps its own copy of the config tree, the serving transforms and
the box helpers; these tests hold each copy to the JAX original, and check
the weight carrier's and the kernel wrapper's refusals.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.config import get_default_cfg as jax_default_cfg
from sylph_tpu.data.transforms import pad_to_canvas as jax_pad
from sylph_tpu.data.transforms import resize_shortest_edge as jax_resize
from sylph_tpu.structures import box_area as jax_box_area
from sylph_tpu.structures import clip_boxes as jax_clip_boxes
from sylph_tpu_torch.config import get_default_cfg
from sylph_tpu_torch.data.transforms import pad_to_canvas, resize_shortest_edge
from sylph_tpu_torch.models.fcos_head import FCOSHead
from sylph_tpu_torch.ops import nms_kernel
from sylph_tpu_torch.predictor import ClassCodeBank
from sylph_tpu_torch.structures import box_area, clip_boxes
from sylph_tpu_torch.utils.convert_weights import (load_jax_params,
                                                   state_dict_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, os.path.join(REPO, "configs"))
                 for p in glob.glob(os.path.join(REPO, "configs", "**",
                                                 "Meta-FCOS-*.yaml"),
                                    recursive=True))[:6]


@pytest.mark.parametrize("config", ["<defaults>"] + CONFIGS)
def test_config_copy_equals_jax(config):
    ours, theirs = get_default_cfg(), jax_default_cfg()
    if config != "<defaults>":
        ours.merge_from_file(f"sylph://{config}")
        theirs.merge_from_file(f"sylph://{config}")
    assert ours.to_dict() == theirs.to_dict()


@pytest.mark.parametrize("hw", [(80, 100), (480, 640), (333, 1000)])
def test_transforms_equal_jax(hw):
    rng = np.random.RandomState(hw[0])
    img = rng.randint(0, 256, (*hw, 3), dtype=np.uint8)
    boxes = rng.uniform(0, 80, (3, 4)).astype(np.float32)
    got_img, got_boxes = resize_shortest_edge(img, boxes, 256, 384)
    want_img, want_boxes = jax_resize(img, boxes, 256, 384)
    np.testing.assert_array_equal(got_img, want_img)
    np.testing.assert_array_equal(got_boxes, want_boxes)
    canvas = (256, 384)
    np.testing.assert_array_equal(pad_to_canvas(got_img[:, :, ::-1], canvas),
                                  jax_pad(want_img[:, :, ::-1], canvas))


def test_box_helpers_equal_jax():
    rng = np.random.RandomState(0)
    boxes = rng.uniform(-20, 140, (2, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        box_area(torch.from_numpy(boxes)).numpy(),
        np.asarray(jax_box_area(jnp.asarray(boxes))))
    np.testing.assert_array_equal(
        clip_boxes(torch.from_numpy(boxes), (96, 120)).numpy(),
        np.asarray(jax_clip_boxes(jnp.asarray(boxes), (96, 120))))


def test_code_bank_writes_one_row_in_place():
    bank = ClassCodeBank(capacity=4, channels=8, device="cpu")
    ptr = bank.conv.data_ptr()
    assert bank.add("cat", np.ones(8), -4.0) == 0
    assert bank.add("dog", torch.full((8,), 2.0), torch.tensor(-3.0)) == 1
    assert bank.conv.data_ptr() == ptr  # nothing was rebuilt
    assert bank.num_classes == 2 and bank.names[:2] == ["cat", "dog"]
    assert bank.valid.tolist() == [True, True, False, False]
    np.testing.assert_array_equal(bank.conv[1].numpy(), 2.0)
    np.testing.assert_array_equal(bank.bias.numpy(), [-4.0, -3.0, 0, 0])
    assert bank.as_code()["cls_conv"].shape == (4, 8)


def test_weight_carrier_is_strict():
    head = FCOSHead(num_classes=3, num_cls_convs=1, num_box_convs=1,
                    compute_dtype=torch.float32)
    sd = head.state_dict()
    params = {"cls_tower": {
        "conv0": {"kernel": np.zeros((3, 3, 256, 256), np.float32),
                  "bias": np.zeros((256,), np.float32)},
        "gn0": {"scale": np.ones((256,), np.float32),
                "bias": np.zeros((256,), np.float32)}}}
    got = state_dict_from_jax(params)
    assert set(got) == {"cls_tower.conv0.weight", "cls_tower.conv0.bias",
                        "cls_tower.gn0.weight", "cls_tower.gn0.bias"}
    assert got["cls_tower.conv0.weight"].shape == \
        sd["cls_tower.conv0.weight"].shape
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(head, params)
    with pytest.raises(ValueError, match="no port counterpart"):
        state_dict_from_jax({"x": {"embedding": np.zeros((3, 4))}})


def test_kernel_wrapper_refuses_what_it_cannot_take():
    """Checks run before any build: a CPU tensor or too many candidates raise,
    and importing the module built nothing."""
    assert not nms_kernel._fns
    planes = [torch.zeros((1, 8)) for _ in range(5)]
    valid = torch.ones((1, 8), dtype=torch.int32)
    for fn in (nms_kernel.nms_cuda, nms_kernel.nms_cuda_greedy):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(*planes, valid, 0.5, 4)
    # sizes are checked first: K past the counting route's 57,088 goes to
    # the radix route (so only the device refuses it), a kept list past the
    # shared memory does not fit at any K
    big = nms_kernel.MAX_DYNAMIC_SMEM // nms_kernel.SMEM_BYTES_PER_CANDIDATE
    assert nms_kernel.select_route(1, big, 300) == "count"
    assert nms_kernel.select_route(1, big + 1, 300) == "radix"
    with pytest.raises(ValueError, match="CUDA tensor"):
        nms_kernel.nms_cuda(*[torch.zeros((1, big + 1)) for _ in range(5)],
                            torch.ones((1, big + 1), dtype=torch.int32),
                            0.5, 4)
    m = nms_kernel.MAX_DYNAMIC_SMEM // nms_kernel.SMEM_BYTES_PER_PICK + 1
    with pytest.raises(ValueError, match=f"M={m}"):
        nms_kernel.nms_cuda(*[torch.zeros((1, big)) for _ in range(5)],
                            torch.ones((1, big), dtype=torch.int32), 0.5, m)
    # the first design keeps six planes of K: 24 bytes a candidate
    with pytest.raises(ValueError, match="K=10000"):
        nms_kernel.nms_cuda_greedy(
            *[torch.zeros((1, 10000)) for _ in range(5)],
            torch.ones((1, 10000), dtype=torch.int32), 0.5, 4)
    assert not nms_kernel._fns
