"""The port's NMS twin against the JAX package's three references.

``nms_select_reference`` (sylph_tpu_torch/ops/nms.py) must equal, index for
index and flag for flag:
  * JAX ``nms_select`` / ``batched_multiclass_nms``;
  * the Pallas kernel body ``_nms_kernel`` itself, run in interpret mode;
  * ``tests/test_ops.py::np_greedy_nms``.
The CUDA kernel is held against the twin on the card by chip_smoke.py.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sylph_tpu.ops.nms import batched_multiclass_nms as jax_multiclass_nms
from sylph_tpu.ops.nms import nms_select
from sylph_tpu.ops.nms_pallas import _nms_kernel
from sylph_tpu_torch.ops import nms_kernel
from sylph_tpu_torch.ops.nms import (batched_multiclass_nms,
                                     nms_select_reference)

from test_ops import np_greedy_nms


def pallas_interpret(boxes, scores, valid, thr, max_outputs):
    """The Pallas kernel body on the CPU (interpret mode, no VMEM spec)."""
    b, k, _ = boxes.shape
    kernel = partial(_nms_kernel, iou_threshold=thr,
                     max_outputs=max_outputs, k=k)
    row = lambda x: jnp.asarray(x, jnp.float32)[:, None, :]  # noqa: E731
    spec = pl.BlockSpec((1, 1, k), lambda i: (i, 0, 0))
    out_spec = pl.BlockSpec((1, 1, max_outputs), lambda i: (i, 0, 0))
    idx, ok = pl.pallas_call(
        kernel, grid=(b,), in_specs=[spec] * 6,
        out_specs=[out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((b, 1, max_outputs), jnp.int32)] * 2,
        interpret=True,
    )(row(boxes[..., 0]), row(boxes[..., 1]), row(boxes[..., 2]),
      row(boxes[..., 3]), row(scores),
      jnp.asarray(valid, jnp.int32)[:, None, :])
    return np.asarray(idx[:, 0]), np.asarray(ok[:, 0]).astype(bool)


def jax_select(boxes, scores, valid, thr, max_outputs):
    idx, ok = jax.vmap(lambda b, s, v: nms_select(b, s, v, thr, max_outputs))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    return np.asarray(idx), np.asarray(ok)


def twin(boxes, scores, valid, thr, max_outputs):
    idx, ok = nms_select_reference(torch.from_numpy(boxes),
                                   torch.from_numpy(scores),
                                   torch.from_numpy(valid), thr, max_outputs)
    return idx.numpy(), ok.numpy()


def np_oracle(boxes, scores, valid, thr, max_outputs):
    """np_greedy_nms on each row's valid subset, mapped back, padded."""
    b = boxes.shape[0]
    idx = np.zeros((b, max_outputs), np.int32)
    ok = np.zeros((b, max_outputs), bool)
    for r in range(b):
        live = np.flatnonzero(valid[r])
        keep = live[np_greedy_nms(boxes[r, live], scores[r, live], thr)]
        keep = keep[:max_outputs]
        idx[r, :len(keep)] = keep
        ok[r, :len(keep)] = True
    return idx, ok


def random_boxes(rng, b, k, lo=20, hi=300, wh=(5, 80)):
    ctr = rng.uniform(lo, hi, (b, k, 2)).astype(np.float32)
    size = rng.uniform(*wh, (b, k, 2)).astype(np.float32)
    return np.concatenate([ctr - size / 2, ctr + size / 2], -1)


def assert_all_equal(boxes, scores, valid, thr, max_outputs, oracle=True):
    got_idx, got_ok = twin(boxes, scores, valid, thr, max_outputs)
    refs = {"nms_select": jax_select(boxes, scores, valid, thr, max_outputs),
            "pallas_interpret": pallas_interpret(boxes, scores, valid, thr,
                                                 max_outputs)}
    if oracle:
        refs["np_greedy_nms"] = np_oracle(boxes, scores, valid, thr,
                                          max_outputs)
    for name, (idx, ok) in refs.items():
        np.testing.assert_array_equal(got_ok, ok, err_msg=name)
        np.testing.assert_array_equal(got_idx, idx, err_msg=name)
    return got_idx, got_ok


def _case_greedy(rng):
    n = 64
    boxes = random_boxes(rng, 1, n, 20, 200, (10, 80))
    scores = rng.uniform(0.01, 1.0, (1, n)).astype(np.float32)
    return boxes, scores, np.ones((1, n), bool), 0.5, n


def _case_prefix(rng):
    n = 128
    boxes = random_boxes(rng, 1, n, 20, 300, (5, 60))
    scores = rng.uniform(0.01, 1.0, (1, n)).astype(np.float32)
    return boxes, scores, np.ones((1, n), bool), 0.6, 10


def _case_invalid_excluded(rng):
    boxes = np.array([[[0, 0, 10, 10], [100, 100, 120, 120.0]]], np.float32)
    scores = np.array([[0.9, 0.99]], np.float32)
    return boxes, scores, np.array([[True, False]]), 0.5, 4


def _case_ties(rng):
    """Exact score ties, overlapping and not: lower index wins."""
    k = 96
    boxes = random_boxes(rng, 2, k, 20, 120, (20, 60))
    scores = rng.choice(np.float32([0.3, 0.5, 0.7]), (2, k)).astype(np.float32)
    boxes[:, 10] = boxes[:, 40]  # identical boxes with tied scores
    scores[:, 10] = scores[:, 40] = 0.7
    return boxes, scores, np.ones((2, k), bool), 0.5, 40


def _case_all_invalid_row(rng):
    k = 50
    boxes = random_boxes(rng, 3, k)
    scores = rng.uniform(0.01, 1.0, (3, k)).astype(np.float32)
    valid = rng.rand(3, k) > 0.3
    valid[1] = False
    return boxes, scores, valid, 0.6, 20


CASES = {"greedy": _case_greedy, "prefix": _case_prefix,
         "invalid_excluded": _case_invalid_excluded, "ties": _case_ties,
         "all_invalid_row": _case_all_invalid_row}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_equals_references(case):
    rng = np.random.RandomState(sorted(CASES).index(case) + 11)
    boxes, scores, valid, thr, m = CASES[case](rng)
    idx, ok = assert_all_equal(boxes, scores, valid, thr, m)
    if case == "all_invalid_row":
        assert not ok[1].any() and (idx[1] == 0).all()
    if case == "invalid_excluded":
        assert idx[0][ok[0]].tolist() == [0]


@pytest.mark.parametrize("max_outputs", [100, 300])
def test_twin_full_size(max_outputs):
    """The main path's shape: K = 5 levels x 1000 candidates."""
    rng = np.random.RandomState(max_outputs)
    b, k = 2, 5000
    boxes = random_boxes(rng, b, k, 0, 1300, (8, 300))
    scores = np.sqrt(rng.uniform(0.0, 1.0, (b, k))).astype(np.float32)
    scores[:, 1::2] = scores[:, 0::2]  # exact ties in pairs
    valid = rng.rand(b, k) > 0.1
    _, ok = assert_all_equal(boxes, scores, valid, 0.6, max_outputs)
    assert ok.sum(1).min() == max_outputs


def test_multiclass_matches_jax():
    rng = np.random.RandomState(5)
    b, k, m = 2, 400, 60
    boxes = random_boxes(rng, b, k, 0, 200, (10, 90))
    scores = rng.uniform(0.0, 1.0, (b, k)).astype(np.float32)
    classes = rng.randint(0, 4, (b, k)).astype(np.int32)
    valid = rng.rand(b, k) > 0.2
    boxes[0, 1], classes[0, :2] = boxes[0, 0], [0, 1]  # same box, 2 classes
    want = jax_multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores),
                              jnp.asarray(classes), jnp.asarray(valid),
                              0.5, m)
    got = batched_multiclass_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(classes).long(), torch.from_numpy(valid), 0.5, m)
    names = ("boxes", "scores", "classes", "valid", "idx")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[3].any()


def test_multiclass_dispatch_by_device():
    """CPU tensors take the twin; the kernel refuses CPU tensors."""
    boxes = torch.tensor([[[0, 0, 10, 10], [1, 1, 10, 10.0]]])
    scores = torch.tensor([[0.9, 0.8]])
    classes = torch.tensor([[0, 1]])
    valid = torch.ones((1, 2), dtype=torch.bool)
    _, _, _, ok, _ = batched_multiclass_nms(boxes, scores, classes, valid,
                                            0.5, 4)
    assert ok.tolist() == [[True, True, False, False]]
    with pytest.raises(ValueError, match="unknown NMS impl"):
        batched_multiclass_nms(boxes, scores, classes, valid, 0.5, 4,
                               impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        nms_kernel.nms_cuda(*boxes.permute(2, 0, 1).contiguous(), scores,
                            valid.to(torch.int32), 0.5, 4)
