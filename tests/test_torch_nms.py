"""The port's plain NMS renderings against the JAX package's references.

``nms_select_reference`` (the greedy twin the CUDA kernel is held against)
and ``nms_select_ranked_reference`` (the kernel's own algorithm: rank once,
by counting or by the large-K radix route, then scan in chunks of 64) must
each equal, index for index and flag for flag:
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
from sylph_tpu_torch.ops.nms import (CHUNK, batched_multiclass_nms,
                                     class_offset_boxes,
                                     nms_select_ranked_reference,
                                     nms_select_reference, order_keys,
                                     rank_count_reference,
                                     rank_radix_reference)

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


def twin(boxes, scores, valid, thr, max_outputs,
         select=nms_select_reference):
    idx, ok = select(torch.from_numpy(boxes), torch.from_numpy(scores),
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
    ranked = twin(boxes, scores, valid, thr, max_outputs,
                  select=nms_select_ranked_reference)
    # the radix route with tiles of 64, so that small cases span tiles
    radix = twin(boxes, scores, valid, thr, max_outputs,
                 select=partial(nms_select_ranked_reference, route="radix",
                                tile=64))
    for name, (idx, ok) in refs.items():
        for which, (g_idx, g_ok) in (("twin", (got_idx, got_ok)),
                                     ("ranked", ranked), ("radix", radix)):
            np.testing.assert_array_equal(g_ok, ok, err_msg=f"{which} {name}")
            np.testing.assert_array_equal(g_idx, idx,
                                          err_msg=f"{which} {name}")
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


# ---- cases aimed at the kernel's chunked scan (chunks of CHUNK = 64)
def _case_k_not_multiple_of_chunk(rng):
    k = 2 * CHUNK + 22
    boxes = random_boxes(rng, 2, k, 20, 400, (10, 70))
    scores = rng.uniform(0.01, 1.0, (2, k)).astype(np.float32)
    return boxes, scores, np.ones((2, k), bool), 0.5, k


def _case_m_mid_chunk(rng):
    """Few overlaps: the 70th pick falls in the second chunk."""
    k = 200
    boxes = random_boxes(rng, 1, k, 0, 800, (5, 40))
    scores = rng.uniform(0.01, 1.0, (1, k)).astype(np.float32)
    return boxes, scores, np.ones((1, k), bool), 0.5, 70


def _case_chunk_boundary_ties(rng):
    """60 far-apart leaders, then 10 near-identical boxes of one score,
    at shuffled indices, on ranks 60-69 across the chunk boundary 64: the
    lowest index among them must win."""
    k = 160
    boxes = random_boxes(rng, 1, k, 0, 300, (10, 30))
    scores = rng.uniform(0.01, 0.4, (1, k)).astype(np.float32)
    perm = rng.permutation(k)
    lead, tied = perm[:60], perm[60:70]
    boxes[0, lead] = random_boxes(rng, 1, 60, 2000, 9000, (10, 30))[0]
    scores[0, lead] = np.linspace(0.99, 0.6, 60, dtype=np.float32)
    boxes[0, tied] = np.float32([500, 500, 560, 540]) \
        + rng.uniform(0, 2, (10, 4)).astype(np.float32)
    scores[0, tied] = 0.5
    return boxes, scores, np.ones((1, k), bool), 0.5, 100


def _case_identical_boxes(rng):
    """Every box the same: one pick, then index 0 / not ok."""
    k = 2 * CHUNK + 2
    boxes = np.tile(np.float32([10, 20, 60, 90]), (1, k, 1))
    scores = rng.uniform(0.01, 1.0, (1, k)).astype(np.float32)
    return boxes, scores, np.ones((1, k), bool), 0.6, 10


def _case_no_overlap(rng):
    """Disjoint boxes on a grid: the picks are the first M ranked."""
    k = 300
    cell = np.stack(np.meshgrid(np.arange(20), np.arange(15)), -1)
    xy = (cell.reshape(-1, 2)[:k] * 10).astype(np.float32)
    boxes = np.concatenate([xy, xy + 8], -1)[None]
    scores = rng.uniform(0.01, 1.0, (1, k)).astype(np.float32)
    return boxes, scores, np.ones((1, k), bool), 0.5, 100


def _case_dense_clusters(rng):
    """Eight clusters of jittered boxes: most are suppressed, so the scan
    goes through every chunk to find its picks."""
    k = 600
    centres = rng.uniform(100, 900, (8, 2)).astype(np.float32)
    ctr = centres[rng.randint(0, 8, k)] + rng.normal(0, 4, (k, 2))
    wh = rng.uniform(40, 60, (k, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    scores = rng.uniform(0.01, 1.0, (1, k)).astype(np.float32)
    return (boxes[None].astype(np.float32), scores, np.ones((1, k), bool),
            0.5, 60)


def _case_all_invalid(rng):
    k = CHUNK + 6
    boxes = random_boxes(rng, 1, k)
    scores = rng.uniform(0.01, 1.0, (1, k)).astype(np.float32)
    return boxes, scores, np.zeros((1, k), bool), 0.6, 5


def _case_signed_zero_tie(rng):
    """-0.0 and +0.0 are equal scores: the lower index wins the pair."""
    pair = np.float32([[0, 0, 10, 10], [1, 0, 11, 10]])
    boxes = np.concatenate([pair + 100 * i for i in range(4)])[None]
    scores = np.float32([[-0.0, 0.0, 0.0, -0.0, -0.5, -0.5, 0.25, 0.25]])
    return boxes, scores, np.ones((1, 8), bool), 0.5, 6


def _case_single(rng):
    boxes = random_boxes(rng, 1, 1)
    return boxes, np.float32([[0.3]]), np.ones((1, 1), bool), 0.5, 3


CASES = {"greedy": _case_greedy, "prefix": _case_prefix,
         "invalid_excluded": _case_invalid_excluded, "ties": _case_ties,
         "all_invalid_row": _case_all_invalid_row,
         "k_not_multiple_of_chunk": _case_k_not_multiple_of_chunk,
         "m_mid_chunk": _case_m_mid_chunk,
         "chunk_boundary_ties": _case_chunk_boundary_ties,
         "identical_boxes": _case_identical_boxes,
         "no_overlap": _case_no_overlap,
         "dense_clusters": _case_dense_clusters,
         "all_invalid": _case_all_invalid,
         "signed_zero_tie": _case_signed_zero_tie, "single": _case_single}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_equals_references(case):
    rng = np.random.RandomState(sorted(CASES).index(case) + 11)
    boxes, scores, valid, thr, m = CASES[case](rng)
    idx, ok = assert_all_equal(boxes, scores, valid, thr, m)
    if case == "all_invalid_row":
        assert not ok[1].any() and (idx[1] == 0).all()
    if case == "invalid_excluded":
        assert idx[0][ok[0]].tolist() == [0]
    if case in ("all_invalid", "single", "identical_boxes"):
        assert ok.sum() == (case != "all_invalid") and (idx[~ok] == 0).all()
    if case == "signed_zero_tie":
        assert idx[0][ok[0]].tolist() == [6, 0, 2, 4]
    if case == "chunk_boundary_ties":
        tied = np.flatnonzero(scores[0] == 0.5)
        assert idx[0][60] == tied.min()
    if case in ("m_mid_chunk", "no_overlap"):
        assert ok.all()
        if case == "no_overlap":  # the first M in (score desc, index asc)
            order = np.lexsort((np.arange(scores.shape[1]), -scores[0]))
            assert idx[0].tolist() == order[:m].tolist()
    if case == "dense_clusters":
        assert 8 <= ok.sum() < m


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


# ---- the large-K route (two-stage ROI stage: proposals x classes)
def roi_stage_inputs(rng, p, e, ticks=None):
    """``_two_stage_infer``'s NMS input for one image: ``p`` proposal boxes,
    each repeated over ``e`` classes, near-uniform softmax scores (rounded
    to ``ticks`` steps when given, so that ties are everywhere), classes
    tiled, a score threshold of 1e-4."""
    boxes = random_boxes(rng, 1, p, 0, 1200, (8, 300))
    logits = rng.normal(0, 0.05, (p, e + 1))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    flat = probs[:, :-1].reshape(1, -1).astype(np.float32)
    if ticks:
        flat = (np.round(flat * ticks) / ticks).astype(np.float32)
    classes = np.tile(np.arange(e, dtype=np.int32), p)[None]
    return (np.repeat(boxes, e, axis=1), flat, classes, flat > 1e-4)


@pytest.mark.parametrize("ticks", [None, 1 << 16])
def test_large_k_radix_route_equals_references(ticks):
    """K = 60,000 (past the counting route's 57,088), M = 300: the radix
    rendering, the twin and JAX nms_select pick the same candidates, with
    and without ties; the radix route's ranked list is the counting one."""
    rng = np.random.RandomState(7 if ticks else 8)
    boxes, scores, classes, valid = roi_stage_inputs(rng, 1000, 60, ticks)
    k = scores.shape[1]
    assert k > nms_kernel.COUNT_ROUTE_MAX_K
    assert nms_kernel.select_route(1, k, 300) == "radix"
    if ticks:
        assert len(np.unique(scores)) < k // 10  # ties are everywhere
    shifted = class_offset_boxes(torch.from_numpy(boxes),
                                 torch.from_numpy(classes),
                                 torch.from_numpy(valid)).numpy()
    keys = order_keys(torch.from_numpy(scores), torch.from_numpy(valid))[0]
    assert torch.equal(rank_radix_reference(keys),
                       rank_count_reference(keys))
    want = jax_select(shifted, scores, valid, 0.5, 300)
    for name, select in (
            ("twin", nms_select_reference),
            ("radix", partial(nms_select_ranked_reference, route="radix"))):
        idx, ok = twin(shifted, scores, valid, 0.5, 300, select=select)
        np.testing.assert_array_equal(ok, want[1], err_msg=name)
        np.testing.assert_array_equal(idx, want[0], err_msg=name)
    assert want[1].all()


def test_size_check_takes_lvis_all_without_a_launch():
    """K = 1,203,000 (LVIS all: 1203 classes x 1000 proposals) at M <= 1000
    passes the size check on the radix route; nothing is built."""
    assert nms_kernel.select_route(1, 1_203_000, 1000) == "radix"
    assert nms_kernel.select_route(8, 1_103_000, 300) == "radix"
    assert nms_kernel.select_route(8, 5000, 1000) == "count"
    with pytest.raises(ValueError, match="M=20000"):
        nms_kernel.select_route(1, 1_203_000, 20000)
    with pytest.raises(ValueError, match="B=65536"):
        nms_kernel.select_route(65536, 10, 10)
    assert not nms_kernel._fns


def test_radix_rendering_orders_signed_zeros_and_dead():
    """-0.0 and +0.0 share a key; dead candidates get no rank."""
    scores = torch.tensor([0.5, -0.0, 0.0, -0.5, 0.25, 0.0, 0.5])
    valid = torch.tensor([True, True, True, True, False, True, True])
    keys = order_keys(scores, valid)
    assert keys[1] == keys[2] and keys[4] == 0
    order = rank_radix_reference(keys, tile=2)
    assert order.tolist() == [0, 6, 1, 2, 5, 3]
    assert torch.equal(order, rank_count_reference(keys))
