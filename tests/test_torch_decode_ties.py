"""The port's pre-NMS top-k cut against ``jax.lax.top_k``, every slot.

Where fewer candidates than ``pre_nms_topk`` pass the threshold, the rest of
the cut is ``-1e10`` padding, all tied. ``jax.lax.top_k`` fills those slots
with the lowest indices, so the invalid slots (their index, box, class and
location) are as defined as the valid ones, and the port must make the same
selection. Compared here: the top-k itself, one level's candidates, and the
whole decode, in every slot, valid or not. Indices, classes, locations and
flags must be equal; boxes and scores agree to 1e-5 (the same float32
arithmetic in a different library).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylph_tpu.ops.decode import DecodeCfg as JaxDecodeCfg
from sylph_tpu.ops.decode import _level_candidates as jax_level_candidates
from sylph_tpu.ops.decode import decode_proposals as jax_decode
from sylph_tpu.ops.locations import build_location_grid as jax_grid
from sylph_tpu_torch.ops.decode import (NEG_INF, DecodeCfg,
                                        _level_candidates,
                                        _topk_lower_index_first,
                                        decode_proposals)
from sylph_tpu_torch.ops.locations import build_location_grid

STRIDES = (8, 16, 32, 64, 128)


def _ties_straddling_cut(rng):
    """Three values only, so the k-th value's tie run crosses the cut."""
    x = rng.choice(np.float32([0.1, 0.5, 0.9]), (3, 40))
    return x.astype(np.float32), 17


def _padding_tail(rng):
    """Fewer live elements than k: the cut ends in -1e10 padding."""
    x = np.full((2, 64), NEG_INF, np.float32)
    live = rng.rand(2, 64) < 0.15
    x[live] = rng.rand(int(live.sum())).astype(np.float32)
    return x, 30


def _all_padding(rng):
    return np.full((2, 50), NEG_INF, np.float32), 20


def _ties_above_and_at_cut(rng):
    """Ties above the k-th value too: they must come lower index first."""
    x = rng.choice(np.float32([0.2, 0.7]), (2, 33)).astype(np.float32)
    x[:, 5] = x[:, 20] = x[:, 31] = 0.95
    return x, 12


TOPK_CASES = {"ties_straddling_cut": _ties_straddling_cut,
              "padding_tail": _padding_tail, "all_padding": _all_padding,
              "ties_above_and_at_cut": _ties_above_and_at_cut}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_topk_matches_lax_top_k(case):
    rng = np.random.RandomState(sorted(TOPK_CASES).index(case))
    x, k = TOPK_CASES[case](rng)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = _topk_lower_index_first(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _level_inputs(rng, k_l=48, n=5, live_frac=0.05):
    masked = np.full((2, k_l, n), NEG_INF, np.float32)
    live = rng.rand(2, k_l, n) < live_frac
    masked[live] = rng.rand(int(live.sum())).astype(np.float32)
    masked[0, 3, 1] = masked[0, 9, 4] = 0.5  # an exact tie among the live
    reg = np.abs(rng.randn(2, k_l, 4) * 3).astype(np.float32)
    locations = rng.uniform(0, 200, (k_l, 2)).astype(np.float32)
    strides = rng.choice(np.float32(STRIDES), k_l).astype(np.float32)
    return masked, reg, locations, strides


def test_level_candidates_match_jax_in_every_slot():
    """One level with fewer live candidates than pre_nms_topk."""
    rng = np.random.RandomState(3)
    masked, reg, locations, strides = _level_inputs(rng)
    topk = 40
    assert (masked > NEG_INF / 2).sum(axis=(1, 2)).max() < topk
    jb, js, jc, jloc, jv = jax_level_candidates(
        jnp.asarray(masked), jnp.asarray(reg), jnp.asarray(locations),
        jnp.asarray(strides), jnp.ones((masked.shape[-1],), bool),
        NEG_INF / 2, topk)
    tb, ts, tc, tloc, tv = _level_candidates(
        torch.from_numpy(masked), torch.from_numpy(reg),
        torch.from_numpy(locations), torch.from_numpy(strides), topk)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tloc.numpy(), locations[np.asarray(jloc)])
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("first_level_empty", [False, True])
def test_decode_matches_jax_in_every_slot(first_level_empty):
    """The whole decode, every output slot. With the first level empty the
    slots NMS leaves unfilled gather candidate 0, a padding slot."""
    rng = np.random.RandomState(11 + first_level_empty)
    canvas = (96, 160)
    grid = jax_grid(canvas, STRIDES, [64, 128, 256, 512])
    tgrid = build_location_grid(canvas, STRIDES, [64, 128, 256, 512])
    b, k, n = 2, grid.num_locations, 4
    splits = tuple(h * w for h, w in grid.level_sizes)
    logits = (rng.randn(b, k, n) * 2 - 7).astype(np.float32)
    logits[:, :, 2] = logits[:, :, 1]  # exact ties between two classes
    if first_level_empty:
        logits[:, :splits[0]] = -30.0
    reg = np.abs(rng.randn(b, k, 4) * 3).astype(np.float32)
    ctr = rng.randn(b, k).astype(np.float32)
    iou = rng.randn(b, k).astype(np.float32)
    sizes = np.array([[90, 150], [96, 120]], np.int32)
    kwargs = dict(pre_nms_topk=60, post_nms_topk=80, pre_nms_thresh=0.05)

    want = jax.tree.map(np.asarray, jax_decode(
        jnp.asarray(logits), jnp.asarray(reg), jnp.asarray(ctr),
        jnp.asarray(iou), jnp.asarray(grid.locations),
        jnp.asarray(grid.strides), jnp.asarray(grid.level_ids),
        jnp.asarray(sizes), JaxDecodeCfg(**kwargs), splits))
    got = decode_proposals(
        torch.from_numpy(logits), torch.from_numpy(reg),
        torch.from_numpy(ctr), torch.from_numpy(iou),
        torch.from_numpy(tgrid.locations), torch.from_numpy(tgrid.strides),
        torch.from_numpy(sizes), DecodeCfg(**kwargs), splits).numpy()

    # some levels hold fewer candidates than the cut, and NMS leaves slots
    live = logits.reshape(b, k, n) > np.log(0.05 / 0.95)
    per_level = np.add.reduceat(live.sum(-1), np.cumsum((0,) + splits[:-1]),
                                axis=1)
    assert (per_level < 60).any()
    assert 0 < want.valid.sum() < want.valid.size
    for field in ("valid", "classes", "fpn_levels", "locations"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    np.testing.assert_allclose(got.boxes, want.boxes, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-5)
