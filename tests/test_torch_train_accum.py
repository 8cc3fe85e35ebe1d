"""The port's episodic train step with ``TPU.GRAD_ACCUM = 2`` against the
JAX package's ``grad_accum=2``, in float32 on the CPU with a tiny R-18:
two micro-groups act as two ranks, each classifying its queries against
its own episode classes, with the snnl and distillation losses on and a
FREEZE_EXCLUDE that leaves trainable backbone parameters without a
gradient (they still decay). Three steps on one fixed batch: losses within
rtol 1e-4, parameters within atol 1e-5 + rtol 1e-4, frozen parameters
bit-identical in both packages.
"""

import pytest

from torch_port_util import (check_episodic_steps,  # noqa: F401
                             few_torch_threads, tiny_model_pair)


@pytest.fixture(scope="module")
def pair():
    return tiny_model_pair(episodic=True, seed=3)


def test_episodic_accum2_snnl_distill_exclude_match_jax(pair):
    check_episodic_steps(pair, grad_accum=2, snnl=True, distill=0.5,
                         freeze_kw=dict(backbone_exclude=["res5"]))
