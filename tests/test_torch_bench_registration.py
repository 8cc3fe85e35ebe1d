"""``sylph_tpu_torch.tools.bench_registration`` against the JAX package's.

Its ``synthetic_support_loader`` yields the JAX tool's items byte for byte,
and its ``main`` runs on the CPU on a tiny config (R-18, a 64x64 support
canvas, fp32) and prints one JSON line with both times per class.
"""

import json

import numpy as np

from sylph_tpu_torch.tools import bench_registration


def test_synthetic_support_loader_equals_jax():
    from sylph_tpu.tools.bench_registration import \
        synthetic_support_loader as jax_loader
    for args in ((5, 3, (64, 96)), (40, 2, (48, 40))):
        want = list(jax_loader(*args, seed=4))
        got = list(bench_registration.synthetic_support_loader(*args, seed=4))
        assert len(got) == len(want) == args[0]
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k, v in w.items():
                if isinstance(v, np.ndarray):
                    assert g[k].dtype == v.dtype
                    np.testing.assert_array_equal(g[k], v, err_msg=k)
                else:
                    assert g[k] == v


def test_main_runs_on_the_cpu_and_prints_its_line(capsys):
    result = bench_registration.main(
        ["--classes", "5", "--shot", "2", "--class-batch", "2", "--single",
         "--device", "cpu", "MODEL.RESNETS.DEPTH", "18",
         "TPU.SUPPORT_CANVAS", "[64, 64]", "TPU.COMPUTE_DTYPE", "float32"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert (line["classes"], line["shot"], line["class_batch"]) == (5, 2, 2)
    assert line["canvas"] == [64, 64] and line["device"] == "cpu"
    assert line["classes_single"] == 5
    assert line["ms_per_class"] > 0 and line["ms_per_class_single"] > 0
