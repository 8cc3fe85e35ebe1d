"""The port's host helpers against the JAX package's: ``.npz`` code banks
both ways, ``post_mortem_if_fail``, the ``[model] params:`` line at build
time, SYLPH_MEMORY_REPORT's one ``[memory]`` line, ``MetricsWriter``'s
``print_every`` and ``tensorboard`` arguments, ``train_net --resume`` and
the allocator tuning at import.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sylph_tpu.runner.meta_fcos_runner import MetaFCOSRunner as JaxRunner
from sylph_tpu.train import checkpoint as jckpt
from sylph_tpu.utils.events import MetricsWriter as JaxWriter
from sylph_tpu_torch import _tune_malloc
from sylph_tpu_torch.runner import MetaFCOSRunner
from sylph_tpu_torch.tools import train_net
from sylph_tpu_torch.train import checkpoint as tckpt
from sylph_tpu_torch.utils.events import MetricsWriter
from sylph_tpu_torch.utils.setup import post_mortem_if_fail

from torch_port_util import few_torch_threads  # noqa: F401
from torch_port_util import tiny_model_pair


def _bank(seed):
    rng = np.random.RandomState(seed)
    return {"cls_conv": rng.randn(3, 256).astype(np.float32),
            "cls_bias": rng.randn(3).astype(np.float32)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_code_bank_crosses_packages(tmp_path, writer):
    save, load = ((jckpt.save_code_bank, tckpt.load_code_bank)
                  if writer == "jax" else
                  (tckpt.save_code_bank, jckpt.load_code_bank))
    bank, names = _bank(0), ["cat", "dog", "zebra"]
    path = str(tmp_path / "sub" / "bank.npz")
    save(path, bank, class_names=names)
    got = load(path)
    assert sorted(got) == ["class_names", "cls_bias", "cls_conv"]
    for k, v in bank.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
    assert got["class_names"].tolist() == names
    save(str(tmp_path / "plain.npz"), bank)
    assert sorted(load(str(tmp_path / "plain.npz"))) == sorted(bank)


def test_post_mortem_if_fail_passes_through(monkeypatch):
    monkeypatch.delenv("SYLPH_POST_MORTEM", raising=False)

    @post_mortem_if_fail
    def ok(x):
        return x + 1
    assert ok(1) == 2

    @post_mortem_if_fail()
    def bad():
        raise ValueError("boom")
    with pytest.raises(ValueError, match="boom"):
        bad()  # SYLPH_POST_MORTEM unset: a plain re-raise


def _model_line(text):
    lines = [ln for ln in text.splitlines()
             if ln.startswith("[model] params:")]
    assert len(lines) == 1, text
    return lines[0]


def _counts(line):
    """'[model] params: X.XXM total, Y.YYM trainable' -> (X.XX, Y.YY)."""
    total, trainable = line.split(":")[1].split(",")
    return float(total.split("M")[0]), float(trainable.split("M")[0])


@pytest.mark.parametrize("episodic", [True, False])
def test_model_params_line_matches_jax(capsys, episodic):
    """The line the port prints as it builds the model against the one
    JAX's ``_log_model_stats`` prints for the same config. Episodic (the
    backbone frozen) the two freeze rules agree and so do the lines; in
    pretraining JAX's rule also trains the bottleneck FrozenBN, which the
    port keeps constant, and the trainable counts differ by exactly
    those."""
    jcfg, _, params, tcfg, tmodel = tiny_model_pair(episodic=episodic)
    JaxRunner._log_model_stats(jcfg, params)
    jax_line = _model_line(capsys.readouterr().out)
    MetaFCOSRunner(device="cpu").build_model(tcfg)
    port_line = _model_line(capsys.readouterr().out)
    if episodic:
        assert port_line == jax_line
        return
    (jt, jtr), (pt, ptr) = _counts(jax_line), _counts(port_line)
    assert pt == jt
    bn = sum(v.numel() for k, v in tmodel.state_dict().items()
             if k.startswith("backbone.") and ".bn" in k)
    assert bn > 0 and abs((jtr - ptr) - bn / 1e6) <= 0.011


class _Batches:
    def __init__(self):
        self.closed = False

    def __iter__(self):
        return self

    def __next__(self):
        return {}

    def close(self):
        self.closed = True


def test_memory_report_prints_once_and_training_goes_on(capsys,
                                                        monkeypatch):
    """SYLPH_MEMORY_REPORT=1 over 4 CPU steps of the shared host loop: one
    ``[memory]`` line, in JAX's form where no device statistics exist,
    and every step taken."""
    monkeypatch.setenv("SYLPH_MEMORY_REPORT", "1")
    runner = MetaFCOSRunner(device="cpu")
    cfg = SimpleNamespace(
        SOLVER=SimpleNamespace(MAX_ITER=4, CHECKPOINT_PERIOD=100),
        TEST=SimpleNamespace(EVAL_PERIOD=0),
        TPU=SimpleNamespace(STEPS_PER_CALL=1), OUTPUT_DIR="")
    calls = []

    def step(state, batch):
        calls.append(state.step)
        return state, {"loss": torch.tensor(1.0)}

    batches = _Batches()
    runner._train_loop(cfg, SimpleNamespace(step=0), step, batches,
                       lambda it: 0.01, None)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[memory]")]
    assert len(lines) == 1
    assert lines[0].startswith("[memory] report unavailable: ")
    assert len(calls) == 4 and batches.closed


def _write_rows(writer):
    for step in range(1, 5):
        writer.write(step, {"loss": 1.0 / step, "loss_cls": 0.5},
                     lr=0.01 * step)
    writer.close()


def test_metrics_writer_matches_jax(tmp_path, capsys):
    """``MetricsWriter(dir, print_every=2, tensorboard=False)``: the same
    ``metrics.json`` as JAX's writer, a console line every 2 steps, and no
    ``tb/`` directory."""
    _write_rows(JaxWriter(str(tmp_path / "jax"), print_every=2,
                          tensorboard=False))
    jax_out = capsys.readouterr().out
    _write_rows(MetricsWriter(str(tmp_path / "port"), print_every=2,
                              tensorboard=False))
    port_out = capsys.readouterr().out
    with open(tmp_path / "jax" / "metrics.json") as f:
        want = [json.loads(ln) for ln in f]
    with open(tmp_path / "port" / "metrics.json") as f:
        got = [json.loads(ln) for ln in f]
    assert got == want and len(got) == 4
    for d in ("jax", "port"):
        assert not os.path.exists(tmp_path / d / "tb")
    printed = [[ln.split()[1] for ln in out.splitlines()
                if ln.startswith("iter ")] for out in (jax_out, port_out)]
    assert printed[0] == printed[1] == ["2", "4"]
    MetricsWriter(str(tmp_path / "tb_on")).close()
    assert os.path.isdir(tmp_path / "tb_on" / "tb")


@pytest.mark.parametrize("argv", [[], ["--resume"]])
def test_train_net_parses_resume(monkeypatch, argv):
    seen = {}

    def run(args, group):
        seen["args"] = args
        return {}

    monkeypatch.setattr(train_net, "_run", run)
    train_net.main(["--config-file", "x.yaml", "--device", "cpu", *argv])
    assert seen["args"].resume is True


def test_tune_malloc_runs():
    assert _tune_malloc() is None
