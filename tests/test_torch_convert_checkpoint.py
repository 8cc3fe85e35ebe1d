"""The port's checkpoint CLI (``sylph_tpu_torch/tools/convert_checkpoint.py``)
against ``tools/convert_checkpoint.py`` on the synthetic detectron2 state
dicts of tests/test_torch_convert_d2.py, written as ``.pth`` and ``.pkl``:
the two ``.npz`` files are equal key for key, and the audit and exit code
agree (non-zero on an unmapped key, 0 under ``--allow-unmapped`` and when
every key maps).
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from sylph_tpu_torch.tools import convert_checkpoint

from test_torch_convert_d2 import _codegen_sd, _fcos_sd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import convert_checkpoint as jax_cli  # noqa: E402


def _jax_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", *argv])
    try:
        jax_cli.main()
    except SystemExit as e:
        return e.code
    return 0


def _write(sd, path):
    if path.endswith(".pkl"):
        with open(path, "wb") as f:
            pickle.dump({"model": sd}, f)
    else:
        torch.save({"model": {k: torch.from_numpy(np.asarray(v))
                              for k, v in sd.items()}}, path)


# family -> (state dict, flags, exit code without --allow-unmapped); the
# FCOS dict carries a misspelled tower key (``cls_towerr``)
CASES = {
    "fcos": (lambda: _fcos_sd(np.random.RandomState(0)),
             ["--num-tower-convs", "2"], 1),
    "code_generator": (lambda: {**_fcos_sd(np.random.RandomState(1)),
                                **_codegen_sd(np.random.RandomState(2))},
                       ["--num-tower-convs", "2"], 1),
    "code_generator_only": (lambda: _codegen_sd(np.random.RandomState(3)),
                            [], 0),
}


@pytest.mark.parametrize("suffix", [".pth", ".pkl"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("allow", [False, True])
def test_port_cli_writes_the_jax_npz(tmp_path, monkeypatch, capsys, case,
                                     suffix, allow):
    make, flags, code = CASES[case]
    src = str(tmp_path / f"model{suffix}")
    _write(make(), src)
    flags = flags + (["--allow-unmapped"] if allow else [])
    want_npz, got_npz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    want_code = _jax_main(["--src", src, "--out", want_npz, *flags],
                          monkeypatch)
    want_out = capsys.readouterr().out
    got_code = convert_checkpoint.main(["--src", src, "--out", got_npz,
                                        *flags])
    got_out = capsys.readouterr().out
    assert (want_code or 0) == got_code == (0 if allow else code)
    assert got_out.replace(got_npz, "<out>") == \
        want_out.replace(want_npz, "<out>")
    want, got = np.load(want_npz), np.load(got_npz)
    assert sorted(got.files) == sorted(want.files) and got.files
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
