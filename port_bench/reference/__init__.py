"""Plain PyTorch reference of the two detectors the benchmark runs.

One file per layer, each a set of functions over a state dict keyed by the
module names the weight conversion pins (``backbone.res2_block0.conv1.weight``,
``fcos_head.cls_tower.gn0.bias``, ...). It imports torch and numpy only:
nothing of ``sylph_tpu_torch``, ``sylph_tpu`` or ``jax``. Every convolution,
linear layer and product goes through an ``Arith`` (``arith.py``), which
computes in float32 with TF32 off, or, as the output check's control, rounds
each operand to float8 first, and which can count the work it does.
"""
