"""One cell set up for a run: the program built, the mix's driver with its
inputs, the window to drive, and the output check once the program is gone.

From the configuration file the cell reads ``family`` (which
``drivers/<driver>.<family>.py`` drives the mix) and ``ranges`` (the
detector's submodules or methods the traced run times as layers).
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from ..reference.arith import Arith, float32_exact
from . import model, spec, trace, traffic


class Cell:
    """``conf``: a configuration file's contents; ``mix``: a traffic
    mix's; ``limits``: the cell's check (``limits/<workload>.json``)."""

    def __init__(self, conf: Dict, mix: Dict, limits: Dict, seed: int,
                 device: torch.device, traced: bool):
        self.conf, self.mix, self.limits = conf, mix, limits
        self.seed, self.dev = seed, device
        self.table = conf["cfg"]
        self.det, self.cfg, self.sd = model.build(
            conf, traffic.sub_seed(seed, "weights"), device)
        self.driver = spec.driver(mix["driver"], conf["family"])(self)
        self.kind = self.driver.kind
        self.tracer = (trace.Tracer(self.det, conf["ranges"], device)
                       .install() if traced else None)

    def window(self, deadline=None, n=None) -> Dict:
        """Drive the program until ``deadline`` (or for ``n`` batches or
        classes)."""
        return self.driver.window(deadline, n)

    def warm_up(self) -> None:
        """The cell's own shapes, once each path has run."""
        self.driver.warm_up()
        self.sync()

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def free_program(self) -> None:
        """Drop the program's model and closures before the reference runs."""
        self.driver.free()
        self.det = None
        if self.tracer is not None:
            self.tracer.ranges.model = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, res: Dict, arith: Arith = None) -> Dict[str, float]:
        """The compared numbers for a sample, drawn from the seed, of what
        the window ``res`` produced."""
        with torch.inference_mode(), float32_exact():
            return self.driver.check(res, arith or Arith())

    def control(self, fp8: bool = True) -> Dict[str, float]:
        """The compared numbers with the reference (float8 operands when
        ``fp8``: the nearest precision below the configurations' bfloat16)
        in the program's place, over the batches or calls a run's check
        samples. A limit must sit above what the program reads on sound
        runs and below what the control reads."""
        self.free_program()
        with torch.inference_mode(), float32_exact():
            res = self.driver.control(Arith(fp8=fp8))
        return self.check(res)

    def measure(self, seconds: float) -> Dict:
        """The window, under the tracer when the cell has one; a traced
        run's record holds the ``timeline``."""
        if self.tracer is not None:
            self.tracer.start()
        with torch.profiler.record_function("pb.window"):
            res = self.window(deadline=time.perf_counter() + seconds)
        res["timeline"] = (self.tracer.stop() if self.tracer is not None
                           else None)
        return res

    def nms_bounds(self):
        """(bound ms, what sets it) for each NMS launch of the traced
        window (none when untraced or off the card)."""
        if self.tracer is None or self.tracer.nms is None:
            return []
        from ..counts.nms_bound import bound_ms
        out = [bound_ms(b, k, m, int(tests))
               for b, k, m, tests in self.tracer.nms.launches]
        self.tracer.nms.launches.clear()
        return out
