"""SylphPredictor: single-image few-shot serving on the card (port of
sylph_tpu/predictor.py).

  * ``register_class(name, support_images, boxes)`` adds a class to the
    bank with no gradient step: raw code, then ``normalize_code``;
  * ``__call__(image)`` detects the registered classes;
  * ``detect_base(image)`` runs the plain base detector.

The code bank is preallocated on the device with ``TPU.MAX_CLASSES`` rows
and a ``valid`` mask; registering a class writes one row in place and
rebuilds nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .config import get_default_cfg
from .data.transforms import pad_to_canvas, resize_shortest_edge
from .models.fcos_head import HeadOutputs
from .ops.decode import decode_proposals
from .ops.locations import build_location_grid
from .runner import _decode_cfg, build_model_from_cfg, resolve_device
from .structures import Detections


class ClassCodeBank:
    """Fixed-capacity device-resident class-code bank."""

    def __init__(self, capacity: int, channels: int = 256,
                 device: Union[str, torch.device] = "cuda"):
        dev = resolve_device(device)
        self.capacity = capacity
        self.conv = torch.zeros((capacity, channels), dtype=torch.float32,
                                device=dev)
        self.bias = torch.zeros((capacity,), dtype=torch.float32, device=dev)
        self.valid = torch.zeros((capacity,), dtype=torch.bool, device=dev)
        self.names: List[Optional[str]] = [None] * capacity
        self._n = 0

    def add(self, name: str, conv, bias) -> int:
        """Write one row in place; ``conv``/``bias`` may live on any device."""
        i = self._n
        if i >= self.capacity:
            raise RuntimeError(f"code bank full ({self.capacity} classes)")
        self.conv[i].copy_(torch.as_tensor(conv, dtype=torch.float32)
                           .reshape(-1))
        self.bias[i] = torch.as_tensor(bias, dtype=torch.float32).reshape(())
        self.valid[i] = True
        self.names[i] = name
        self._n += 1
        return i

    @property
    def num_classes(self) -> int:
        return self._n

    def as_code(self) -> Dict[str, torch.Tensor]:
        return {"cls_conv": self.conv, "cls_bias": self.bias}


class SylphPredictor:
    def __init__(self, config_file: Optional[str] = None,
                 weight_path: Optional[str] = None,
                 class_code_path: Optional[str] = None,
                 runner_name: str = "MetaFCOSRunner",
                 test_dataset_names: Sequence[str] = (),
                 cfg=None, model=None, max_classes: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        if runner_name != "MetaFCOSRunner":
            raise NotImplementedError(f"runner {runner_name} is not ported "
                                      "yet")
        if class_code_path:
            raise NotImplementedError("loading class codes from .npz is not "
                                      "ported yet")
        self.device = resolve_device(device)
        if cfg is None:
            cfg = get_default_cfg()
            if config_file:
                cfg.merge_from_file(config_file)
        self.cfg = cfg
        if model is None:
            model = build_model_from_cfg(cfg, device=self.device)
            if weight_path:
                model.load_state_dict(
                    torch.load(weight_path, map_location=self.device,
                               weights_only=True), strict=True)
        elif weight_path:
            raise ValueError("pass either model= or weight_path=, not both")
        self.model = model.to(self.device).eval()

        self.eval_canvas = tuple(cfg.TPU.EVAL_CANVAS)
        grid = build_location_grid(
            self.eval_canvas, tuple(cfg.MODEL.FCOS.FPN_STRIDES),
            list(cfg.MODEL.FCOS.SIZES_OF_INTEREST))
        self.locations = torch.as_tensor(grid.locations, device=self.device)
        self.strides = torch.as_tensor(grid.strides, device=self.device)
        self.level_splits = tuple(h * w for h, w in grid.level_sizes)
        self.decode_cfg = _decode_cfg(cfg)
        self.bank = ClassCodeBank(max_classes or cfg.TPU.MAX_CLASSES,
                                  device=self.device)

    # ------------------------------------------------------ registration
    @torch.inference_mode()
    def class_code(self, support_images: Sequence[np.ndarray],
                   support_boxes: Sequence[np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """Normalized code (1 row) of one class from K support crops,
        each resized, cropped and padded to TPU.SUPPORT_CANVAS."""
        sc = tuple(self.cfg.TPU.SUPPORT_CANVAS)
        imgs, boxes = [], []
        for img, box in zip(support_images, support_boxes):
            im, bx = resize_shortest_edge(
                np.asarray(img), np.asarray(box, np.float32).reshape(1, 4),
                min(sc), max(sc))
            im = im[:sc[0], :sc[1]]
            bx = bx.clip(0, [im.shape[1], im.shape[0]] * 2)
            imgs.append(pad_to_canvas(im, sc))
            boxes.append(bx[0])
        imgs = torch.as_tensor(np.stack(imgs), device=self.device)
        boxes = torch.as_tensor(np.stack(boxes), device=self.device)
        k = imgs.shape[0]
        raw = self.model.forward_class_code(
            imgs, boxes, torch.ones((k,), dtype=torch.bool,
                                    device=self.device), k, False)
        return self.model.normalize_code(
            {"cls_conv": raw["cls_conv"], "cls_bias": raw["cls_bias"]})

    def register_class(self, name: str, support_images: List[np.ndarray],
                       support_boxes: List[np.ndarray]) -> int:
        """Register a novel class from K support crops — no gradients.

        support_images: K HWC uint8 arrays (BGR or RGB per cfg.INPUT.FORMAT);
        support_boxes: K XYXY boxes in each image's coordinates.
        """
        code = self.class_code(support_images, support_boxes)
        return self.bank.add(name, code["cls_conv"], code["cls_bias"])

    # ---------------------------------------------------------- inference
    def prepare(self, image: np.ndarray):
        """RGB image -> (BGR canvas (1, H, W, 3) uint8 on the device,
        image_size (1, 2), (oh, ow, rh, rw))."""
        img = np.asarray(image)
        if self.cfg.INPUT.FORMAT == "BGR":
            img = img[:, :, ::-1]  # input assumed RGB; model wants BGR
        oh, ow = img.shape[:2]
        resized, _ = resize_shortest_edge(
            np.ascontiguousarray(img), np.zeros((0, 4), np.float32),
            self.cfg.INPUT.MIN_SIZE_TEST, self.cfg.INPUT.MAX_SIZE_TEST)
        resized = resized[:self.eval_canvas[0], :self.eval_canvas[1]]
        rh, rw = resized.shape[:2]
        canvas = torch.as_tensor(pad_to_canvas(resized, self.eval_canvas)[None],
                                 device=self.device)
        size = torch.tensor([[rh, rw]], device=self.device)
        return canvas, size, (oh, ow, rh, rw)

    @torch.inference_mode()
    def dense(self, canvas: torch.Tensor) -> HeadOutputs:
        """Conditioned dense head outputs against the whole bank."""
        return self.model.forward_instances(canvas, self.bank.as_code())

    @torch.inference_mode()
    def decode(self, out: HeadOutputs, image_size: torch.Tensor,
               class_valid: Optional[torch.Tensor] = None,
               nms_impl: Optional[str] = None) -> Detections:
        return decode_proposals(
            out.logits, out.reg, out.ctrness, out.iou, self.locations,
            self.strides, image_size, self.decode_cfg, self.level_splits,
            class_valid=class_valid, nms_impl=nms_impl)

    def __call__(self, image: np.ndarray,
                 device_preprocess: bool = False) -> Dict:
        """Detect registered classes in one RGB image."""
        if device_preprocess:
            raise NotImplementedError("device_preprocess is not ported yet")
        canvas, size, hw = self.prepare(image)
        det = self.decode(self.dense(canvas), size,
                          class_valid=self.bank.valid)
        return self._format(det.numpy(), *hw)

    def detect_base(self, image: np.ndarray) -> Dict:
        """Plain base-detector inference with the trained cls_logits."""
        canvas, size, (oh, ow, rh, rw) = self.prepare(image)
        with torch.inference_mode():
            out = self.model.forward_base(canvas)
        det = self.decode(out, size).numpy()
        keep = det.valid[0]
        sx, sy = ow / rw, oh / rh
        return {
            "boxes": det.boxes[0][keep] * np.array([sx, sy, sx, sy],
                                                   np.float32),
            "scores": det.scores[0][keep],
            "classes": det.classes[0][keep],
        }

    def generate_class_codes_from_dataset(self, dataset_name: str,
                                          shot: Optional[int] = None,
                                          meta_test_seed: int = 0) -> int:
        raise NotImplementedError("registering from a dataset needs the "
                                  "data layer, which is not ported yet")

    def _format(self, det: Detections, oh, ow, rh, rw) -> Dict:
        sx, sy = ow / rw, oh / rh
        keep = det.valid[0]
        boxes = det.boxes[0][keep] * np.array([sx, sy, sx, sy], np.float32)
        classes = det.classes[0][keep]
        return {
            "boxes": boxes,
            "scores": det.scores[0][keep],
            "classes": classes,
            "class_names": [self.bank.names[c] for c in classes],
        }
