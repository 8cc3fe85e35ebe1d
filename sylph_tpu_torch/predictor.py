"""SylphPredictor: single-image few-shot serving on the card (port of
sylph_tpu/predictor.py).

  * ``register_class(name, support_images, boxes)`` adds a class to the
    bank with no gradient step: raw code, then ``normalize_code``;
  * ``SylphPredictor(class_code_path=dir)`` loads one ``{class}.npz`` of
    raw codes per class (as the meta-test saves them, in either package)
    and normalizes them into the bank;
  * ``generate_class_codes_from_dataset(name)`` registers every class of
    a registered dataset from its K-shot support sets;
  * ``__call__(image, device_preprocess=False)`` detects the registered
    classes; ``device_preprocess=True`` resizes on the card
    (``ops/image_ops.py``) when the frame fits the eval canvas;
  * ``detect_base(image)`` runs the plain base detector.

The model is built by the one-stage runner ``runner_name`` names
(``MetaFCOSRunner``, ``MetaFCOSROIEncoderRunner`` or
``TFAFewShotDetectionRunner``, through ``create_runner``): ``weight_path``
sets MODEL.WEIGHTS, which may name a flat ``.npz`` of flax params (the JAX
package's layout), one of the port's checkpoints or a detectron2
``.pth``/``.pkl``. The code bank is preallocated on the device with
``TPU.MAX_CLASSES`` rows and a ``valid`` mask; registering a class writes one
row in place and rebuilds nothing. The ROIEncoder's codes are final and are
never normalized.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .data.transforms import pad_to_canvas, resize_shortest_edge
from .models.fcos_head import HeadOutputs
from .ops.decode import decode_proposals
from .ops.image_ops import resize_shortest_edge_device
from .ops.locations import build_location_grid
from .runner import _decode_cfg, _mapper, create_runner, resolve_device
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
        self.device = resolve_device(device)
        runner = create_runner(runner_name, device=self.device)
        if cfg is None:
            cfg = runner.get_default_cfg()
            if config_file:
                cfg.merge_from_file(config_file)
        if weight_path:
            if model is not None:
                raise ValueError("pass either model= or weight_path=, not "
                                 "both")
            cfg.MODEL.WEIGHTS = weight_path
        self.cfg = cfg
        if model is None:
            model = runner.build_model(cfg)
        self.model = model.to(self.device).eval()

        self.eval_canvas = tuple(cfg.TPU.EVAL_CANVAS)
        grid = build_location_grid(
            self.eval_canvas, tuple(cfg.MODEL.FCOS.FPN_STRIDES),
            list(cfg.MODEL.FCOS.SIZES_OF_INTEREST))
        self.locations = torch.as_tensor(grid.locations, device=self.device)
        self.strides = torch.as_tensor(grid.strides, device=self.device)
        self.level_splits = tuple(h * w for h, w in grid.level_sizes)
        self.decode_cfg = _decode_cfg(cfg)
        self.mapper = _mapper(cfg)
        self.bank = ClassCodeBank(max_classes or cfg.TPU.MAX_CLASSES,
                                  device=self.device)
        if class_code_path:
            self._load_codes(class_code_path)

    # ------------------------------------------------------------- code IO
    def _load_codes(self, path: str) -> None:
        """Add every ``{class}.npz`` of a directory to the bank, in file
        name order. The files hold RAW codes (the meta-test saves them
        before normalization), so they are normalized here as
        ``register_class`` does, unless the code generator is the
        ROIEncoder, which emits final codes."""
        names, convs, biases = [], [], []
        for fname in sorted(os.listdir(path)):
            if not fname.endswith(".npz"):
                continue
            data = np.load(os.path.join(path, fname))
            names.append(fname[:-4])
            convs.append(np.asarray(data["cls_conv"], np.float32).reshape(-1))
            biases.append(np.asarray(data["cls_bias"], np.float32)
                          .reshape(()))
        if not names:
            return
        code = {"cls_conv": torch.as_tensor(np.stack(convs),
                                            device=self.device),
                "cls_bias": torch.as_tensor(np.stack(biases),
                                            device=self.device)}
        if self.model.code_generator_name != "ROIEncoder":
            with torch.inference_mode():
                code = self.model.normalize_code(code)
        for i, name in enumerate(names):
            self.bank.add(name, code["cls_conv"][i], code["cls_bias"][i])

    # ------------------------------------------------------ registration
    @torch.inference_mode()
    def class_code(self, support_images: Sequence[np.ndarray],
                   support_boxes: Sequence[np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """The bank's code (1 row) of one class from K support crops,
        each resized, cropped and padded to TPU.SUPPORT_CANVAS: normalized,
        or as the ROIEncoder emits it."""
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
        code = {"cls_conv": raw["cls_conv"], "cls_bias": raw["cls_bias"]}
        if self.model.code_generator_name == "ROIEncoder":
            return code
        return self.model.normalize_code(code)

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

    def prepare_device(self, image: np.ndarray):
        """``prepare`` with the resize on the card: the raw RGB frame is
        uploaded as it is, its channels are reversed to BGR there and
        ``resize_shortest_edge_device`` resizes it into a float32 canvas.
        Returns None when the frame is larger than the eval canvas: the
        caller then takes the host path, as the JAX package does.

        The JAX package stages the frame into an eval-canvas-sized buffer
        so that one compiled graph serves every frame size; eager torch has
        no such constraint, so the frame itself is the staging tensor and
        the host does no copy beyond the upload."""
        img = np.ascontiguousarray(image)
        oh, ow = img.shape[:2]
        if oh > self.eval_canvas[0] or ow > self.eval_canvas[1]:
            return None
        frame = torch.as_tensor(img, device=self.device)
        if self.cfg.INPUT.FORMAT == "BGR":
            frame = frame.flip(-1)  # input assumed RGB; model wants BGR
        canvas, content = resize_shortest_edge_device(
            frame, (oh, ow), out_hw=self.eval_canvas,
            short=self.cfg.INPUT.MIN_SIZE_TEST,
            max_size=self.cfg.INPUT.MAX_SIZE_TEST)
        rh, rw = int(content[0]), int(content[1])
        size = torch.tensor([[rh, rw]], device=self.device)
        return canvas[None], size, (oh, ow, rh, rw)

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
        """Detect registered classes in one RGB image. With
        ``device_preprocess`` the resize runs on the card when the frame
        fits the eval canvas, on the host otherwise."""
        prepared = self.prepare_device(image) if device_preprocess else None
        canvas, size, hw = prepared or self.prepare(image)
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
        """Register every class of a registered dataset from its K-shot
        support sets (reference _generate_class_code_from_dataset,
        predictor.py:134-161). Returns the number of classes added."""
        from .data.catalog import DatasetCatalog
        from .data.loader import build_support_set_loader
        from .data.meta_dataset import MetaDataset
        from .evaluation.meta_eval import (generate_class_codes,
                                           normalize_class_codes)

        shot = shot or self.cfg.MODEL.META_LEARN.EVAL_SHOT
        ds = MetaDataset(DatasetCatalog.get(dataset_name),
                         "episodic_test_supportset", num_shot=shot,
                         meta_test_seed=meta_test_seed)
        codes = generate_class_codes(
            self.model, build_support_set_loader(ds, self.mapper),
            class_batch=self.cfg.TPU.CLASS_BATCH, device=self.device)
        bank = normalize_class_codes(self.model, codes, device=self.device)
        for row, cid in enumerate(sorted(codes)):
            self.bank.add(codes[cid]["class_name"], bank["cls_conv"][row],
                          bank["cls_bias"][row])
        return len(codes)

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
