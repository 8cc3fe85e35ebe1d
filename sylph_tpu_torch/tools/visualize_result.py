"""Draw COCO-format detections on their images (the port's counterpart of
``tools/visualize_result.py``; reference tools/visualize_result.py).

    python3 -m sylph_tpu_torch.tools.visualize_result \
        --results dets.json --image-root datasets/coco/val2017 \
        --out-dir vis/ [--thresh 0.5] [--max-images 50]

``--results`` is a JSON list of the evaluator's detection dicts
(``image_id``, ``category_id``, ``bbox`` as x, y, w, h, ``score``); each
image ``<image_id:012d>.jpg`` found under ``--image-root`` is written to
``--out-dir`` with its boxes above ``--thresh``. Host only.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

from PIL import Image, ImageDraw


def draw(image_path, dets, out_path, thresh, names=None) -> None:
    img = Image.open(image_path).convert("RGB")
    d = ImageDraw.Draw(img)
    for det in dets:
        if det["score"] < thresh:
            continue
        x, y, w, h = det["bbox"]
        cid = det["category_id"]
        color = tuple(int(c) for c in
                      [(cid * 67) % 255, (cid * 131) % 255, (cid * 29) % 255])
        d.rectangle([x, y, x + w, y + h], outline=color, width=2)
        label = names.get(cid, str(cid)) if names else str(cid)
        d.text((x + 2, y + 2), f"{label}:{det['score']:.2f}", fill=color)
    img.save(out_path)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--results", required=True,
                   help="json list of COCO-format detections")
    p.add_argument("--image-root", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--thresh", type=float, default=0.5)
    p.add_argument("--max-images", type=int, default=50)
    args = p.parse_args(argv)

    with open(args.results) as f:
        dets = json.load(f)
    by_img = defaultdict(list)
    for d in dets:
        by_img[d["image_id"]].append(d)
    os.makedirs(args.out_dir, exist_ok=True)
    for i, (img_id, img_dets) in enumerate(sorted(by_img.items())):
        if i >= args.max_images:
            break
        fname = f"{img_id:012d}.jpg"
        src = os.path.join(args.image_root, fname)
        if not os.path.exists(src):
            continue
        draw(src, img_dets, os.path.join(args.out_dir, fname), args.thresh)
    print(f"wrote visualizations to {args.out_dir}")


if __name__ == "__main__":
    main()
