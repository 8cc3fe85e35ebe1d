"""A 2-D scatter of class codes (the port's counterpart of
``tools/visualize_class_codes.py``; reference
tools/visualize_class_codes.py:74-119).

    python3 -m sylph_tpu_torch.tools.visualize_class_codes \
        --code-dir out/class_codes/<dataset> --out codes.png [--method pca]

Reads every ``<class>.npz`` of ``--code-dir`` (its ``cls_conv``), embeds the
codes with t-SNE (sklearn) or PCA (numpy; also where sklearn is missing)
and draws them with matplotlib; without matplotlib it writes the
coordinates to ``<out>.txt``. Host only.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np


def load_codes(code_dir: str) -> Tuple[List[str], np.ndarray]:
    names, vecs = [], []
    for fname in sorted(os.listdir(code_dir)):
        if fname.endswith(".npz"):
            data = np.load(os.path.join(code_dir, fname))
            vecs.append(np.asarray(data["cls_conv"]).reshape(-1))
            names.append(fname[:-4])
    return names, np.stack(vecs)


def embed(x: np.ndarray, method: str) -> np.ndarray:
    """(N, D) -> (N, 2): t-SNE, or the projection on the two leading
    principal axes."""
    if method == "tsne":
        try:
            from sklearn.manifold import TSNE
            return TSNE(n_components=2,
                        perplexity=min(30, len(x) - 1)).fit_transform(x)
        except ImportError:
            print("sklearn unavailable; falling back to PCA")
    x = x - x.mean(0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:2].T


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--code-dir", required=True)
    p.add_argument("--out", default="class_codes.png")
    p.add_argument("--method", choices=["tsne", "pca"], default="tsne")
    args = p.parse_args(argv)

    names, vecs = load_codes(args.code_dir)
    xy = embed(vecs, args.method)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        np.savetxt(args.out + ".txt",
                   np.column_stack([xy, np.arange(len(names))]),
                   header="x y idx  # " + " ".join(names))
        print(f"matplotlib unavailable; wrote coordinates to {args.out}.txt")
        return
    fig, ax = plt.subplots(figsize=(10, 10))
    ax.scatter(xy[:, 0], xy[:, 1], s=12)
    for (x, y), n in zip(xy, names):
        ax.annotate(n, (x, y), fontsize=6)
    ax.set_title(f"class codes ({args.method})")
    fig.savefig(args.out, dpi=150)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
