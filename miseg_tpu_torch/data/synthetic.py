"""Synthetic MM-WHS-like dataset (counterpart of
`miseg_tpu/data/synthetic.py`): NIfTI volumes with blob-shaped
multi-class labels and the decathlon split JSONs of the reference's
layout (`dataset/MM-WHS/*.json`: a top-level `modality` int, then
training/validation/test lists).  The same seed writes the same volumes
as the JAX package.  `suffix=".nii"` writes uncompressed files.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .nifti import save_nifti


def _volume(rng: np.random.Generator, shape, num_classes: int, modality: int,
            mr_style: str = "legacy"):
    """Image with class-dependent blobs and its label map.  MR gets another
    intensity law.  `mr_style` (the JAX package's conditional-norm
    ablation): "legacy" (HU-like CT, MR-like offsets), "inverted" (MR with
    inverted contrast and 3x noise), "classswap" (MR with the class ->
    intensity ranking reversed, one affine for both), "derangement"
    (disjoint blobs, MR's foreground ranks shifted cyclically)."""
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape],
                             indexing="ij")
    label = np.zeros(shape, np.int16)
    inverted = modality == 1 and mr_style == "inverted"
    swapped = modality == 1 and mr_style in ("classswap", "derangement")
    sigma = 0.15 if inverted else 0.05
    img = rng.normal(0.9 if inverted else 0.0, sigma, shape).astype(np.float32)
    placed: list[tuple[np.ndarray, float]] = []  # (center, radius) of placed blobs
    for c in range(1, num_classes):
        center = rng.uniform(-0.5, 0.5, 3)
        radius = rng.uniform(0.15, 0.35)
        if mr_style == "derangement":
            # Disjoint blobs: intensity↔class must be a bijection within a
            # modality, so the ONLY ambiguity is the cross-modality relabel.
            for _ in range(100):
                if all(np.linalg.norm(center - pc) > radius + pr + 0.05
                       for pc, pr in placed):
                    break
                center = rng.uniform(-0.6, 0.6, 3)
                radius = rng.uniform(0.12, 0.22)
            placed.append((center, radius))
        blob = ((zz - center[0]) ** 2 + (yy - center[1]) ** 2
                + (xx - center[2]) ** 2) < radius ** 2
        label[blob] = c
        if inverted:
            img[blob] -= 0.25 + 0.12 * c  # darker than background, reversed
        elif mr_style == "classswap":
            rank = (num_classes - c) if swapped else c  # reversed class rank
            img[blob] += 0.2 + 0.2 * rank  # 4σ steps: separable per modality
        elif mr_style == "derangement":
            n_fg = num_classes - 1
            rank = (c % n_fg) + 1 if swapped else c  # cyclic: no fixed point
            img[blob] = rng.normal(0.2 + 0.2 * rank, sigma, img[blob].shape)
        else:
            img[blob] += 0.3 + 0.1 * c if modality == 0 else 1.0 - 0.1 * c
    if mr_style in ("classswap", "derangement"):
        img = img * 400 - 100  # identical affine: only label semantics differ
    else:
        img = img * 400 + (-100 if modality == 0 else 50)  # HU-ish vs MR-ish
    return img.astype(np.float32), label


def make_synthetic_dataset(root: str | Path, *, n_train: int = 2, n_val: int = 1,
                           n_test: int = 1, shape=(48, 48, 48),
                           num_classes: int = 4, modalities=(0, 1),
                           spacing=(1.5, 1.5, 1.5), seed: int = 0,
                           mr_style: str = "legacy", suffix: str = ".nii.gz") -> list[str]:
    """Write volumes and one JSON a modality under `root`; returns the JSON
    paths."""
    root = Path(root)
    jsons = []
    rng = np.random.default_rng(seed)
    for modality in modalities:
        name = "CT" if modality == 0 else "MR"
        sub = root / f"{name.lower()}_train"
        sub.mkdir(parents=True, exist_ok=True)
        affine = np.diag([*spacing, 1.0])
        affine[:3, :3] *= np.array([[-1], [-1], [1]])  # LPS-ish, exercises RAS reorient
        splits = {"training": n_train, "validation": n_val, "test": n_test}
        lists: dict[str, list] = {k: [] for k in splits}
        idx = 1000
        for split, n in splits.items():
            for _ in range(n):
                idx += 1
                img, lab = _volume(rng, shape, num_classes, modality,
                                   mr_style=mr_style)
                ipath = sub / f"{name.lower()}_train_{idx}_image{suffix}"
                lpath = sub / f"{name.lower()}_train_{idx}_label{suffix}"
                save_nifti(ipath, img, affine)
                save_nifti(lpath, lab, affine)
                lists[split].append({"image": str(ipath.relative_to(root)),
                                     "label": str(lpath.relative_to(root))})
        doc = {"name": "synthetic", "modality": modality,
               "labels": {str(i): f"class{i}" for i in range(num_classes)},
               "tensorImageSize": "3D", **lists}
        jpath = root / f"{name}.json"
        with open(jpath, "w") as f:
            json.dump(doc, f)
        jsons.append(str(jpath))
    return jsons
