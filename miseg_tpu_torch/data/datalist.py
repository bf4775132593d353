"""Decathlon-style datalist loading with modality injection: the port's
copy of `miseg_tpu/data/datalist.py`.

Load the split JSON, inject the file-level `modality` int (0 = CT,
1 = MR) into every item, and resolve relative paths against `base_dir`.
"""

from __future__ import annotations

import json
from pathlib import Path


def _append_paths(base_dir: Path, is_segmentation: bool, items: list) -> list:
    out = []
    for item in items:
        if not isinstance(item, dict):
            item = {"image": item}
        item = dict(item)
        for k in ("image", "label"):
            if k in item and isinstance(item[k], str):
                item[k] = str(base_dir / item[k])
        out.append(item)
    return out


def load_decathlon_datalist_with_modality(
        data_list_file_path: str | Path, is_segmentation: bool = True,
        data_list_key: str = "training", base_dir: str | Path | None = None
) -> list[dict]:
    path = Path(data_list_file_path)
    if not path.is_file():
        raise ValueError(f"Data list file {path} does not exist.")
    with open(path) as f:
        json_data = json.load(f)
    if data_list_key not in json_data:
        raise ValueError(f'Data list {data_list_key} not specified in "{path}".')
    datalist = json_data[data_list_key]
    if data_list_key == "test" and datalist and not isinstance(datalist[0], dict):
        datalist = [{"image": i} for i in datalist]
    modality = json_data.get("modality", 0)
    for item in datalist:
        if isinstance(item, dict):
            item["modality"] = modality
    base = Path(base_dir) if base_dir is not None else path.parent
    return _append_paths(base, is_segmentation, datalist)
