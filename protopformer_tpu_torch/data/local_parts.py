"""CUB-200-2011 part/bbox annotation parsing (port of
``protopformer_tpu/data/local_parts.py``).

Replaces tools/local_parts.py:8-71, which parses ``images.txt``,
``bounding_boxes.txt`` and ``parts/part_locs.txt`` into id->path/bbox/parts
dicts AT IMPORT TIME with a hardcoded root. Here it is an explicit function
of the dataset root (used by tools/eval_interpretability.py's consistency
score)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

NUM_PARTS = 15  # CUB annotates 15 parts per bird


@dataclass
class CubPartAnnotations:
    id_to_path: Dict[int, str]
    id_to_bbox: Dict[int, Tuple[float, float, float, float]]  # x, y, w, h
    # per image: list of [part_id (1-based), int x, int y] for VISIBLE parts
    # only (coords truncated like ref local_parts.py:67)
    id_to_part_loc: Dict[int, List[Tuple[int, int, int]]]

    def path_to_id(self) -> Dict[str, int]:
        return {p: i for i, p in self.id_to_path.items()}


def in_bbox(x: float, y: float, bbox: Tuple[float, float, float, float]) -> bool:
    """Point-in-(x, y, w, h)-box test (ref: local_parts.py:8-9)."""
    bx, by, bw, bh = bbox
    return bx <= x <= bx + bw and by <= y <= by + bh


def load_cub_parts(data_root: str) -> CubPartAnnotations:
    """Parse the stock CUB metadata files under ``data_root``
    (the directory containing images.txt)."""
    id_to_path = {}
    with open(os.path.join(data_root, "images.txt")) as f:
        for line in f:
            i, p = line.split()
            id_to_path[int(i)] = p

    id_to_bbox = {}
    with open(os.path.join(data_root, "bounding_boxes.txt")) as f:
        for line in f:
            i, x, y, w, h = line.split()
            id_to_bbox[int(i)] = (float(x), float(y), float(w), float(h))

    id_to_part_loc: Dict[int, List[Tuple[int, int, int]]] = {}
    with open(os.path.join(data_root, "parts", "part_locs.txt")) as f:
        for line in f:
            img_id, part_id, x, y, visible = line.split()
            if int(visible):
                # coordinates int-truncated at parse time, exactly like the
                # reference (local_parts.py:67: int(float(loc_x)))
                id_to_part_loc.setdefault(int(img_id), []).append(
                    (int(part_id), int(float(x)), int(float(y)))
                )
    return CubPartAnnotations(id_to_path, id_to_bbox, id_to_part_loc)
