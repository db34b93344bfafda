"""MS-Celeb crop extraction + Freebase<->Wikidata id mapping
(parity meerqat/data/mscelebs.py:20-84)."""
from __future__ import annotations

import base64
from pathlib import Path
from typing import Dict, Iterable, Optional, Set


def wikidata2freebase(mid: str) -> str:
    """'m.0xyz' <- wikidata P646 value '/m/0xyz'."""
    return mid[1:].replace("/", ".")


def freebase2wikidata_key(mid: str) -> str:
    """'m.0xyz' -> '/m/0xyz' (the P646 format)."""
    return "/" + mid.replace(".", "/")


def iter_mscelebs_rows(tsv_path) -> Iterable[tuple]:
    """Yield (mid, image_id, face_b64) from the MS-Celeb croped_face tsv."""
    with open(tsv_path, "rb") as f:
        for line in f:
            parts = line.rstrip(b"\n").split(b"\t")
            if len(parts) < 3:
                # a 2-field row would alias face_b64 (= parts[-1]) onto
                # the image-id column and feed garbage to b64decode
                continue
            mid = parts[0].decode()
            image_id = parts[1].decode() if len(parts) > 1 else ""
            face_b64 = parts[-1]
            yield mid, image_id, face_b64


def count_entities(entity_mids: Set[str], tsv_path) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for mid, _, _ in iter_mscelebs_rows(tsv_path):
        if mid in entity_mids:
            counts[mid] = counts.get(mid, 0) + 1
    return counts


def extract_faces(tsv_path, save_root, entity_mids: Optional[Set[str]] = None
                  ) -> int:
    """Decode base64 face crops to <save_root>/<mid>/<image_id>.jpg."""
    save_root = Path(save_root)
    n = 0
    for mid, image_id, face_b64 in iter_mscelebs_rows(tsv_path):
        if entity_mids is not None and mid not in entity_mids:
            continue
        target = save_root / mid
        target.mkdir(parents=True, exist_ok=True)
        (target / f"{image_id or n}.jpg").write_bytes(
            base64.b64decode(face_b64)
        )
        n += 1
    return n
