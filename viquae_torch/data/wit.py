"""Build the WIT subset for multimodal ICT
(parity meerqat/data/wit.py: en-only, image-paired sections,
article-disjoint train/val/test splits, optional caption dedup).

Expected reference sizes for the full WIT dump: 877,635 / 48,271 / 48,815
(wit.py:15-18).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

from viquae_torch.data.wiki import VALID_ENCODING


def check_encoding(url: str) -> bool:
    return url.split(".")[-1].lower() in VALID_ENCODING


def row_is_valid(row: dict, downloaded_images: Optional[Set[str]] = None) -> bool:
    """en-only, valid encoding, downloaded, with section text."""
    if row.get("language") != "en":
        return False
    url = row.get("image_url", "")
    if not check_encoding(url):
        return False
    if downloaded_images is not None:
        name = url.split("/")[-1]
        if name not in downloaded_images:
            return False
    return bool(row.get("context_section_description"))


def fill_for_mict(rows: Iterable[dict],
                  downloaded_images: Optional[Set[str]] = None
                  ) -> Dict[str, dict]:
    """Group valid rows by article; keep section text + image pairs."""
    articles: Dict[str, dict] = {}
    for row in rows:
        if not row_is_valid(row, downloaded_images):
            continue
        title = row.get("page_title")
        articles.setdefault(title, {"title": title, "sections": []})
        articles[title]["sections"].append({
            "title": row.get("section_title") or "",
            "text": row["context_section_description"],
            "image": row["image_url"].split("/")[-1],
            "caption": row.get("caption_reference_description") or "",
        })
    return articles


def split_by_article(articles: Dict[str, dict], val_frac: float = 0.05,
                     test_frac: float = 0.05, seed: int = 42
                     ) -> Dict[str, List[dict]]:
    """Article-disjoint splits so no article leaks across train/val/test."""
    import numpy as np

    titles = sorted(articles)
    rng = np.random.default_rng(seed)
    rng.shuffle(titles)
    n = len(titles)
    n_val = int(n * val_frac)
    n_test = int(n * test_frac)
    split_titles = {
        "validation": titles[:n_val],
        "test": titles[n_val: n_val + n_test],
        "train": titles[n_val + n_test:],
    }
    out: Dict[str, List[dict]] = {}
    for split, names in split_titles.items():
        sections = []
        for t in names:
            for section in articles[t]["sections"]:
                sections.append({**section, "article": t})
        out[split] = sections
    return out


def dedup_captions(sections: Sequence[dict]) -> List[dict]:
    """Keep one section per unique (image, caption) pair (wit.py:185-191)."""
    seen = set()
    out = []
    for section in sections:
        key = (section.get("image"), section.get("caption"))
        if key in seen:
            continue
        seen.add(key)
        out.append(section)
    return out


def build_mict_dataset(tsv_rows: Iterable[dict], output_path=None,
                       downloaded_images: Optional[Set[str]] = None,
                       split: bool = True, seed: int = 42):
    """Full WIT-for-MICT build; returns (and saves) a DatasetDict."""
    from datasets import Dataset, DatasetDict

    articles = fill_for_mict(tsv_rows, downloaded_images)
    if split:
        splits = split_by_article(articles, seed=seed)
        out = DatasetDict({
            name: Dataset.from_list(rows) for name, rows in splits.items()
        })
    else:
        rows = [
            {**s, "article": t}
            for t, a in articles.items() for s in a["sections"]
        ]
        out = Dataset.from_list(rows)
    if output_path is not None:
        out.save_to_disk(str(output_path))
    return out
