"""Shared data utilities: passage splitting, answer normalization, image io.

Behavioral parity with meerqat/data/loading.py (the functions every other
layer leans on), re-implemented without spaCy/torch:

- :func:`answer_preprocess`        <- data/loading.py:152-164
- :func:`remove_special_fields`    <- data/loading.py:235-249
- :func:`uniform_passages`         <- data/loading.py:274-306
- :func:`uniform_passages_of_sentences` <- data/loading.py:309-370
  (spaCy sentencizer swapped for viquae_torch.data.sentencize)
- :func:`make_passage_dataset`     <- data/loading.py:404-421
- :func:`make_mapping_dataset`     <- data/loading.py:214-232
- :func:`load_image` / `load_image_batch` / `load_faces` <- :108-149
"""
from __future__ import annotations

import json
import os
import re
import string
import warnings
from pathlib import Path
from typing import Dict, List, Optional

from viquae_torch.data import sentencize
from viquae_torch.data.utils import json_integer_keys  # noqa: F401 (re-export)


# --------------------------------------------------------------------------
# answer normalization (squad-style)
# --------------------------------------------------------------------------
def answer_preprocess(answer: str) -> str:
    """Lower, strip punctuation/articles/extra whitespace (squad metric)."""
    text = answer.lower()
    text = "".join(ch for ch in text if ch not in set(string.punctuation))
    text = re.sub(r"\b(a|an|the)\b", " ", text)
    return " ".join(text.split())


# --------------------------------------------------------------------------
# passage splitting
# --------------------------------------------------------------------------
def remove_special_fields(paragraphs: List[str]) -> List[str]:
    """Drop KILT title paragraph + section/bullet markers."""
    out = []
    for paragraph in paragraphs[1:]:
        if paragraph.startswith("Section::::") or paragraph.startswith("BULLET::::"):
            continue
        out.append(paragraph)
    return out


def paragraphs_preprocess(paragraphs, method: Optional[str] = None, **kwargs):
    methods = {None: lambda p: p, "special_fields": remove_special_fields}
    return methods[method](paragraphs, **kwargs)


def uniform_passages(paragraphs, tokenizer, n: int = 100,
                     title: Optional[str] = None) -> List[str]:
    """Split into fixed n-token chunks using a subword tokenizer.

    The output text is tokenizer-normalized (e.g. lower-cased), exactly as
    the reference's uniform_passages.
    """
    text = "".join(paragraphs)
    tokens = tokenizer.tokenize(text)
    if title is not None:
        title_norm = tokenizer.convert_tokens_to_string(tokenizer.tokenize(title))
        title = f"{title_norm} {tokenizer.sep_token} "
    passages = []
    for i in range(0, len(tokens), n):
        passage = tokenizer.convert_tokens_to_string(tokens[i: i + n])
        passages.append(title + passage if title is not None else passage)
    return passages


def uniform_passages_of_sentences(paragraphs, n: int = 100,
                                  title: Optional[str] = None,
                                  sep_token: str = "[SEP]") -> List[str]:
    """Sentence-preserving ~n-word chunks (original casing kept).

    A chunk may exceed n tokens only when a single sentence does.
    """
    text = "".join(paragraphs)
    if title is not None:
        title = f"{title} {sep_token} "
    passages, current, count = [], [], 0
    for sent in sentencize.sentences(text):
        n_tokens = sentencize.count_tokens(sent)
        if count + n_tokens > n:
            if current:
                passages.append(" ".join(current))
                current, count = [sent], n_tokens
            else:  # single over-long sentence
                passages.append(sent)
        else:
            current.append(sent)
            count += n_tokens
    if current:
        passages.append(" ".join(current))
    if title is not None:
        passages = [title + p for p in passages]
    return passages


def make_passages(paragraphs, method: Optional[str] = None,
                  preprocessing_method: Optional[str] = None,
                  preprocessing_kwargs: Optional[dict] = None, **kwargs):
    paragraphs = paragraphs_preprocess(
        paragraphs, method=preprocessing_method, **(preprocessing_kwargs or {})
    )
    methods = {
        None: lambda p: p,
        "uniform": uniform_passages,
        "uniform_sents": uniform_passages_of_sentences,
    }
    return methods[method](paragraphs, **kwargs)


def make_passage_dataset(input_path, output_path, prepend_title: bool = False,
                         **kwargs):
    """Build the passage dataset from an article dataset.

    Articles gain a ``passage_index`` column (their passages' indices);
    passages carry ``passage`` text and ``index`` (article back-pointer) —
    the join key the whole IR layer relies on.
    """
    from datasets import Dataset, load_from_disk

    dataset = load_from_disk(input_path)
    passage_dict = {"passage": [], "index": []}

    def per_item(item, index):
        title = item["wikipedia_title"] if prepend_title else None
        passages = make_passages(item["text"]["paragraph"], title=title, **kwargs)
        start = len(passage_dict["passage"])
        item["passage_index"] = list(range(start, start + len(passages)))
        passage_dict["passage"].extend(passages)
        passage_dict["index"].extend([index] * len(passages))
        return item

    # load_from_cache_file=False: per_item fills passage_dict as a side
    # channel, which a cache replay would silently skip
    dataset = dataset.map(
        per_item, with_indices=True, load_from_cache_file=False
    )
    passage_dataset = Dataset.from_dict(passage_dict)
    passage_dataset.save_to_disk(output_path)
    from viquae_torch.ir.embedding import save_in_place

    save_in_place(dataset, input_path)  # Arrow forbids in-place overwrite
    return passage_dataset


def make_mapping_dataset(dataset_path, key: str, save_name: str,
                         inverse: bool = False, one2many: bool = False):
    """Persist a JSON mapping column-value <-> row-index (e.g. title2index,
    article2passage)."""
    from datasets import load_from_disk

    dataset = load_from_disk(dataset_path)
    mapping: Dict = {}
    for index, value in enumerate(dataset[key]):
        k, v = (index, value) if not inverse else (value, index)
        if one2many:
            mapping.setdefault(k, []).append(v)
        else:
            mapping[k] = v
    with open(Path(dataset_path) / save_name, "w") as f:
        json.dump(mapping, f)
    return mapping


def make_sentences_item(item: dict, text_key: str = "text") -> dict:
    """Segment an item's text into sentences with token counts — the
    'sentences' column the ICT collator consumes (parity
    data/loading.py:425-441 with the in-repo sentencizer)."""
    item["sentences"] = [
        {"text": s, "n_tokens": sentencize.count_tokens(s)}
        for s in sentencize.sentences(item[text_key])
    ]
    return item


def make_sentences_dataset(dataset_path, text_key: str = "text",
                           map_kwargs: Optional[dict] = None):
    from datasets import load_from_disk

    dataset = load_from_disk(str(dataset_path))
    dataset = dataset.map(
        make_sentences_item, fn_kwargs={"text_key": text_key},
        **(map_kwargs or {}),
    )
    from viquae_torch.ir.embedding import save_in_place

    save_in_place(dataset, dataset_path)
    return dataset


# --------------------------------------------------------------------------
# image io (host-side; error-tolerant -> None, consumers mask)
# --------------------------------------------------------------------------
def get_images_path() -> Path:
    return Path(os.environ.get("VIQUAE_IMAGES_PATH", "."))


def load_image(file_name):
    from PIL import Image

    path = get_images_path() / file_name
    try:
        image = Image.open(path).convert("RGB")
    except Exception as e:  # noqa: BLE001 — parity: any decode failure -> None
        warnings.warn(f"Could not load image {path}: {e}")
        return None
    return image


def load_image_batch(file_names, pool=None):
    if pool is not None:
        return list(pool.map(load_image, file_names))
    return [load_image(f) for f in file_names]


def load_faces(image, root_face_path, max_n_faces: Optional[int] = None):
    """Load pre-cropped face image(s) for an image file name."""
    from PIL import Image

    root = Path(root_face_path)
    stem = Path(image).stem
    faces = sorted(root.glob(f"{stem}_face_*.jpg"))
    if max_n_faces is not None:
        faces = faces[:max_n_faces]
    out = []
    for face in faces:
        try:
            out.append(Image.open(face).convert("RGB"))
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"Could not load face {face}: {e}")
    return out or None


def map_if_not_None(fn, items):
    """Apply fn to non-None items, keep None placeholders
    (parity: meerqat/models/utils.py:29-68)."""
    out = []
    for item in items:
        out.append(None if item is None else fn(item))
    return out
