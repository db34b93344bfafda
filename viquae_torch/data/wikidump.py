"""Stream-parse a Wikimedia Commons XML dump for per-category image metadata
(parity meerqat/data/wikidump.py:24-126)."""
from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import Dict, Iterable, Optional

NAMESPACE = "{http://www.mediawiki.org/xml/export-0.10/}"
FILE_NS = "6"  # MediaWiki namespace id for File: pages

# template fields are always introduced by a top-level '|'; the VALUE is
# then scanned with {{ }} / [[ ]] depth tracking (see get_field) so pipes
# inside nested templates or links don't terminate it, while a same-line
# '|next_field=' does (single-line {{Information}} templates are common)
_FIELD_START = {
    f: re.compile(rf"\|\s*{f}\s*=", re.IGNORECASE)
    for f in ("description", "author", "date")
}
_CATEGORY_RE = re.compile(r"\[\[Category:([^\]\|]+)", re.IGNORECASE)


def iter_pages(path) -> Iterable[ET.Element]:
    """Stream <page> elements, clearing memory as we go (dump-scale safe)."""
    for _, element in ET.iterparse(str(path), events=("end",)):
        if element.tag == f"{NAMESPACE}page":
            yield element
            element.clear()


def find_text(element: ET.Element, tag: str) -> Optional[str]:
    child = element.find(f"{NAMESPACE}{tag}")
    return child.text if child is not None else None


def get_field(wikitext: str, field: str) -> Optional[str]:
    s = wikitext or ""
    match = _FIELD_START[field].search(s)
    if match is None:
        return None
    start = i = match.end()
    depth = 0
    while i < len(s):
        two = s[i : i + 2]
        if two in ("{{", "[["):
            depth += 1
            i += 2
        elif (two == "]]" or two == "}}") and depth > 0:
            depth -= 1
            i += 2
        elif depth == 0 and (two == "}}" or s[i] == "|"):
            break  # end of template / next top-level field
        else:
            i += 1
    value = s[start:i].strip()
    return value or None


def get_categories(wikitext: str) -> list:
    return [c.strip() for c in _CATEGORY_RE.findall(wikitext or "")]


def process_page(page: ET.Element) -> Optional[dict]:
    """One File: page -> {title, categories, description, author, date}."""
    if find_text(page, "ns") != FILE_NS:
        return None
    title = find_text(page, "title")
    revision = page.find(f"{NAMESPACE}revision")
    wikitext = (
        find_text(revision, "text") if revision is not None else None
    ) or ""
    return {
        "title": title,
        "categories": get_categories(wikitext),
        "description": get_field(wikitext, "description"),
        "author": get_field(wikitext, "author"),
        "date": get_field(wikitext, "date"),
    }


def process_dump(dump_path, entity_categories: Dict[str, str]) -> Dict[str, list]:
    """Collect image metadata for every category mapped to an entity.

    entity_categories: {category_name: entity_qid}. Returns
    {qid: [image dicts]}.
    """
    out: Dict[str, list] = {}
    for page in iter_pages(dump_path):
        image = process_page(page)
        if image is None:
            continue
        for category in image["categories"]:
            qid = entity_categories.get(category)
            if qid is not None:
                out.setdefault(qid, []).append(image)
    return out
