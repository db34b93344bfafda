"""Render questions + retrieval results as an HTML table
(parity meerqat/viz/html.py)."""
from __future__ import annotations

import html as html_lib
from pathlib import Path
from typing import Optional

from viquae_torch.rankeval import Run

HTML_TEMPLATE = """<html>
<head><style>
table {{ border-collapse: collapse; font-family: sans-serif; }}
td, th {{ border: 1px solid #ccc; padding: 6px; vertical-align: top; }}
img {{ max-width: {width}px; }}
</style></head>
<body><table>
{headers}
{rows}
</table></body></html>
"""


def get_top_1(item, run: Run) -> Optional[int]:
    results = run[item["id"]] if item["id"] in run else {}
    if not results:
        return None
    return int(next(iter(
        sorted(results.items(), key=lambda kv: -kv[1])
    ))[0])


def _passage_cell(i, passages, wiki):
    if i is None:
        return ""
    if passages is None and wiki is None:
        # no text corpora to resolve against: show the raw top-1 id
        return html_lib.escape(str(i))
    if passages is not None:
        passage = passages[int(i)]
        text = passage["passage"]
        url = (
            wiki[int(passage["index"])].get("url", "")
            if wiki is not None else ""
        )
    else:
        article = wiki[int(i)]
        text = article.get("wikipedia_title", "")
        url = article.get("url", "")
    escaped = html_lib.escape(str(text))
    if url:
        return f'<a href="{html_lib.escape(url)}">{escaped}</a>'
    return escaped


def dataset_to_html(
    dataset,
    output: str,
    n: Optional[int] = None,
    width: int = 400,
    passages=None,
    wiki=None,
    search_run: Optional[Run] = None,
    other_search_run: Optional[Run] = None,
    image_key: str = "image",
    image_root: str = "",
    seed: int = 42,
) -> str:
    """Write an HTML page of questions, images, answers and top-1 results."""
    items = list(dataset)
    if n is not None:
        import random

        random.Random(seed).shuffle(items)
        items = items[:n]
    headers = ["question", "image", "answer"]
    if search_run is not None:
        headers.append(search_run.name or "run A")
    if other_search_run is not None:
        headers.append(other_search_run.name or "run B")
    header_html = "<tr>" + "".join(f"<th>{h}</th>" for h in headers) + "</tr>"
    rows = []
    for item in items:
        cells = [
            html_lib.escape(item.get("input", "")),
            (
                f'<img src="{html_lib.escape(str(Path(image_root) / item[image_key]))}">'
                if item.get(image_key) else ""
            ),
            html_lib.escape(str(item.get("output", {}).get("original_answer", ""))),
        ]
        for run in (search_run, other_search_run):
            if run is not None:
                cells.append(_passage_cell(get_top_1(item, run), passages, wiki))
        rows.append("<tr>" + "".join(f"<td>{c}</td>" for c in cells) + "</tr>")
    page = HTML_TEMPLATE.format(
        width=width, headers=header_html, rows="\n".join(rows)
    )
    Path(output).write_text(page)
    return page
