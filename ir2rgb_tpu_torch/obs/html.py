"""Minimal HTML gallery writer.

Rebuild of the reference's ``util/html.py`` (SURVEY.md §2.4), which used
the ``dominate`` package (not available here — plain string templating is
all this needs): an index page of captioned image rows under
``<run_dir>/web/`` for visual inspection of results.

The port's copy of ``ir2rgb_tpu/obs/html.py``.
"""

from __future__ import annotations

import html as _html
import os
from typing import List, Sequence, Tuple


class HTMLPage:
    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.title = title
        self.refresh = refresh
        # each row carries its own display width — a page-global width
        # would retroactively resize earlier rows on save()
        self._rows: List[Tuple[str, List[Tuple[str, str]], int]] = []

    def add_header(self, text: str) -> None:
        self._rows.append(("header", [(text, "")], 0))

    def add_images(self, images: Sequence[str], captions: Sequence[str],
                   width: int = 256) -> None:
        self._rows.append(("images", list(zip(images, captions)), width))

    def save(self) -> str:
        parts = ["<!DOCTYPE html><html><head>",
                 f"<title>{_html.escape(self.title)}</title>"]
        if self.refresh:
            parts.append(f'<meta http-equiv="refresh" '
                         f'content="{self.refresh}">')
        parts.append(
            "<style>table{border-collapse:collapse}td{padding:4px;"
            "text-align:center;vertical-align:top}</style></head><body>")
        for kind, content, width in self._rows:
            if kind == "header":
                parts.append(f"<h3>{_html.escape(content[0][0])}</h3>")
            else:
                parts.append("<table><tr>")
                for img, cap in content:
                    # filenames come from dataset frame names: '#'/'?'
                    # truncate the URL and a quote breaks out of the
                    # attribute — quote for the URL, escape for the HTML
                    from urllib.parse import quote
                    url = _html.escape(quote(img))
                    parts.append(
                        f'<td><a href="images/{url}">'
                        f'<img src="images/{url}" width="{width}"></a><br>'
                        f'{_html.escape(cap)}</td>')
                parts.append("</tr></table>")
        parts.append("</body></html>")
        path = os.path.join(self.web_dir, "index.html")
        with open(path, "w") as fh:
            fh.write("\n".join(parts))
        return path
