"""Render HTML API documentation for the public package.

The reference builds Doxygen HTML from its public headers
(/root/reference/docs/Doxyfile.in, docs/meson.build:1-14); the analog
here renders every package module's docstrings to ``docs/api/``.  Uses
stdlib ``pydoc`` so the build works with zero extra dependencies
(``pdoc`` produces nicer output and runs in CI where pip is available —
see .github/workflows/ci.yml docs job).

Run:  python tools/build_docs.py  ->  docs/api/*.html + index.html
"""

from __future__ import annotations

import importlib
import os
import pathlib
import pydoc
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / "docs" / "api"

MODULES = [
    "airs_compression_tpu",
    "airs_compression_tpu.format.header",
    "airs_compression_tpu.format.params",
    "airs_compression_tpu.format.errors",
    "airs_compression_tpu.format.dtypes",
    "airs_compression_tpu.engine.context",
    "airs_compression_tpu.engine.host",
    "airs_compression_tpu.engine.checkpoint",
    "airs_compression_tpu.models.stream",
    "airs_compression_tpu.models.chunked",
    "airs_compression_tpu.ops.encode",
    "airs_compression_tpu.ops.decode",
    "airs_compression_tpu.ops.golomb",
    "airs_compression_tpu.ops.preprocess",
    "airs_compression_tpu.ops.bitpack",
    "airs_compression_tpu.ops.adapt",
    "airs_compression_tpu.ops.pallas_decode",
    "airs_compression_tpu.ops.routing",
    "airs_compression_tpu.ops.xxh32_device",
    "airs_compression_tpu.parallel.dp",
    "airs_compression_tpu.parallel.sp",
    "airs_compression_tpu.parallel.mesh",
    "airs_compression_tpu.parallel.gather",
    "airs_compression_tpu.utils.xxh32",
    "airs_compression_tpu.utils.bits",
    "airs_compression_tpu.utils.profiling",
    "airs_compression_tpu.cli.main",
    "airs_compression_tpu.cli.params_parse",
    "airs_compression_tpu.cli.fileio",
    "airs_compression_tpu.cli.logutil",
    "airs_compression_tpu.native",
]


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    html = pydoc.HTMLDoc()
    entries = []
    for name in MODULES:
        mod = importlib.import_module(name)
        page = pydoc.html.page(pydoc.describe(mod), html.document(mod, name))
        (OUT / f"{name}.html").write_text(page)
        first = (mod.__doc__ or "").strip().splitlines()
        entries.append((name, first[0] if first else ""))
        print(f"documented {name}")
    index = ["<html><head><title>airs_compression_tpu API</title></head>",
             "<body><h1>airs_compression_tpu API documentation</h1><dl>"]
    for name, summary in entries:
        index.append(f'<dt><a href="{name}.html">{name}</a></dt>'
                     f"<dd>{summary}</dd>")
    index.append("</dl></body></html>")
    (OUT / "index.html").write_text("\n".join(index))
    print(f"wrote {len(entries) + 1} pages to {OUT}")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())
