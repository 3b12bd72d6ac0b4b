"""Build the static HTML documentation site into docs/site/.

The reference ships a Sphinx-built HTML site (/root/reference/doc/,
conf.py + make html).  This environment has no sphinx, but the stdlib-adjacent
``markdown`` package is available — one command renders every markdown doc
(top-level guides + the generated API reference) into a navigable static
site with a shared stylesheet and sidebar:

    JAX_PLATFORMS=cpu python docs/build_site.py

Regenerate the API pages first when the package changed:

    JAX_PLATFORMS=cpu python docs/gen_api.py && python docs/build_site.py
"""
import pathlib
import re
import shutil

import markdown

DOCS = pathlib.Path(__file__).resolve().parent
ROOT = DOCS.parent
SITE = DOCS / "site"

GUIDES = [
    ("index", ROOT / "README.md", "Overview"),
    ("TUTORIAL", DOCS / "TUTORIAL.md", "Tutorial"),
    ("THEORY", DOCS / "THEORY.md", "Theory"),
    ("EXTENDING", DOCS / "EXTENDING.md", "Extending"),
    ("PARITY", DOCS / "PARITY.md", "Reference parity"),
    ("REFERENCES", DOCS / "REFERENCES.md", "References"),
]

CSS = """
:root { --fg:#1a1a24; --bg:#ffffff; --accent:#7a2048; --side:#f4f2f0; --code:#f6f4f8; }
* { box-sizing: border-box; }
body { margin:0; font:16px/1.6 Georgia, 'Times New Roman', serif; color:var(--fg); background:var(--bg); }
nav { position:fixed; top:0; left:0; bottom:0; width:240px; overflow-y:auto;
      background:var(--side); padding:1.2rem 1rem; border-right:1px solid #ddd;
      font-family:system-ui, sans-serif; font-size:.85rem; }
nav h2 { font-size:.75rem; text-transform:uppercase; letter-spacing:.08em; color:#777; margin:1.1rem 0 .3rem; }
nav a { display:block; color:var(--fg); text-decoration:none; padding:.12rem 0; }
nav a:hover { color:var(--accent); }
nav a.current { color:var(--accent); font-weight:600; }
main { margin-left:240px; max-width:58rem; padding:2rem 3rem 5rem; }
h1,h2,h3 { font-family:system-ui, sans-serif; line-height:1.25; }
h1 { border-bottom:2px solid var(--accent); padding-bottom:.3rem; }
code, pre { font-family:ui-monospace, 'SF Mono', Menlo, monospace; font-size:.85em; }
code { background:var(--code); padding:.08em .3em; border-radius:3px; }
pre { background:var(--code); padding: .9em 1.1em; border-radius:6px; overflow-x:auto; }
pre code { background:none; padding:0; }
table { border-collapse:collapse; width:100%; font-size:.92em; }
th, td { border:1px solid #ddd; padding:.35em .6em; text-align:left; vertical-align:top; }
th { background:var(--side); font-family:system-ui, sans-serif; }
a { color:var(--accent); }
"""

PAGE = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — pycsou_tpu</title>
<link rel="stylesheet" href="{prefix}style.css"></head>
<body><nav>{nav}</nav><main>{body}</main></body></html>
"""


def _md(text: str) -> str:
    return markdown.markdown(
        text, extensions=["tables", "fenced_code", "toc", "sane_lists"]
    )


def _relink(html: str, api: bool) -> str:
    """Rewrite intra-repo markdown links to the rendered pages."""
    def sub(m):
        href = m.group(1)
        base = href.split("#")[0]
        frag = href[len(base):]
        name = pathlib.PurePosixPath(base).name[:-3]
        if base.startswith("docs/api/") or (api and "/" not in base):
            return f'href="{"" if api else "api/"}{name}.html{frag}"'
        return f'href="{"../" if api else ""}{name}.html{frag}"'

    return re.sub(r'href="([^"]+\.md(?:#[^"]*)?)"', sub, html)


def _nav(current: str, api_pages, in_api: bool) -> str:
    p = "../" if in_api else ""
    items = ["<h2>Guides</h2>"]
    for name, _, label in GUIDES:
        cls = ' class="current"' if name == current else ""
        items.append(f'<a href="{p}{name}.html"{cls}>{label}</a>')
    items.append("<h2>API reference</h2>")
    for name in api_pages:
        cls = ' class="current"' if name == current else ""
        items.append(f'<a href="{p}api/{name}.html"{cls}>{name}</a>')
    return "\n".join(items)


def main():
    shutil.rmtree(SITE, ignore_errors=True)
    (SITE / "api").mkdir(parents=True)
    (SITE / "style.css").write_text(CSS)

    api_srcs = sorted((DOCS / "api").glob("*.md"))
    api_pages = [p.stem for p in api_srcs]

    for name, path, label in GUIDES:
        body = _relink(_md(path.read_text()), api=False)
        (SITE / f"{name}.html").write_text(
            PAGE.format(title=label, prefix="", nav=_nav(name, api_pages, False), body=body)
        )
    for src in api_srcs:
        body = _relink(_md(src.read_text()), api=True)
        (SITE / "api" / f"{src.stem}.html").write_text(
            PAGE.format(
                title=src.stem, prefix="../",
                nav=_nav(src.stem, api_pages, True), body=body,
            )
        )
    n = len(GUIDES) + len(api_srcs)
    print(f"docs/site: {n} pages rendered ({len(api_srcs)} API)")


if __name__ == "__main__":
    main()
