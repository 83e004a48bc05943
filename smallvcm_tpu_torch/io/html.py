"""HTML report writer: thumbnail matrix + interactive 4-way split compare.

Carried over unchanged from ``smallvcm_tpu/io/html.py`` (host code).
Capability-parity rewrite of html_writer.hxx + FullReport (smallvcm.cxx:
156-263): one table row of 7 algorithm thumbnails per scene, green/red
borders from the subjective good/poor matrix (smallvcm.cxx:184-201), and a
mouse-driven four-way PPM/BPM/BPT/VCM split view per scene. The split is
implemented with dependency-free vanilla JS instead of the reference's
bundled jQuery plugin.
"""

from __future__ import annotations

from typing import List, Tuple

# Border colors
NONE, RED, GREEN = 0, 1, 2

# Subjective per-scene algorithm quality (smallvcm.cxx:184-201); indices into
# the el/pt/lt/ppm/bpm/bpt/vcm order.
GOOD_ALGORITHMS = {
    0: {"vcm", "bpm"},
    1: {"vcm", "bpm"},
    2: {"vcm", "bpm"},
    3: {"vcm", "bpt"},
}
POOR_ALGORITHMS = {
    0: {"bpt"},
    1: {"bpt", "ppm"},
    2: {"ppm"},
    3: {"bpm", "ppm"},
}

_HEADER = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>Comparison of GI algorithms with Vertex Connection and Merging</title>
<style>
body { font-family: arial, sans-serif; }
.thumb { line-height: 90%; text-align: center; }
.thumb img { border: 5px solid #ccc; }
.thumb img.good { border-color: #0c0; }
.thumb img.poor { border-color: #f00; }
.cross-compare { position: relative; overflow: hidden; cursor: crosshair; }
.cross-compare img { position: absolute; top: 0; left: 0; }
.cross-compare .quad { position: absolute; top: 0; left: 0; overflow: hidden; }
.cross-compare .cap { position: absolute; z-index: 20; color: #fff;
  padding: 5px; font-size: 12px; text-shadow: 0 0 3px #000; }
.cross-compare .divider-v { position: absolute; top: 0; width: 3px;
  height: 100%; background: #333; z-index: 10; }
.cross-compare .divider-h { position: absolute; left: 0; height: 3px;
  width: 100%; background: #333; z-index: 10; }
</style>
</head>
<body>
<script>
function setupCross(el) {
  const imgs = el.querySelectorAll('img.layer');
  const w = parseInt(el.style.width), h = parseInt(el.style.height);
  function update(x, y) {
    const quads = el.querySelectorAll('.quad');
    // quads order: tl, tr, bl, br
    quads[0].style.width = x + 'px';  quads[0].style.height = y + 'px';
    quads[1].style.left = x + 'px';   quads[1].style.width = (w - x) + 'px';
    quads[1].style.height = y + 'px';
    quads[2].style.top = y + 'px';    quads[2].style.width = x + 'px';
    quads[2].style.height = (h - y) + 'px';
    quads[3].style.left = x + 'px';   quads[3].style.top = y + 'px';
    quads[3].style.width = (w - x) + 'px'; quads[3].style.height = (h - y) + 'px';
    // keep each quad's image anchored to the container origin
    quads[1].querySelector('img').style.left = -x + 'px';
    quads[2].querySelector('img').style.top = -y + 'px';
    quads[3].querySelector('img').style.left = -x + 'px';
    quads[3].querySelector('img').style.top = -y + 'px';
    el.querySelector('.divider-v').style.left = x + 'px';
    el.querySelector('.divider-h').style.top = y + 'px';
    const caps = el.querySelectorAll('.cap');
    caps[0].style.left = '5px'; caps[0].style.top = '5px';
    caps[1].style.right = '5px'; caps[1].style.top = '5px';
    caps[2].style.left = '5px'; caps[2].style.bottom = '5px';
    caps[3].style.right = '5px'; caps[3].style.bottom = '5px';
  }
  el.addEventListener('mousemove', (e) => {
    const r = el.getBoundingClientRect();
    update(Math.max(1, Math.min(w - 1, e.clientX - r.left)),
           Math.max(1, Math.min(h - 1, e.clientY - r.top)));
  });
  update(w / 2, h / 2);
}
window.addEventListener('DOMContentLoaded', () => {
  document.querySelectorAll('.cross-compare').forEach(setupCross);
});
</script>
"""


class HtmlWriter:
    def __init__(self, filename: str, thumbnail_size: int = 128):
        self.filename = filename
        self.thumbnail_size = thumbnail_size
        self.parts: List[str] = [_HEADER]

    def add_scene(self, scene_name: str):
        self.parts.append(f"<h2>{scene_name}</h2>\n<table><tr>\n")

    def add_rendering(
        self, method_name: str, file_name: str, seconds: float,
        border: int = NONE, other_info: str = "",
    ):
        cls = {GREEN: "good", RED: "poor"}.get(border, "")
        ts = self.thumbnail_size
        self.parts.append(
            f'<td valign="top" align="center"><div class="thumb" '
            f'style="width:{ts + 10}px;">'
            f'<a href="{file_name}"><img class="{cls}" src="{file_name}" '
            f'width="{ts}px" height="{ts}px" '
            f'alt="{file_name} ({seconds:.2f} s)"/></a>'
            f'<br/><small>{method_name} ({seconds:.2f} s){other_info}'
            f"</small></div></td>\n"
        )

    def add_four_way_split(
        self, files: List[str], names: List[str], borders: List[int],
        size: int,
    ):
        """Mouse-driven 4-way split (tl/tr/bl/br = files[0..3]).

        Captions carry the per-algorithm good/poor color, mirroring the
        reference's colored borders on the split images
        (html_writer.hxx:330-356)."""
        quads = []
        for f, n in zip(files, names):
            quads.append(
                f'<div class="quad"><img class="layer" src="{f}" '
                f'width="{size}" height="{size}"/></div>'
            )
        cap_color = {GREEN: "#0c0", RED: "#f00"}
        caps = "".join(
            f'<div class="cap" style="border:2px solid '
            f'{cap_color.get(b, "#ccc")}">{n}</div>'
            for n, b in zip(names, borders)
        )
        self.parts.append(
            "</tr></table>\n"
            f'<div class="cross-compare" '
            f'style="width:{size}px;height:{size}px;">'
            + "".join(quads)
            + '<div class="divider-v"></div><div class="divider-h"></div>'
            + caps
            + "</div>\n"
        )

    def close(self):
        self.parts.append("</body>\n</html>\n")
        with open(self.filename, "w") as f:
            f.write("".join(self.parts))
