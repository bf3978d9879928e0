"""Training-transcription correction round trip — the `ocropus-gtedit`
equivalent of the reference's manual model-training workflow.

The reference trains its OCR models by hand (SURVEY.md §3.5; reference
README.md:52-56): segment pages into line crops, "use ocropus-gtedit to
look at the segmented lines and correct the transcriptions" in a browser,
extract the corrected ground truth, then ocropus-rtrain. This module owns
the middle two steps so the whole workflow runs inside this framework:

1. ``extract_lines(page, out_dir, stem)`` — per-line training crops from a
   page image, using the training cleaner's gentler raster recipe
   (reference clean_images_for_training.py:15-56); the "ocropus page
   segmentation" step. Crops are standard ink-black-on-white PNGs named
   ``{stem}_{i:04d}.png`` — exactly what ``train --lines-dir`` pairs with
   ``.gt.txt`` files.
2. ``make_html(lines_dir, out_html)`` — ONE self-contained HTML page (no
   server): each line image is base64-inlined above an editable text field
   prefilled from an existing ``X.gt.txt``, a recognizer pass, or empty.
   Edits mirror into the DOM ``value`` attribute (so a plain browser
   "Save page" persists them) and a button downloads all corrections as a
   TSV.
3. ``extract(saved, out_dir)`` — accepts either the browser-saved HTML or
   the downloaded TSV and writes the ``X.gt.txt`` files next to the crops.

Then ``python -m text_alignment_tpu_torch train --lines-dir ...`` consumes
the pairs (the ocropus-rtrain equivalent, models/train.py).
"""

from __future__ import annotations

import base64
import html as _html
import io
import os
from html.parser import HTMLParser

import numpy as np

_PAGE_TOP = """<!doctype html>
<html><head><meta charset="utf-8"><title>text_alignment_tpu_torch gtedit</title>
<style>
body { font-family: sans-serif; margin: 1em 2em; background: #fafafa; }
.line { margin: 1.2em 0; padding: .6em; background: #fff;
        border: 1px solid #ddd; border-radius: 4px; }
.line img { display: block; max-width: 100%; image-rendering: pixelated;
            border: 1px solid #eee; }
input.gt { width: 100%; margin-top: .4em; font-size: 1.15em;
           font-family: monospace; }
.stem { color: #888; font-size: .8em; }
</style></head><body>
<h1>Line transcription correction</h1>
<p>Edit the text under each line image, then either use your browser's
<b>Save page</b> (edits persist in the saved HTML) or click
<button onclick="dl()">download corrections.tsv</button> and run
<code>python -m text_alignment_tpu_torch gtedit extract &lt;saved&gt;</code>.</p>
<script>
function dl() {
  var rows = [];
  document.querySelectorAll('input.gt').forEach(function (i) {
    rows.push(i.name + '\\t' + i.value.replace(/[\\t\\n\\r]/g, ' '));
  });
  var blob = new Blob([rows.join('\\n') + '\\n'], {type: 'text/plain'});
  var a = document.createElement('a');
  a.href = URL.createObjectURL(blob);
  a.download = 'corrections.tsv';
  a.click();
}
</script>
"""


def save_line_png(img, path: str) -> None:
    """Write a line crop as a standard ink-black-on-white greyscale PNG
    (the polarity ``models.lineest_host.normalize_strip`` and ``train`` expect
    for non-bool images)."""
    from PIL import Image

    a = np.asarray(img)
    if a.dtype == bool:
        a = np.where(a, 0, 255).astype(np.uint8)  # True=ink -> black
    Image.fromarray(a).save(path)


def extract_lines(page_image, out_dir: str, stem: str,
                  backend: str = "host", preproc_params=None,
                  device=None) -> list[str]:
    """Segment ``page_image`` into per-line training crops under
    ``out_dir`` (named ``{stem}_{i:04d}.png``). Uses the training cleaner's
    raster recipe via ``training_data.union_line_strips`` (reference
    clean_images_for_training.py:43-56); ``device`` is the torch device
    of ``backend="device"`` (None: the card). Returns the written
    paths."""
    from .training_data import union_line_strips

    _, strips = union_line_strips(page_image, backend=backend,
                                  preproc_params=preproc_params,
                                  device=device)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, s in enumerate(strips):
        p = os.path.join(out_dir, f"{stem}_{i:04d}.png")
        save_line_png(s.img, p)
        paths.append(p)
    return paths


def _prefill_texts(lines_dir: str, stems: list[str], recognizer) -> dict:
    """Per-stem prefill text: X.gt.txt when present; otherwise one batched
    recognizer pass over the remaining crops (when a recognizer is given)."""
    texts = {}
    missing = []
    for stem in stems:
        gt = os.path.join(lines_dir, stem + ".gt.txt")
        if os.path.isfile(gt):
            with open(gt, encoding="utf-8") as f:
                texts[stem] = f.read().rstrip("\n")
        else:
            missing.append(stem)
    if recognizer is not None and missing:
        from PIL import Image

        imgs = [
            # crops from other tools may be RGB(A); the recognizer wants a
            # 2-D grey/onebit strip
            np.asarray(Image.open(os.path.join(lines_dir, s + ".png"))
                       .convert("L"))
            for s in missing
        ]
        rows = recognizer.recognize_batch(imgs)
        for stem, row in zip(missing, rows):
            texts[stem] = "".join(ch for ch, _ in row)
    return texts


def make_html(lines_dir: str, out_html: str, recognizer=None) -> int:
    """Render every ``*.png`` line crop in ``lines_dir`` into one
    self-contained correction page at ``out_html``. Returns the number of
    lines rendered."""
    stems = sorted(
        fn[:-4] for fn in os.listdir(lines_dir)
        if fn.endswith(".png")
    )
    texts = _prefill_texts(lines_dir, stems, recognizer)
    parts = [_PAGE_TOP]
    for stem in stems:
        with open(os.path.join(lines_dir, stem + ".png"), "rb") as f:
            b64 = base64.b64encode(f.read()).decode("ascii")
        val = _html.escape(texts.get(stem, ""), quote=True)
        name = _html.escape(stem, quote=True)
        parts.append(
            f'<div class="line"><span class="stem">{name}</span>'
            f'<img src="data:image/png;base64,{b64}" alt="{name}">'
            f'<input class="gt" type="text" name="{name}" value="{val}"'
            f' oninput="this.setAttribute(\'value\', this.value)"></div>\n'
        )
    parts.append("</body></html>\n")
    with open(out_html, "w", encoding="utf-8") as f:
        f.write("".join(parts))
    return len(stems)


class _GtInputParser(HTMLParser):
    def __init__(self):
        super().__init__()
        self.rows: dict[str, str] = {}

    def handle_starttag(self, tag, attrs):
        if tag != "input":
            return
        d = dict(attrs)
        if "gt" in (d.get("class") or "").split() and d.get("name"):
            self.rows[d["name"]] = d.get("value") or ""


def parse_corrections(path: str) -> dict[str, str]:
    """Read corrections from a browser-saved gtedit HTML page or the
    downloaded TSV. Returns {stem: text}."""
    with open(path, encoding="utf-8") as f:
        content = f.read()
    if content.lstrip()[:1] == "<":
        p = _GtInputParser()
        p.feed(content)
        return p.rows
    rows = {}
    for ln in content.splitlines():
        if not ln.strip():
            continue
        stem, _, text = ln.partition("\t")
        rows[stem] = text
    return rows


def extract(saved_path: str, out_dir: str) -> int:
    """Write ``{stem}.gt.txt`` files under ``out_dir`` from a saved
    correction page / TSV. Returns the number written. Stems are
    basename-sanitized (a crafted saved file cannot escape ``out_dir``)."""
    rows = parse_corrections(saved_path)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for stem, text in rows.items():
        safe = os.path.basename(stem)
        if not safe or safe != stem:
            continue
        if not text.strip():
            # an untouched (never-transcribed) row on a partially corrected
            # page must not become an empty-transcription CTC training pair
            continue
        with open(os.path.join(out_dir, safe + ".gt.txt"), "w",
                  encoding="utf-8") as f:
            f.write(text + "\n")
        n += 1
    return n
