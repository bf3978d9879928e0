"""The NW stage of the scoring-grid search (evaluate_text_alignment.py:
178-198): ``align.api.align_grid(transcript, ocr, rows)`` over every row
of the grid, one fixture pair a call, the fixtures in turn. Each pair is
the transcript of ``pages_per_fixture`` seeded pages against an injected
OCR stream of them (substitutions and deletions, spaces at word gaps,
abbreviations expanded), page after page. The raster and the OCR are not
run.

Traffic keys: ``fixtures``, ``pages_per_fixture``, ``length`` (each
pair's transcript and OCR cut to this many characters, so every seed
aligns pairs of one size: the pages hold more on every seed),
``sub_rate``, ``del_rate``, ``scoring_grid``
(the lists whose product is the grid), ``check_rows`` (rows of each
fixture, drawn from the seed, that the check compares in every call),
``trace_grids`` (calls the traced run profiles)."""

from __future__ import annotations

from itertools import product

import numpy as np

from .. import common, stats, work
from ..reference import nw
from ..reference.abbreviations import expand_abbreviations


class Cell:
    def __init__(self, config, traffic, seed, device, workdir, trace):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.trace = device, trace
        self.rows = np.array(list(product(*traffic["scoring_grid"])),
                             np.int64)
        self.n_fix = traffic["fixtures"]

    def setup(self):
        from text_alignment_tpu_torch.align.api import align_grid

        self.align_grid = align_grid
        k, n = self.traffic["pages_per_fixture"], self.traffic["length"]
        pages = common.make_pages(self.config, self.seed, self.n_fix * k,
                                  tag=4)
        self.pairs = []
        for i in range(self.n_fix):
            own = pages[i * k:(i + 1) * k]
            ocr = " ".join(
                "".join(c.char for c in expand_abbreviations(
                    common.injected_ocr(p, common.rng(self.seed, 5, i, j),
                                        self.traffic["sub_rate"],
                                        self.traffic["del_rate"])))
                for j, p in enumerate(own))
            transcript = " ".join(p.transcript for p in own)
            if min(len(transcript), len(ocr)) < n:
                raise RuntimeError(f"fixture {i}: a pair shorter than {n}")
            self.pairs.append((list(transcript[:n]), list(ocr[:n])))
        g = common.rng(self.seed, 6)
        self.sample = [np.sort(g.choice(len(self.rows),
                                        self.traffic["check_rows"],
                                        replace=False))
                       for _ in range(self.n_fix)]
        for f in range(self.n_fix):  # every fixture's shapes once
            self._grid(f)

    def _grid(self, f):
        t, o = self.pairs[f]
        return self.align_grid(t, o, self.rows, device=self.device)

    def step(self, i):
        f = i % self.n_fix
        out = self._grid(f)
        kept = {int(r): ("".join(out[r][0]), "".join(out[r][1]))
                for r in self.sample[f]}
        return {"fixture": f, "units": len(self.rows), "out": kept}

    def e2e(self, records, t_start, t_end):
        return {"grid_combos_per_s": stats.rate(
            sum(r["units"] for r in records), t_start, t_end)}

    def reference_rows(self, f, saturate=None):
        t, o = self.pairs[f]
        out = {}
        for r in self.sample[f]:
            a, b = nw.align(t, o, [int(v) for v in self.rows[r]], saturate)
            out[int(r)] = ("".join(a), "".join(b))
        return out

    def check(self, records):
        refs = [self.reference_rows(f) for f in range(self.n_fix)]
        bad = 0
        for rec in records:
            want = refs[rec["fixture"]]
            bad += sum(rec["out"][r] != want[r] for r in want)
        return {"grid_rows_diff": bad}

    def control(self):
        """The control's number: the reference in the program's place with
        its scores clamped to int8 at each step."""
        bad = 0
        for f in range(self.n_fix):
            want = self.reference_rows(f)
            got = self.reference_rows(f, saturate=8)
            bad += sum(got[r] != want[r] for r in want)
        return {"grid_rows_diff": bad}

    def work(self, traced):
        w = work.Work()
        for rec in traced:
            t, o = self.pairs[rec["fixture"]]
            w.add("nw_fill", *work.nw_fill([len(t)], [len(o)],
                                           len(self.rows)))
        return w

    def spans(self):
        return {}

    def trace_items(self):
        return self.traffic["trace_grids"]

    def notes(self):
        return [f"fixture pairs (transcript x OCR): "
                f"{[(len(t), len(o)) for t, o in self.pairs]}"]

    def free(self):
        pass
