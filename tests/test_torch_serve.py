"""The port's spool-directory serving loop (text_alignment_tpu_torch.serve)
on the CPU: the cases of tests/test_serve.py with ``device="cpu"``, and the
JAX package's ``serve`` against the port's on copies of one spool with
injected OCR pickles (byte-identical output JSON)."""

import json
import os
import pickle

import numpy as np
import pytest
from PIL import Image

import torch

from text_alignment_tpu_torch import serve as serve_mod
from text_alignment_tpu_torch.synth import (
    corrupt_ocr, make_page, ocr_with_spaces)

torch.set_num_threads(1)


def serve(spool, **kw):
    return serve_mod.serve(spool, device="cpu", **kw)


@pytest.fixture()
def spool(tmp_path):
    d = tmp_path / "spool"
    d.mkdir()
    return str(d)


def _make_job(spool, name, seed, **extra):
    page = make_page(np.random.default_rng(seed), n_lines=4,
                     words_per_line=2)
    Image.fromarray(page.image).save(os.path.join(spool, name + ".png"))
    ocr = ocr_with_spaces(
        corrupt_ocr(np.random.default_rng(seed + 1), page.char_boxes)
    )
    with open(os.path.join(spool, name + ".pickle"), "wb") as f:
        pickle.dump(ocr, f)
    job = {
        "image": name + ".png",
        "transcript": page.transcript,
        "existing_ocr_pickle": name + ".pickle",
        **extra,
    }
    with open(os.path.join(spool, name + ".job.json"), "w") as f:
        json.dump(job, f)
    return page


def test_serve_drains_spool_and_writes_results(spool):
    pages = {
        "folio_a": _make_job(spool, "folio_a", 500),
        "folio_b": _make_job(spool, "folio_b", 510,
                             output="out/custom_b.json"),
    }
    stats = serve(spool, model=None, backend="hybrid", once=True)
    assert (stats.processed, stats.failed) == (2, 0)

    names = sorted(os.listdir(spool))
    assert "folio_a.job.done" in names and "folio_b.job.done" in names
    assert not any(x.endswith(".job.json") or x.endswith(".failed")
                   for x in names)

    with open(os.path.join(spool, "folio_a.json")) as f:
        d = json.load(f)
    syls = "".join(s["syl"] for s in d["syl_boxes"])
    first_word = pages["folio_a"].transcript.split()[0]
    assert first_word.startswith(syls[: len(first_word)][:2])
    assert len(d["syl_boxes"]) > 4

    # custom output path honoured + recorded in the .done receipt
    assert os.path.isfile(os.path.join(spool, "out/custom_b.json"))
    with open(os.path.join(spool, "folio_b.job.done")) as f:
        receipt = json.load(f)
    assert receipt["result"].endswith("custom_b.json")


def test_serve_marks_bad_job_failed(spool):
    with open(os.path.join(spool, "broken.job.json"), "w") as f:
        json.dump({"image": "missing.png", "transcript": "deus"}, f)
    stats = serve(spool, model=None, backend="hybrid", once=True)
    # a failed job must NOT count as processed (outcome accounting)
    assert (stats.processed, stats.failed) == (0, 1)
    assert stats.attempted == 1
    assert os.path.isfile(os.path.join(spool, "broken.job.failed"))
    with open(os.path.join(spool, "broken.job.failed")) as f:
        assert "Traceback" in f.read()


def test_serve_requeues_stale_orphan_claim(spool):
    _make_job(spool, "folio_c", 520)
    # simulate a crashed worker: claim exists, no worker alive, old mtime
    src = os.path.join(spool, "folio_c.job.json")
    orphan = os.path.join(spool, "folio_c.job.running")
    os.rename(src, orphan)
    old = 4000
    os.utime(orphan, (os.path.getmtime(orphan) - old,) * 2)
    stats = serve(spool, model=None, backend="hybrid", once=True,
                  stale_after_s=900)
    assert (stats.processed, stats.failed) == (1, 0)
    assert os.path.isfile(os.path.join(spool, "folio_c.job.done"))


def test_serve_leaves_fresh_claim_alone(spool):
    _make_job(spool, "folio_d", 530)
    os.rename(os.path.join(spool, "folio_d.job.json"),
              os.path.join(spool, "folio_d.job.running"))
    stats = serve(spool, model=None, backend="hybrid", once=True,
                  stale_after_s=900)
    assert stats.attempted == 0  # fresh claim = another worker's; not stolen
    assert os.path.isfile(os.path.join(spool, "folio_d.job.running"))


def test_serve_failed_receipt_is_requeueable(spool):
    with open(os.path.join(spool, "broken2.job.json"), "w") as f:
        json.dump({"image": "missing.png", "transcript": "deus"}, f)
    serve(spool, model=None, backend="hybrid", once=True)
    with open(os.path.join(spool, "broken2.job.failed")) as f:
        receipt = json.load(f)
    assert receipt["job"]["image"] == "missing.png"
    assert "Traceback" in receipt["traceback"]
    # requeue by restoring the job spec
    with open(os.path.join(spool, "broken2.job.json"), "w") as f:
        json.dump(receipt["job"], f)
    stats = serve(spool, model=None, backend="hybrid", once=True)
    assert stats.failed == 1  # picked up again (fails again, but WAS requeued)


def test_serve_mixed_spool_counts_outcomes_separately(spool):
    _make_job(spool, "folio_ok", 540)
    with open(os.path.join(spool, "folio_bad.job.json"), "w") as f:
        json.dump({"image": "missing.png", "transcript": "deus"}, f)
    stats = serve(spool, model=None, backend="hybrid", once=True, max_jobs=2)
    assert (stats.processed, stats.failed) == (1, 1)
    assert stats.attempted == 2  # a failed job still consumed a job slot


def test_serve_reclaim_lost_race_does_not_crash(spool, monkeypatch):
    """Two concurrently-starting workers may both try to requeue the same
    stale claim; the loser's os.rename raises FileNotFoundError and must be
    survived (ADVICE r2: unguarded reclaim rename)."""
    _make_job(spool, "folio_e", 550)
    orphan = os.path.join(spool, "folio_e.job.running")
    os.rename(os.path.join(spool, "folio_e.job.json"), orphan)
    os.utime(orphan, (os.path.getmtime(orphan) - 4000,) * 2)

    real_rename = os.rename

    def racing_rename(src, dst):
        if src == orphan:
            # simulate the other worker winning the requeue race: it already
            # moved the claim back to .job.json
            real_rename(src, dst)
            raise FileNotFoundError(src)
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", racing_rename)
    stats = serve(spool, model=None, backend="hybrid", once=True,
                  stale_after_s=900)
    # the reclaim "failed" for this worker but the job was requeued by the
    # "other" worker; this worker then claims and processes it normally
    assert (stats.processed, stats.failed) == (1, 0)
    names = os.listdir(spool)
    assert not any(n.endswith(".job.running") for n in names)


def test_serve_batched_drain_matches_singleton(spool, tmp_path):
    """--batch N must produce byte-identical outputs and the same receipts
    as one-at-a-time serving."""
    for i in range(3):
        _make_job(spool, f"folio_{i}", 600 + 10 * i)
    # reference: singleton drain into a copy of the spool
    import shutil

    spool2 = str(tmp_path / "spool2")
    shutil.copytree(spool, spool2)

    stats_b = serve(spool, model=None, backend="hybrid", once=True, batch=8)
    stats_s = serve(spool2, model=None, backend="hybrid", once=True)
    assert (stats_b.processed, stats_b.failed) == (3, 0)
    assert (stats_s.processed, stats_s.failed) == (3, 0)
    for i in range(3):
        with open(os.path.join(spool, f"folio_{i}.json")) as f:
            got = json.load(f)
        with open(os.path.join(spool2, f"folio_{i}.json")) as f:
            want = json.load(f)
        assert got == want
        assert os.path.exists(os.path.join(spool, f"folio_{i}.job.done"))


def test_serve_batched_isolates_bad_job(spool):
    """A job with an unreadable image fails alone; batchmates succeed."""
    _make_job(spool, "good_a", 700)
    _make_job(spool, "good_b", 710)
    with open(os.path.join(spool, "broken.job.json"), "w") as f:
        json.dump({"image": "missing.png", "transcript": "deus"}, f)

    stats = serve(spool, model=None, backend="hybrid", once=True, batch=8)
    assert (stats.processed, stats.failed) == (2, 1)
    names = sorted(os.listdir(spool))
    assert "broken.job.failed" in names
    assert "good_a.job.done" in names and "good_b.job.done" in names
    with open(os.path.join(spool, "broken.job.failed")) as f:
        receipt = json.load(f)
    assert receipt["job"]["image"] == "missing.png"  # requeueable spec


def test_serve_batched_isolates_malformed_scoring(spool):
    """A job whose seq_align_params is not a valid scoring list (here a
    bare int, which tuple() rejects) fails alone in --batch mode instead
    of crashing the sweep at group-key construction and stranding every
    claimed job as .job.running."""
    _make_job(spool, "good_c", 720)
    _make_job(spool, "bad_scoring", 730, seq_align_params=5)

    stats = serve(spool, model=None, backend="hybrid", once=True, batch=8)
    assert (stats.processed, stats.failed) == (1, 1)
    names = sorted(os.listdir(spool))
    assert "good_c.job.done" in names
    assert "bad_scoring.job.failed" in names
    assert not any(x.endswith(".job.running") for x in names)


def test_serve_batched_respects_max_jobs(spool):
    for i in range(4):
        _make_job(spool, f"folio_{i}", 800 + 10 * i)
    stats = serve(spool, model=None, backend="hybrid", once=True, batch=8,
                  max_jobs=2)
    assert stats.attempted == 2
    # unclaimed jobs stay pending (no stranded .running claims)
    names = sorted(os.listdir(spool))
    assert sum(n.endswith(".job.json") for n in names) == 2
    assert not any(n.endswith(".job.running") for n in names)


def test_serve_max_jobs_zero_returns_immediately(spool):
    _make_job(spool, "folio_z", 900)
    stats = serve(spool, model=None, backend="hybrid", once=True,
                  max_jobs=0)
    assert stats.attempted == 0
    assert any(n.endswith(".job.json") for n in os.listdir(spool))


def test_serve_batched_empty_pickle_matches_singleton(spool, tmp_path):
    """An existing_ocr_pickle that unpickles to [] must fail (or succeed)
    the same way in --batch and singleton modes — here, with no model,
    both fail with the no-OCR-source error."""
    import pickle as pk
    import shutil

    _make_job(spool, "folio_ok", 910)
    with open(os.path.join(spool, "empty.pickle"), "wb") as f:
        pk.dump([], f)
    with open(os.path.join(spool, "empty.job.json"), "w") as f:
        json.dump({"image": "folio_ok.png", "transcript": "deus",
                   "existing_ocr_pickle": "empty.pickle"}, f)
    spool2 = str(tmp_path / "spool2")
    shutil.copytree(spool, spool2)

    stats_b = serve(spool, model=None, backend="hybrid", once=True, batch=8)
    stats_s = serve(spool2, model=None, backend="hybrid", once=True)
    assert (stats_b.processed, stats_b.failed) == (1, 1)
    assert (stats_s.processed, stats_s.failed) == (1, 1)
    for d in (spool, spool2):
        with open(os.path.join(d, "empty.job.failed")) as f:
            receipt = json.load(f)
        assert "no OCR source" in receipt["traceback"]


def test_serve_batched_mixed_ocr_and_model_jobs(spool, tmp_path):
    """One sweep holding both an OCR-injected job and a model-OCR job:
    the groups run through separate process_batch calls; both complete,
    and each mode's output matches its singleton-serve counterpart."""
    import shutil

    from text_alignment_tpu_torch.models.codec import Codec
    from text_alignment_tpu_torch.models.lstm import init_params_np
    from text_alignment_tpu_torch.models.pyrnn import save_pyrnn

    _make_job(spool, "with_ocr", 920)
    page = _make_job(spool, "with_model", 930)
    # strip the pickle key so this job needs the model
    jp = os.path.join(spool, "with_model.job.json")
    with open(jp) as f:
        job = json.load(f)
    del job["existing_ocr_pickle"]
    with open(jp, "w") as f:
        json.dump(job, f)

    codec = Codec()
    d = init_params_np(np.random.default_rng(3), 48, 20, len(codec))
    model = str(tmp_path / "m-00000100.pyrnn.gz")
    save_pyrnn(model, d, codec, 48)

    spool2 = str(tmp_path / "spool2")
    shutil.copytree(spool, spool2)

    stats_b = serve(spool, model=model, backend="hybrid", once=True, batch=8)
    stats_s = serve(spool2, model=model, backend="hybrid", once=True)
    assert (stats_b.processed, stats_b.failed) == (2, 0)
    assert (stats_s.processed, stats_s.failed) == (2, 0)
    for name in ("with_ocr", "with_model"):
        with open(os.path.join(spool, name + ".json")) as f:
            got = json.load(f)
        with open(os.path.join(spool2, name + ".json")) as f:
            want = json.load(f)
        assert got == want, name


def test_serve_batched_groups_custom_scoring(spool, tmp_path):
    """Jobs with a seq_align_params override run in their own group and
    still match their singleton-serve outputs."""
    import shutil

    _make_job(spool, "default_sc", 940)
    _make_job(spool, "custom_sc", 950,
              seq_align_params=[5, -4, -2, -2, 0, 0])
    spool2 = str(tmp_path / "spool2")
    shutil.copytree(spool, spool2)

    stats_b = serve(spool, model=None, backend="hybrid", once=True, batch=8)
    stats_s = serve(spool2, model=None, backend="hybrid", once=True)
    assert (stats_b.processed, stats_b.failed) == (2, 0)
    assert (stats_s.processed, stats_s.failed) == (2, 0)
    for name in ("default_sc", "custom_sc"):
        with open(os.path.join(spool, name + ".json")) as f:
            got = json.load(f)
        with open(os.path.join(spool2, name + ".json")) as f:
            want = json.load(f)
        assert got == want, name


@pytest.mark.parametrize("batch", [1, 8])
def test_serve_matches_the_jax_package(spool, tmp_path, batch):
    """The JAX package's serve and the port's on copies of one spool, OCR
    injected by pickles: the same receipts and byte-identical output
    JSON."""
    import shutil

    from text_alignment_tpu.serve import serve as jax_serve

    for i in range(3):
        _make_job(spool, f"folio_{i}", 960 + 10 * i)
    _make_job(spool, "custom", 990, seq_align_params=[5, -4, -2, -2, 0, 0],
              output="out/custom.json")
    spool_j = str(tmp_path / "spool_jax")
    shutil.copytree(spool, spool_j)
    stats = serve(spool, model=None, backend="hybrid", once=True,
                  batch=batch)
    stats_j = jax_serve(spool_j, model=None, backend="hybrid", once=True,
                        batch=batch)
    assert (stats.processed, stats.failed) == (4, 0)
    assert (stats_j.processed, stats_j.failed) == (4, 0)
    for name in ("folio_0.json", "folio_1.json", "folio_2.json",
                 "out/custom.json"):
        with open(os.path.join(spool, name), "rb") as f:
            got = f.read()
        with open(os.path.join(spool_j, name), "rb") as f:
            want = f.read()
        assert got == want, name
    assert sorted(os.listdir(spool)) == sorted(os.listdir(spool_j))
