"""``chip_smoke.pack_check``, the card run's guard against F4 (ROADMAP §3:
a pool's pack whose bytes part from an in-process pack of the same task,
so that its v2 and v3 operands may disagree), on the CPU with the
kernels' plain versions: a pool result whose formats agree passes
untouched; one with a flipped plane bit is named and packed again
in-process, equal to a clean pack; formats that still disagree after the
repack fail the run."""
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TASKS = [("a", 1, (256, 384), 0.05, ("v2", "v3")),
         ("b", 2, (384, 256), 0.05, "all")]


@pytest.fixture(autouse=True)
def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def _packs():
    return dict(cs.pack_task(t) for t in TASKS)


def test_agreeing_formats_pass_untouched(capsys):
    got = _packs()
    before = {k: dict(v) for k, v in got.items()}
    cs.pack_check(torch.device("cpu"), got, TASKS, "demo", 0)
    assert all(got[k][op] is before[k][op] for k in got for op in got[k])
    assert "but for" not in capsys.readouterr().out


def test_parted_planes_are_named_and_packed_again(capsys):
    got = _packs()
    clean = got["a"]["sme_v3_planes"].copy()
    bad = clean.copy()
    bad.reshape(-1)[np.flatnonzero(bad.reshape(-1))[0]] ^= 1
    got["a"]["sme_v3_planes"] = bad
    cs.pack_check(torch.device("cpu"), got, TASKS, "demo", 3)
    assert np.array_equal(got["a"]["sme_v3_planes"], clean)
    out = capsys.readouterr().out
    assert "but for ['a']" in out and "(F4)" in out


def test_formats_that_part_again_fail(monkeypatch):
    got = _packs()
    got["a"]["sme_v3_planes"] = got["a"]["sme_v3_planes"] ^ np.uint8(1)
    parted = dict(got["a"])
    monkeypatch.setattr(cs, "pack_task", lambda task: (task[0], parted))
    with pytest.raises(AssertionError, match="disagree again"):
        cs.pack_check(torch.device("cpu"), got, TASKS, "demo", 0)

