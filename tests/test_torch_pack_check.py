"""``chip_smoke.pack_check``, the card run's guard against F4 (ROADMAP §3:
a pool's pack whose bytes part from an in-process pack of the same task,
so that its v2 and v3 operands may disagree), on the CPU with the
kernels' plain versions: a pool result whose formats agree passes
untouched; one with a flipped plane bit is named and packed again
in-process, equal to a clean pack; formats that still disagree after the
repack fail the run.

And F4's repair, the pool paused without signals (``chip_smoke.Packer``):
while ``quiet()`` is held no worker is inside a unit of packing work (the
pool's busy count, read here, stays 0), every weight the pool packs in
units equals ``pack_task`` in this process byte for byte, the units of a
weight joined are one compression of the whole weight, and the script
sends no signal to its pool."""
import pathlib
import sys
import time

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



#: (task, its units) with the unit size patched down to 256 x 256
#: weights: a ragged 7.8-tile weight under "all" in 8 units of a tile (the
#: last 104 columns wide), a head (each unit clipped to its max |w|) in 4
#: of two tiles and an even weight in 6 of a tile under v2 and v3, one
#: whole 1-tile weight
UNIT_TASKS = [(("w", 3, (384, 1000), 0.05, "all"), 8),
              (("head/0", 4, (256, 1024), cs.HEAD_STD, ("v2", "v3")), 4),
              (("x", 5, (512, 768), 0.04, ("v2", "v3")), 6),
              (("y", 6, (256, 128), 0.06, "all"), 1)]
TASKS_OF_UNITS = [t for t, _ in UNIT_TASKS]


def _equal(a, b):
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.fixture(name="small_units")
def _small_units(monkeypatch):
    monkeypatch.setattr(cs, "UNIT_WEIGHTS", 256 * 256)


@pytest.mark.parametrize("task,n_units", UNIT_TASKS,
                         ids=[t[0] for t, _ in UNIT_TASKS])
def test_units_joined_are_one_compression(small_units, task, n_units):
    """A weight's units, each drawn alone, packed alone and joined
    (``pack_task``), are byte for byte one compression of the whole
    weight they make up."""
    from repro_torch.core.integrate import convert_params_to_sme
    us = cs.units(task)
    assert len(us) == n_units
    w = np.concatenate([cs.unit_values(u) for u in us], axis=1)
    assert w.shape == task[2]
    whole = convert_params_to_sme({"w": w}, backend=task[4], device="cpu")
    assert _equal(cs.pack_task(task)[1],
                  {k: t.numpy() for k, t in whole["w"].items()})


def test_pool_paused_without_signals_packs_equal(small_units, capsys):
    """``quiet()`` entered 25 times while the pool packs 79 units (a
    60-unit weight with the others), from the moment a worker is busy:
    the busy count reads 0 throughout every pause, the pool still packs
    after the first, and each weight it packs equals ``pack_task`` in
    this process."""
    tasks = TASKS_OF_UNITS + [("z", 7, (512, 128 * 60), 0.04, "all")]
    packer = cs.Packer({"m": tasks})
    try:
        t_end = time.perf_counter() + 120
        while not packer.busy.value and time.perf_counter() < t_end:
            time.sleep(0.001)
        first = time.perf_counter() - packer.t0
        seen = []
        for _ in range(25):
            with cs.quiet():
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < 0.02:
                    seen.append(packer.busy.value)
            time.sleep(0.05)
        assert packer.pauses == 25 and set(seen) == {0}
        got, _, _ = packer.wait("m")
        assert packer.busy.value == 0          # no count lost or left
    finally:
        packer.close()
    assert packer.done_s["m"] > first
    assert cs.quiet is not packer.paused
    for task in tasks:
        assert _equal(got[task[0]], cs.pack_task(task)[1]), task[0]
    out = capsys.readouterr().out
    assert "5 weights from 79 units" in out
    assert "(25 pauses, no signal sent to it)" in out


def test_pause_is_reentrant(small_units):
    """A block of readings holds one pause: a ``quiet()`` inside another
    neither resumes the pool at its end nor counts again."""
    packer = cs.Packer({"m": TASKS_OF_UNITS[3:]})
    try:
        with cs.quiet():
            with cs.quiet():
                pass
            assert not packer.gate.is_set() and packer.busy.value == 0
        assert packer.gate.is_set() and packer.pauses == 1
        packer.wait("m")
    finally:
        packer.close()


def test_script_sends_its_pool_no_signal():
    """``chip_smoke.py`` stops no process: no ``os.kill``, no SIGSTOP or
    SIGCONT (the cause of F4's corrupted packs on the card host)."""
    text = (ROOT / "chip_smoke.py").read_text()
    for word in ("os.kill", "SIGSTOP", "SIGCONT", "import signal"):
        assert word not in text, word
