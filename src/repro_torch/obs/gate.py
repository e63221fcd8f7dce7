"""CI gate over a metrics snapshot (DESIGN.md §9).

    python -m repro_torch.obs.gate serve_metrics.json [--require NAME ...]

Checked against ``repro/obs/gate.py`` (standard library only).  Fails (exit
1) when the snapshot written by ``repro_torch.launch.serve --metrics-out``
is missing a required metric family or reports a silently dead serving
run: zero decode steps or zero TTFT observations mean the instrumentation
(or the serve path behind it) stopped firing.  The port's engine emits the
reference's serve families; it does not emit the reference's per-dispatch
``sme_dispatch_total`` and ``sme_operand_cache_total`` (in eager torch they
would fire on every linear), so those are required only by ``--require``,
and the operand-cache liveness check runs where the snapshot carries that
family (a reference snapshot does).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from .metrics import SNAPSHOT_VERSION

#: metric families every serving snapshot of the port must contain
REQUIRED_FAMILIES = (
    "serve_requests_total",
    "serve_prefills_total",
    "serve_decode_steps_total",
    "serve_tokens_total",
    "serve_ttft_seconds",
    "serve_inter_token_seconds",
)


def _family_total(metrics: Dict, name: str, **match: str) -> float:
    """Sum over a family's children whose labels include ``match``
    (histograms contribute their observation counts)."""
    fam = metrics.get(name)
    if fam is None:
        return 0.0
    total = 0.0
    for v in fam.get("values", []):
        labels = v.get("labels", {})
        if all(labels.get(k) == str(val) for k, val in match.items()):
            total += v["count"] if fam.get("type") == "histogram" \
                else v["value"]
    return total


def check_snapshot(snap: Dict, require: List[str] = ()) -> List[str]:
    """Return the list of failures (empty = gate passes)."""
    fails: List[str] = []
    if snap.get("version") != SNAPSHOT_VERSION:
        fails.append(f"snapshot version {snap.get('version')!r} != "
                     f"{SNAPSHOT_VERSION}")
        return fails
    metrics = snap.get("metrics", {})
    for name in list(REQUIRED_FAMILIES) + list(require):
        if name not in metrics:
            fails.append(f"missing required metric family: {name}")
    if fails:
        return fails
    # liveness: a run that decoded nothing or observed no TTFT means dead
    # instrumentation
    if _family_total(metrics, "serve_decode_steps_total") <= 0:
        fails.append("serve_decode_steps_total is zero: no decode steps "
                     "were recorded")
    if _family_total(metrics, "serve_ttft_seconds") <= 0:
        fails.append("serve_ttft_seconds has zero observations: no "
                     "request reached its first token")
    if "sme_operand_cache_total" in metrics and sum(
            _family_total(metrics, "sme_operand_cache_total", event=e)
            for e in ("prepacked", "hit")) <= 0:
        fails.append("sme_operand_cache_total{event=prepacked|hit} is "
                     "zero: no dispatch served packed operands")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fail CI when a serve metrics snapshot is missing "
                    "required metrics or reports a dead run")
    ap.add_argument("snapshot", help="path to a --metrics-out JSON file")
    ap.add_argument("--require", action="append", default=[],
                    help="additional required metric family (repeatable)")
    args = ap.parse_args(argv)
    with open(args.snapshot) as f:
        snap = json.load(f)
    fails = check_snapshot(snap, args.require)
    if fails:
        for msg in fails:
            print(f"metrics gate FAIL: {msg}", file=sys.stderr)
        return 1
    m = snap["metrics"]
    print(f"metrics gate OK: {args.snapshot} ({len(m)} families; "
          f"decode_steps={_family_total(m, 'serve_decode_steps_total'):.0f}, "
          f"ttft_obs={_family_total(m, 'serve_ttft_seconds'):.0f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
