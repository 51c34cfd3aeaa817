"""Command-line tools of the port: ``python -m pathway_tpu_torch.cli``.

A copy of the ``scrub`` command of ``pathway_tpu/cli.py``, on ``argparse``
instead of ``click`` (the card's machine has no ``click``), with the same
options, output and exit codes::

    python -m pathway_tpu_torch.cli scrub [--worker N] [--json] [--repair] ROOT

``spawn`` and ``replay`` launch worker processes through the multi-worker
runner, which the port brings in slice H4b; until then they raise
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import argparse
import os
import sys


def _echo(message: str, err: bool = False) -> None:
    print(message, file=sys.stderr if err else sys.stdout, flush=True)


def _scrub(worker: int | None, as_json: bool, repair: bool, root: str) -> int:
    """Audit a filesystem persistence ROOT offline.

    Verifies every retained checkpoint generation chunk-by-chunk
    (integrity frames + manifest digests) without mutating anything
    (unless --repair), and reports per-generation health.  Exits non-zero
    when any worker's NEWEST generation fails verification — recovery
    would silently fall back to an older generation, which deserves
    operator attention.
    """
    import json as _json

    from pathway_tpu_torch.engine.persistence import (
        FileBackend,
        repair_root,
        scrub_root,
    )

    backend = FileBackend(root)
    if repair:
        for action in repair_root(backend, worker=worker):
            _echo(f"[repair] {action}", err=True)
    report = scrub_root(backend, worker=worker)
    if as_json:
        _echo(_json.dumps(report, indent=2, sort_keys=True))
    else:
        _echo(f"scrub of {report['backend']}")
        if report.get("error"):
            _echo(f"  ERROR: {report['error']}")
        lease = report.get("lease")
        if lease is not None:
            if lease.get("ok"):
                beacons = lease.get("progress_workers") or []
                _echo(
                    f"  lease: incarnation {lease['incarnation']} "
                    f"(owner: {lease.get('owner')})"
                    + (f", topology {lease['workers']} worker(s)"
                       if isinstance(lease.get("workers"), int) else "")
                    + (f", progress beacons for workers {beacons}"
                       if beacons else "")
                )
            else:
                _echo(f"  lease: DAMAGED — {lease.get('error')}")
            for sid, beacon in sorted((lease.get("standbys") or {}).items()):
                cursors = beacon.get("cursors") or {}
                trail = ", ".join(
                    f"w{w}@g{g}"
                    for w, g in sorted(
                        cursors.items(), key=lambda item: int(item[0])
                    )
                )
                _echo(
                    f"  standby {sid}: apply lag {beacon.get('lag_s')}s, "
                    f"{beacon.get('verified_chunks')} chunk(s) verified"
                    + (f", cursors {trail}" if trail
                       else ", no generations applied yet")
                )
            promos = lease.get("promotions") or []
            if promos:
                _echo(f"  promotion history ({len(promos)}):")
                for p in promos:
                    _echo(
                        f"    standby {p.get('standby')} -> worker "
                        f"{p.get('worker')} in {p.get('duration_s')}s on "
                        f"attempt {p.get('attempt')} ({p.get('reason')})"
                    )
            promote = lease.get("promote")
            if promote and promote.get("pending_request"):
                _echo(
                    "  promotion IN FLIGHT (acks: "
                    f"{', '.join(promote.get('acks') or []) or 'none'})"
                )
        topo = report.get("topology")
        if topo is not None:
            history = topo.get("history") or []
            if len(history) > 1:
                trail = " -> ".join(
                    f"{h.get('workers')}@inc{h.get('incarnation')}"
                    for h in history
                )
                _echo(f"  rescale history: {trail}")
        bb = report.get("blackbox")
        if bb is not None:
            _echo(
                f"  blackbox: {bb['dumps']} flight-recorder dump(s) "
                f"for worker(s) {bb['workers']}"
                + (f", {len(bb['unreadable'])} unreadable"
                   if bb["unreadable"] else "")
            )
        if not report["workers"] and not report.get("error"):
            _echo("  no checkpoint state found")
        for wid, wrep in sorted(report["workers"].items()):
            status = "OK" if wrep["ok"] else "DAMAGED"
            if wrep.get("orphaned"):
                status = f"ORPHANED ({wrep.get('status', 'fenced, pending GC')})"
            elif wrep.get("pending_repartition"):
                status += " (old topology, pending repartition)"
            _echo(
                f"  worker {wid}: {status} — newest generation "
                f"{wrep['newest']}, newest verified {wrep['newest_verified']}"
                + (" (legacy pre-manifest metadata)"
                   if wrep["legacy_metadata"] else "")
            )
            pointer_error = (wrep.get("pointer") or {}).get("error")
            if pointer_error:
                _echo(f"    metadata pointer: {pointer_error}")
            for entry in wrep["generations"]:
                mark = "ok" if entry["ok"] else "CORRUPT"
                stamp = entry.get("incarnation")
                topo_stamp = entry.get("topology")
                notes = []
                if stamp:
                    notes.append(f"incarnation {stamp}")
                if topo_stamp:
                    notes.append(f"topology {topo_stamp}")
                if entry.get("repartitioned_from"):
                    notes.append(
                        f"repartitioned from {entry['repartitioned_from']}"
                    )
                _echo(
                    f"    generation {entry['generation']}: {mark}"
                    + (f" ({', '.join(notes)})" if notes else "")
                )
                for problem in entry["problems"]:
                    _echo(f"      - {problem}")
    _echo(
        f"[pathway_tpu_torch] scrub: {'clean' if report['ok'] else 'DAMAGE FOUND'}",
        err=True,
    )
    return 0 if report["ok"] else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m pathway_tpu_torch.cli")
    commands = parser.add_subparsers(dest="command", required=True)
    scrub = commands.add_parser(
        "scrub", help="audit a filesystem persistence ROOT offline",
        description=_scrub.__doc__,
    )
    scrub.add_argument(
        "--worker", metavar="N", type=int, default=None,
        help="audit only this worker's checkpoint shard",
    )
    scrub.add_argument(
        "--json", dest="as_json", action="store_true",
        help="emit the machine-readable report",
    )
    scrub.add_argument(
        "--repair", action="store_true",
        help="quarantine damaged generations above each worker's newest "
        "verified one (moved to quarantine/<worker>/, kept for forensics), "
        "then re-audit — the deliberate unblock for configurations that "
        "refuse to fall back silently",
    )
    scrub.add_argument("root")
    for name in ("spawn", "replay"):
        later = commands.add_parser(name, help="slice H4b")
        later.add_argument("rest", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if args.command in ("spawn", "replay"):
        raise NotImplementedError(
            f"`{args.command}` launches workers through the multi-worker "
            "runner, which the port brings in slice H4b"
        )
    if not os.path.isdir(args.root):
        parser.error(f"ROOT {args.root!r} is not a directory")
    return _scrub(args.worker, args.as_json, args.repair, args.root)


if __name__ == "__main__":
    sys.exit(main())
