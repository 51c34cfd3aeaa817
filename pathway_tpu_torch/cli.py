"""Command-line tools of the port: ``python -m pathway_tpu_torch``.

A copy of the ``spawn``, ``replay``, ``spawn-from-env`` and ``scrub``
commands of ``pathway_tpu/cli.py``, on ``argparse`` instead of ``click``
(the card's machine has no ``click``), with the same options, output and
exit codes::

    python -m pathway_tpu_torch spawn [-n N] [--supervise] [--standbys K] \
        [--checkpoint-root ROOT] PROGRAM [ARGUMENTS...]
    python -m pathway_tpu_torch replay [--record-path PATH] PROGRAM [ARGUMENTS...]
    python -m pathway_tpu_torch spawn-from-env
    python -m pathway_tpu_torch scrub [--worker N] [--json] [--repair] ROOT

``spawn`` starts N identical processes of the user's program with
``PATHWAY_THREADS/PROCESSES/FIRST_PORT/PROCESS_ID/RUN_ID`` set (every
worker builds the same dataflow and owns a shard of the keys); with
``--supervise`` the supervisor (``engine/supervisor.py``) restarts the
group from the last committed checkpoint when a worker dies, or promotes
a warm standby.  ``--torch-distributed`` is the counterpart of the JAX
package's ``--jax-distributed``: the workers also join one
``torch.distributed`` world.  ``python -m pathway_tpu_torch.cli`` takes
the same commands.
"""

from __future__ import annotations

import argparse
import os
import secrets
import subprocess
import sys
import uuid
from typing import NoReturn


def _echo(message: str, err: bool = False) -> None:
    print(message, file=sys.stderr if err else sys.stdout, flush=True)


def _cluster_env(
    env_base: dict[str, str],
    *,
    threads: int,
    processes: int,
    first_port: int,
    process_id: int,
    run_id: str,
) -> dict[str, str]:
    env = dict(env_base)
    env.update(
        PATHWAY_THREADS=str(threads),
        PATHWAY_PROCESSES=str(processes),
        PATHWAY_FIRST_PORT=str(first_port),
        PATHWAY_PROCESS_ID=str(process_id),
        PATHWAY_RUN_ID=run_id,
    )
    return env


def spawn_program(
    *,
    threads: int,
    processes: int,
    first_port: int,
    program: str,
    arguments: tuple[str, ...],
    env_base: dict[str, str],
    supervise: bool = False,
    max_restarts: int = 3,
    checkpoint_root: str | None = None,
    shrink_on_loss: bool | None = None,
    autoscale: bool | None = None,
    standbys: int | None = None,
) -> NoReturn:
    """Launch ``processes`` copies of ``program`` forming one SPMD cluster.

    With ``supervise=True`` a crashed worker does not end the run: the
    supervisor (``engine/supervisor.py``) rolls the whole group back to
    the last committed persistence checkpoint and respawns it, up to
    ``max_restarts`` times — same run id, ports and comm secret, so the
    recovered cluster resumes exactly where the snapshots left off.

    With ``standbys=K`` (or ``PATHWAY_STANDBY_COUNT``) the supervisor
    also keeps K warm-standby processes tailing the checkpoint root
    (``engine/standby.py``); a worker death is then absorbed by
    promoting one — the survivors rejoin in place and never restart —
    with the whole-group restart above as the fallback tier.

    Elastic rescale: relaunching a supervised run with a DIFFERENT ``-n``
    on the same ``--checkpoint-root`` is supported — the supervisor
    records the new topology in the incarnation lease and the workers
    re-partition checkpointed state by shard range on resume.  With
    ``shrink_on_loss=True`` (or ``PATHWAY_DEGRADED_SHRINK=1``) the
    supervisor performs that rescale on its own when the same worker
    fails every attempt of a spent restart budget — a permanently lost
    host completes the run at the surviving count instead of failing it.
    """
    _echo(
        f"[pathway_tpu_torch] launching SPMD cluster: {processes} process(es), "
        f"ports {first_port}..{first_port + processes - 1}"
        + (f", supervised (max {max_restarts} restarts)" if supervise else ""),
        err=True,
    )
    run_id = str(uuid.uuid4())
    # every worker must hold the same mesh handshake secret
    # (engine/comm.py); honor a deployment-provided one, else mint one
    # for this run
    env_base = dict(env_base)
    env_base.setdefault("PATHWAY_COMM_SECRET", secrets.token_hex(16))
    # one trace per run: every worker inherits this traceparent, so its
    # epoch/commit/recovery spans correlate into a single trace in any
    # OTLP collector (worker 0 re-broadcasts it over the mesh for workers
    # launched outside spawn); restarts keep it — a recovery is part of
    # the same run's story
    from pathway_tpu_torch.engine.telemetry import mint_traceparent

    env_base.setdefault("TRACEPARENT", mint_traceparent())
    if autoscale:
        # the workers gate their load beacons + autoscaler panel wiring on
        # the same knob the supervisor's controller reads
        env_base["PATHWAY_AUTOSCALE"] = "1"

    if supervise:
        from pathway_tpu_torch.engine.supervisor import (
            ENV_ATTEMPT,
            ENV_INCARNATION,
            Supervisor,
            SupervisorError,
        )

        def spawn_one(
            process_id: int, attempt: int, n_workers: int = processes
        ) -> subprocess.Popen:
            # n_workers is the CURRENT cluster size (the supervisor passes
            # it explicitly so a degraded-mode shrink launches the smaller
            # topology with a matching PATHWAY_PROCESSES)
            env = _cluster_env(
                env_base,
                threads=threads,
                processes=n_workers,
                first_port=first_port,
                process_id=process_id,
                run_id=run_id,
            )
            env[ENV_ATTEMPT] = str(attempt)
            # the supervisor bumps the root's incarnation lease before
            # each attempt and exports it into ITS environ; copy it into
            # the worker env so persistence fencing and the mesh handshake
            # see the incarnation this attempt runs under
            from pathway_tpu_torch.internals.config import env_raw

            incarnation = env_raw(ENV_INCARNATION)
            if incarnation is not None:
                env[ENV_INCARNATION] = incarnation
            # exported by the supervisor around a STANDBY spawn (same
            # env-export trick as the incarnation): the process boots
            # into the tail loop instead of the worker path
            standby_id = env_raw("PATHWAY_STANDBY_ID")
            if standby_id is not None:
                env["PATHWAY_STANDBY_ID"] = standby_id
            return subprocess.Popen([program, *arguments], env=env)

        def echo_post_mortem(post_mortem: dict) -> None:
            for wid, info in sorted(post_mortem.get("workers", {}).items()):
                _echo(
                    f"[pathway_tpu_torch] worker {wid}: "
                    f"{len(info.get('dumps', []))} flight-recorder dump(s) "
                    f"(last reason: {(info.get('reasons') or [None])[-1]}) — "
                    f"JSON under {checkpoint_root}/blackbox/",
                    err=True,
                )

        try:
            result = Supervisor(
                spawn_one,
                processes,
                max_restarts=max_restarts,
                checkpoint_root=checkpoint_root,
                shrink_on_loss=shrink_on_loss,
                autoscale=autoscale,
                standbys=standbys,
            ).run()
        except SupervisorError as exc:
            _echo(f"[pathway_tpu_torch] {exc}", err=True)
            # the crash-loop black boxes are the post-mortem evidence —
            # point the operator at them before giving up
            echo_post_mortem(exc.post_mortem)
            sys.exit(1)
        if result.restarts:
            _echo(
                f"[pathway_tpu_torch] recovered after {result.restarts} restart(s) "
                f"(last failure: {result.last_failure})",
                err=True,
            )
        for promo in result.promotions:
            _echo(
                f"[pathway_tpu_torch] standby promotion: standby "
                f"{promo['standby']} adopted worker {promo['worker']} in "
                f"{promo.get('duration_s')}s on attempt "
                f"{promo.get('attempt')} ({promo.get('reason')}); the "
                "surviving workers rejoined in place without a restart",
                err=True,
            )
        for rescale in result.rescales:
            kind = rescale.get("kind")
            if kind == "autoscale":
                _echo(
                    f"[pathway_tpu_torch] autoscale ({rescale.get('action')}): "
                    f"cluster rescaled {rescale['from']} -> {rescale['to']} "
                    f"worker(s) via live shard handoff on attempt "
                    f"{rescale['attempt']} ({rescale.get('reason')}); "
                    f"{rescale.get('moving_shards')} shard(s) changed owner",
                    err=True,
                )
            elif kind == "autoscale-fallback":
                _echo(
                    f"[pathway_tpu_torch] autoscale fallback: live handoff "
                    f"{rescale['from']} -> {rescale['to']} worker(s) faulted "
                    f"on attempt {rescale['attempt']}; applied the target "
                    f"topology via restart-based rescale instead "
                    f"({rescale.get('reason')})",
                    err=True,
                )
            else:
                _echo(
                    f"[pathway_tpu_torch] degraded-mode shrink: worker "
                    f"{rescale['lost_worker']} treated as permanently lost on "
                    f"attempt {rescale['attempt']} — cluster rescaled "
                    f"{rescale['from']} -> {rescale['to']} worker(s); state "
                    "re-partitioned by shard range",
                    err=True,
                )
        # corruption fallback can happen WITHOUT any crash (root damaged at
        # rest before launch): report provenance whenever a worker rejected
        # generations, not only after restarts
        for wid, info in sorted(result.recovery.items()):
            rejected = [g for g, _ in info.get("rejected") or []]
            if not rejected and not result.restarts:
                continue
            _echo(
                f"[pathway_tpu_torch] worker {wid}: resumed from verified "
                f"generation {info.get('recovered_from')} "
                f"(now at {info.get('generation')})"
                + (f", rejected damaged generation(s) {rejected}"
                   if rejected else ""),
                err=True,
            )
        echo_post_mortem(result.post_mortem)
        sys.exit(0)

    handles: list[subprocess.Popen] = []
    try:
        # spawn inside the try: a mid-spawn failure (EAGAIN, missing
        # program) must still terminate the workers already started, or
        # they hang forever waiting for mesh peers
        for process_id in range(processes):
            handles.append(
                subprocess.Popen(
                    [program, *arguments],
                    env=_cluster_env(
                        env_base,
                        threads=threads,
                        processes=processes,
                        first_port=first_port,
                        process_id=process_id,
                        run_id=run_id,
                    ),
                )
            )
        for handle in handles:
            handle.wait()
    finally:
        for handle in handles:
            handle.terminate()
    codes = [handle.returncode for handle in handles]
    # a signal-killed worker (negative returncode) must not read as success;
    # report it with the conventional 128+signum shell encoding
    sys.exit(max(c if c >= 0 else 128 - c for c in codes))


def _recording_env(
    *,
    access: str | None = None,
    record_path: str | None = None,
    mode: str | None = None,
    continue_after_replay: bool = False,
) -> dict[str, str]:
    """Base environment for record/replay runs (PATHWAY_* protocol)."""
    env = os.environ.copy()
    if record_path is not None:
        env["PATHWAY_REPLAY_STORAGE"] = record_path
    if access is not None:
        env["PATHWAY_SNAPSHOT_ACCESS"] = access
    if mode is not None:
        env["PATHWAY_PERSISTENCE_MODE"] = mode
        env["PATHWAY_REPLAY_MODE"] = mode
    if continue_after_replay:
        env["PATHWAY_CONTINUE_AFTER_REPLAY"] = "true"
    return env


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


def _add_cluster_options(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-t", "--threads", metavar="N", type=int, default=1,
                        help="worker threads per spawned process")
    parser.add_argument("-n", "--processes", metavar="N", type=int, default=1,
                        help="cluster size (identical SPMD processes)")
    parser.add_argument("--first-port", metavar="PORT", type=int, default=10000,
                        help="base port of the worker TCP mesh")


def _add_program(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("program")
    parser.add_argument("arguments", nargs=argparse.REMAINDER)


def _spawn(args: argparse.Namespace) -> NoReturn:
    """Run PROGRAM as an SPMD cluster of identical processes.

    Re-running a supervised program with a different ``-n`` against the
    same ``--checkpoint-root`` performs an elastic rescale: resume
    re-partitions the committed snapshots by shard range under the new
    worker count.
    """
    env = (
        _recording_env(
            access="record", record_path=args.record_path,
            continue_after_replay=True,
        )
        if args.record
        else os.environ.copy()
    )
    if args.torch_distributed:
        env["PATHWAY_TORCH_DISTRIBUTED"] = "1"
    spawn_program(
        threads=args.threads,
        processes=args.processes,
        first_port=args.first_port,
        program=args.program,
        arguments=tuple(args.arguments),
        env_base=env,
        supervise=args.supervise,
        max_restarts=args.max_restarts,
        checkpoint_root=args.checkpoint_root,
        shrink_on_loss=args.shrink_on_loss,
        autoscale=args.autoscale,
        standbys=args.standbys,
    )


def _replay(args: argparse.Namespace) -> NoReturn:
    """Re-run PROGRAM against a previously captured input stream."""
    spawn_program(
        threads=args.threads,
        processes=args.processes,
        first_port=args.first_port,
        program=args.program,
        arguments=tuple(args.arguments),
        env_base=_recording_env(
            access="replay",
            record_path=args.record_path,
            mode=args.mode,
            continue_after_replay=args.continue_after_replay,
        ),
    )


def _spawn_from_env() -> int:
    """Re-exec ``spawn`` with arguments from PATHWAY_SPAWN_ARGS."""
    from pathway_tpu_torch.internals.config import env_str

    spawn_args = env_str("PATHWAY_SPAWN_ARGS")
    if spawn_args is None:
        _echo("PATHWAY_SPAWN_ARGS variable is unspecified, exiting...", err=True)
        return 0
    os.execl(
        sys.executable, sys.executable, "-m", "pathway_tpu_torch", "spawn",
        *spawn_args.split(),
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m pathway_tpu_torch")
    commands = parser.add_subparsers(dest="command", required=True)

    spawn = commands.add_parser(
        "spawn", help="run PROGRAM as an SPMD cluster of identical processes",
        description=_spawn.__doc__,
    )
    _add_cluster_options(spawn)
    spawn.add_argument("--record", action="store_true",
                       help="capture every connector's input stream while running")
    spawn.add_argument("--record-path", default="record",
                       help="where the captured stream is written")
    spawn.add_argument(
        "--torch-distributed", action="store_true",
        help="the workers also join one torch.distributed world "
        "(NCCL between cards, gloo on the CPU; the rendezvous is derived "
        "from the PATHWAY_* env)",
    )
    spawn.add_argument(
        "--supervise", action="store_true",
        help="restart the cluster from the last committed persistence "
        "checkpoint when a worker dies (engine/supervisor.py)",
    )
    spawn.add_argument("--max-restarts", metavar="N", type=int, default=3,
                       help="supervised mode: give up after N recoveries")
    spawn.add_argument(
        "--checkpoint-root", metavar="PATH", default=None,
        help="supervised mode: the program's filesystem persistence root, so "
        "recovery provenance (which verified generation each worker resumed "
        "from) is reported after the run",
    )
    spawn.add_argument(
        "--shrink-on-loss", action="store_true", default=None,
        help="supervised mode: when the SAME worker fails every attempt of a "
        "spent restart budget, rescale the cluster to the surviving count "
        "instead of failing (PATHWAY_DEGRADED_SHRINK=1 is the env form)",
    )
    spawn.add_argument(
        "--autoscale", action="store_true", default=None,
        help="supervised mode: arm the load-adaptive scale controller "
        "(PATHWAY_AUTOSCALE_* knobs; requires --checkpoint-root); its load "
        "reading comes from the freshness tracker of slice H5, and reads "
        "calm until then",
    )
    spawn.add_argument(
        "--standbys", metavar="K", type=int, default=None,
        help="supervised mode: keep K warm-standby processes tailing the "
        "checkpoint root (engine/standby.py) so a worker death is absorbed "
        "by promoting one (PATHWAY_STANDBY_COUNT is the env form; requires "
        "--checkpoint-root)",
    )
    _add_program(spawn)

    replay = commands.add_parser(
        "replay", help="re-run PROGRAM against a captured input stream",
        description=_replay.__doc__,
    )
    _add_cluster_options(replay)
    replay.add_argument("--record-path", default="record",
                        help="where the captured stream was written")
    replay.add_argument("--mode", type=str.lower, choices=["batch", "speedrun"],
                        default=None,
                        help="replay pacing: one batch, or recorded timing")
    replay.add_argument(
        "--continue", dest="continue_after_replay", action="store_true",
        help="after the recording drains, keep consuming live connector data",
    )
    _add_program(replay)

    commands.add_parser(
        "spawn-from-env", help="re-exec spawn with PATHWAY_SPAWN_ARGS",
        description=_spawn_from_env.__doc__,
    )

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
    args = parser.parse_args(argv)
    if args.command == "spawn":
        _spawn(args)
    if args.command == "replay":
        _replay(args)
    if args.command == "spawn-from-env":
        return _spawn_from_env()
    if not os.path.isdir(args.root):
        parser.error(f"ROOT {args.root!r} is not a directory")
    return _scrub(args.worker, args.as_json, args.repair, args.root)


if __name__ == "__main__":
    sys.exit(main())
