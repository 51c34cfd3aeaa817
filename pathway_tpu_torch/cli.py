"""Command-line tools of the port: ``python -m pathway_tpu_torch``.

A copy of the ``spawn``, ``replay``, ``spawn-from-env``, ``scrub``,
``blackbox``, ``profile``, ``top``, ``requests``, ``trace`` and
``buckets`` commands of ``pathway_tpu/cli.py``, on ``argparse`` instead of
``click`` (the card's machine has no ``click``), with the same options,
output and exit codes::

    python -m pathway_tpu_torch spawn [-n N] [--supervise] [--standbys K] \
        [--checkpoint-root ROOT] PROGRAM [ARGUMENTS...]
    python -m pathway_tpu_torch replay [--record-path PATH] PROGRAM [ARGUMENTS...]
    python -m pathway_tpu_torch spawn-from-env
    python -m pathway_tpu_torch scrub [--worker N] [--json] [--repair] ROOT
    python -m pathway_tpu_torch blackbox [--worker N] [--tail N] [--json] ROOT
    python -m pathway_tpu_torch profile [--top N] [--json] SOURCE
    python -m pathway_tpu_torch top [--url URL | --port P] [--once] [--json]
    python -m pathway_tpu_torch requests [DUMP] [--url URL | --port P] [-n N]
    python -m pathway_tpu_torch trace [--url URL | --port P] [--seconds S]
    python -m pathway_tpu_torch buckets [--url URL | --port P] [ROOT]

The observability commands print ``[pathway_tpu_torch]`` where the JAX
package prints ``[pathway_tpu]``; ``trace`` names the Chrome trace file
that ``torch.profiler`` writes instead of a TensorBoard directory.

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


# ---------------------------------------------------------------------------
# Observability commands: blackbox, profile, top, requests, trace, buckets
# ---------------------------------------------------------------------------


def _blackbox(worker: int | None, tail: int, as_json: bool, root: str) -> int:
    """Pretty-print crash flight-recorder dumps under a persistence ROOT.

    Workers dump their bounded event ring (epoch transitions, commit
    publishes, comm reconnects, injected faults) to ``<ROOT>/blackbox/``
    when they crash or a fault fires; the supervisor summarizes them on
    ``SupervisorResult.post_mortem``.  This command renders the full
    dumps for post-mortem analysis.  Exits non-zero when no dump exists.
    """
    import datetime
    import json as _json

    from pathway_tpu_torch.engine.flight_recorder import gather_dumps

    dumps = gather_dumps(root)
    if worker is not None:
        dumps = {w: d for w, d in dumps.items() if w == worker}
    if not dumps:
        # missing or empty blackbox/: a clear non-zero exit, whatever the
        # output mode — an operator piping --json must still see why
        _echo(
            f"[pathway_tpu_torch] no flight-recorder dumps under {root}/blackbox "
            "— nothing crashed there, or this is not a persistence root",
            err=True,
        )
        if as_json:
            _echo(_json.dumps({}))
        return 1
    if as_json:
        _echo(_json.dumps(dumps, indent=2, sort_keys=True))
        return 0

    def when(ts):
        # a parseable-but-partial dump (hand-edited, older format) must
        # render, not traceback
        if not isinstance(ts, (int, float)):
            return "--:--:--.---"
        return datetime.datetime.fromtimestamp(ts).strftime("%H:%M:%S.%f")[:-3]

    for wid, payloads in sorted(dumps.items()):
        for payload in payloads:
            events = payload.get("events") or []
            _echo(
                f"worker {wid} · attempt {payload.get('attempt')} · "
                f"pid {payload.get('pid')} · run {payload.get('run_id')}"
            )
            _echo(f"  reason: {payload.get('reason')}")
            if payload.get("trace_parent"):
                _echo(f"  trace:  {payload['trace_parent']}")
            _echo(f"  events: {len(events)} recorded, last {min(tail, len(events))}:")
            for ev in events[-tail:]:
                detail = ", ".join(
                    f"{k}={v}" for k, v in ev.items() if k not in ("ts", "mono", "seq", "kind")
                )
                _echo(
                    f"    {when(ev.get('ts'))}  #{str(ev.get('seq', '?')):>5}  "
                    f"{str(ev.get('kind', '?')):<22}{detail}"
                )
            profile = payload.get("profiler")
            if profile:
                # where the time went: the final profiler snapshot
                from pathway_tpu_torch.engine.profiler import render_snapshot

                for line in render_snapshot(profile).splitlines():
                    _echo(f"  {line}")
            freshness = payload.get("freshness")
            if freshness:
                # what was STUCK: the final watermark/backlog snapshot
                from pathway_tpu_torch.engine.freshness import render_freshness

                for line in render_freshness(freshness).splitlines():
                    _echo(f"  {line}")
            device = payload.get("device")
            if device:
                # what the DEVICE was doing: the final executor snapshot
                from pathway_tpu_torch.device import render_device_snapshot

                for line in _render_device_section(device, render_device_snapshot).splitlines():
                    _echo(f"  {line}")
            else:
                _echo("  device: (no snapshot in this dump)")
            autoscaler = payload.get("autoscaler")
            if autoscaler:
                # what the scale controller was deciding, with the tail of
                # the decision log
                _echo(
                    "  autoscaler: target "
                    f"{autoscaler.get('target_workers')} worker(s) · "
                    f"budget left {autoscaler.get('budget_left')} · "
                    f"handoff state "
                    f"{autoscaler.get('handoff_state') or 'idle'}"
                )
                for entry in (autoscaler.get("decisions") or [])[-5:]:
                    _echo(
                        f"    {entry.get('action', '?'):<18}"
                        + ", ".join(
                            f"{k}={v}" for k, v in entry.items() if k not in ("action", "at")
                        )
                    )
            serving = payload.get("serving")
            if serving:
                # what the SERVING edge was refusing, with the quarantine tail
                limits = serving.get("limits") or {}
                flags = [
                    flag
                    for flag, on in (
                        ("degraded", serving.get("degraded")),
                        ("draining", serving.get("draining")),
                        ("admission off", not serving.get("enabled", True)),
                    )
                    if on
                ]
                _echo(
                    f"  serving: {serving.get('inflight')}"
                    f"/{limits.get('inflight')} in flight · queue "
                    f"{serving.get('queue_depth')}/{limits.get('queue')}"
                    + (" · " + ", ".join(flags) if flags else "")
                )
                if serving.get("quarantined_total"):
                    _echo(f"    quarantined {serving['quarantined_total']} request(s), last:")
                    for entry in serving.get("quarantine") or []:
                        _echo(f"      key={entry.get('key')} {entry.get('error')}")
    return 0


def _render_device_section(device: dict, render) -> str:
    """A dump's ``device`` section: the JAX package's is one executor
    snapshot; the port's (``device.default_executor_snapshot``) is one per
    device, keyed by the device's name, and renders each under its name."""
    if "cost" in device or "queue" in device:
        return render(device)
    return "\n".join(
        f"{name}:\n" + "\n".join(f"  {line}" for line in render(snap).splitlines())
        for name, snap in device.items()
    )


def _profile(top: int | None, as_json: bool, source: str) -> int:
    """Render a per-operator attribution tree from profiler output.

    SOURCE is either a profiler snapshot JSON (written at run end when
    ``PATHWAY_PROFILE=1`` and ``PATHWAY_PROFILE_OUTPUT=<path>`` are set)
    or a filesystem persistence root, whose flight-recorder dumps under
    ``blackbox/`` carry final profiler snapshots.  Exits non-zero when
    SOURCE holds no profile.
    """
    import json as _json

    from pathway_tpu_torch.engine.profiler import render_snapshot
    from pathway_tpu_torch.internals.config import env_int

    top = top or env_int("PATHWAY_PROFILE_TOP")
    # (label, profiler snapshot, device snapshot or None), positionally
    # paired: one worker/attempt can leave several dumps whose labels
    # collide.  ABSENT marks a bare PATHWAY_PROFILE_OUTPUT snapshot with
    # no dump context, None a dump without a device section
    ABSENT = object()
    snapshots: list[tuple[str, dict, object]] = []
    if os.path.isdir(source):
        from pathway_tpu_torch.engine.flight_recorder import gather_dumps

        for wid, payloads in sorted(gather_dumps(source).items()):
            for payload in payloads:
                label = f"worker {wid} · attempt {payload.get('attempt')}"
                prof = payload.get("profiler")
                if prof:
                    snapshots.append((label, prof, payload.get("device")))
    else:
        try:
            with open(source, encoding="utf-8") as f:
                payload = _json.load(f)
        except (OSError, ValueError) as exc:
            _echo(f"[pathway_tpu_torch] unreadable snapshot: {exc}", err=True)
            return 2
        prof = payload.get("profiler", payload) if isinstance(payload, dict) else None
        if isinstance(prof, dict) and "operators" in prof:
            device = (
                payload.get("device")
                if isinstance(payload, dict) and "profiler" in payload
                else ABSENT
            )
            snapshots.append((source, prof, device))
    if not snapshots:
        _echo(
            f"[pathway_tpu_torch] no profiler snapshot in {source} — run with "
            "PATHWAY_PROFILE=1 (and PATHWAY_PROFILE_OUTPUT=<path>, or read "
            "a persistence root with flight-recorder dumps)",
            err=True,
        )
        return 1
    if as_json:
        entries = []
        for label, snap, device in snapshots:
            entry: dict = {"label": label, "snapshot": snap}
            if device is not ABSENT:
                entry["device"] = device
            entries.append(entry)
        _echo(_json.dumps(entries, indent=2, sort_keys=True))
        return 0
    for label, snap, device in snapshots:
        if len(snapshots) > 1:
            _echo(label)
        _echo(render_snapshot(snap, top=top))
        if device is ABSENT:
            continue
        if device:
            from pathway_tpu_torch.device import render_device_snapshot

            _echo(_render_device_section(device, render_device_snapshot))
        else:
            _echo("device: (no snapshot in this dump)")
    return 0


def _monitoring_url(url: str | None, port: int | None, process_id: int, endpoint: str) -> str:
    """Resolve a monitoring-server URL the way ``top`` does: explicit
    ``--url`` wins, else ``--port``/``PATHWAY_MONITORING_HTTP_PORT``/the
    20000 + process-id default, with ``endpoint`` as the path."""
    if url is not None:
        return url
    from pathway_tpu_torch.engine.http_server import monitoring_port
    from pathway_tpu_torch.internals.config import env_int

    if port is None:
        port = env_int("PATHWAY_MONITORING_HTTP_PORT")
    return f"http://127.0.0.1:{monitoring_port(process_id, port)}/{endpoint}"


def _top(url, port, process_id, interval, once: bool, as_json: bool) -> int:
    """Live per-operator backlog + freshness view of a running pipeline.

    Polls ``GET /status`` on the monitoring HTTP server (enable it with
    ``pw.run(with_http_server=True)`` or ``PATHWAY_MONITORING_HTTP_PORT``)
    and renders epoch rate, per-output staleness and end-to-end latency
    quantiles (``freshness.*``), the ranked ``backlog.*`` wait points, the
    device panel and the per-operator progress table.  Exits non-zero
    with a clear message when the endpoint is unreachable.
    """
    import json as _json
    import time as _time_mod

    from pathway_tpu_torch.internals.config import env_float
    from pathway_tpu_torch.internals.top import StatusUnavailable, fetch_status, render_top

    url = _monitoring_url(url, port, process_id, "status")
    if interval is None:
        interval = env_float("PATHWAY_STATUS_REFRESH_S")
    # 0.1 s is the floor, so a typo cannot hot-spin the server
    interval = max(0.1, float(interval))
    prev = None
    prev_t = None
    while True:
        try:
            status = fetch_status(url)
        except StatusUnavailable as exc:
            _echo(f"[pathway_tpu_torch] {exc}", err=True)
            return 1
        now = _time_mod.monotonic()
        if as_json:
            _echo(_json.dumps(status, indent=2, sort_keys=True))
        else:
            if not once and sys.stdout.isatty():
                print("\033[2J\033[H", end="")  # clear the screen
            # epoch rate derives from the measured time between polls
            _echo(render_top(status, prev, interval_s=(now - prev_t) if prev_t else None))
        if once:
            return 0
        prev, prev_t = status, now
        _time_mod.sleep(interval)


def _requests(dump, url, port, process_id, limit: int, recent: bool, as_json: bool) -> int:
    """Slowest-request waterfalls from the live span buffer or a dump.

    Reads the finished-request trace ring (``engine/tracing.py``) either
    from a running pipeline's ``GET /status`` ``requests`` section or —
    with a DUMP argument — from a flight-recorder dump file's
    ``requests`` payload, and renders each trace as a span waterfall.
    """
    import json as _json

    from pathway_tpu_torch.internals.top import StatusUnavailable, fetch_status, render_requests

    if dump is not None:
        try:
            with open(dump) as f:
                payload = _json.load(f)
        except (OSError, ValueError) as exc:
            _echo(f"[pathway_tpu_torch] cannot read dump {dump}: {exc}", err=True)
            return 1
        section = payload.get("requests") or {}
    else:
        try:
            status = fetch_status(_monitoring_url(url, port, process_id, "status"))
        except StatusUnavailable as exc:
            _echo(f"[pathway_tpu_torch] {exc}", err=True)
            return 1
        section = status.get("requests") or {}
    traces = section.get("recent" if recent else "slowest") or []
    if as_json:
        _echo(_json.dumps(traces[:limit], indent=2, sort_keys=True))
        return 0
    _echo(render_requests(traces, limit=limit))
    return 0


def _trace(url, port, process_id, seconds: float) -> int:
    """Capture an on-demand torch.profiler trace from a running worker.

    Asks the worker's monitoring HTTP server (``GET /trace?seconds=N``)
    to run ``torch.profiler`` IN the worker process and write a Chrome
    trace (``trace.json``, viewable in Perfetto or ``chrome://tracing``)
    under the worker's ``PATHWAY_DEVICE_TRACE_DIR``.  Exits non-zero with
    the server's reason when capture is unavailable (no trace dir
    configured, capture already running, endpoint unreachable).
    """
    import json as _json
    import urllib.error
    import urllib.request

    target = _monitoring_url(url, port, process_id, "trace")
    sep = "&" if "?" in target else "?"
    target = f"{target}{sep}seconds={float(seconds)}"
    _echo(f"[pathway_tpu_torch] capturing {seconds:g} s of device trace via {target} ...", err=True)
    try:
        # the server blocks for the capture duration; pad the timeout
        with urllib.request.urlopen(target, timeout=seconds + 30.0) as r:
            payload = _json.loads(r.read().decode())
    except urllib.error.HTTPError as exc:
        try:
            reason = _json.loads(exc.read().decode()).get("error", str(exc))
        except Exception:  # noqa: BLE001 - error body is best-effort
            reason = str(exc)
        _echo(f"[pathway_tpu_torch] trace capture failed: {reason}", err=True)
        return 1
    except (OSError, ValueError) as exc:
        _echo(
            f"[pathway_tpu_torch] cannot reach {target} ({exc}) — is the pipeline "
            "running with with_http_server=True (or "
            "PATHWAY_MONITORING_HTTP_PORT set)?",
            err=True,
        )
        return 1
    trace_dir = payload.get("trace_dir")
    _echo(f"[pathway_tpu_torch] trace written to {trace_dir}")
    _echo(f"[pathway_tpu_torch] view with: perfetto or chrome://tracing on {trace_dir}/trace.json",
          err=True)
    return 0


def _buckets(url, port, process_id, max_buckets: int, as_json: bool, root) -> int:
    """Replay the observed batch-size distribution; suggest better buckets.

    Reads the ragged batch sizes the DeviceExecutor actually saw — live
    from a running worker's ``GET /status`` device section, or post-hoc
    from the flight-recorder dumps under a persistence ROOT — replays
    them against the default power-of-two policy, and reports the bucket
    set of at most ``--max-buckets`` sizes that minimizes padding waste
    (``device/bucketing.py:suggest_buckets``).  Exits non-zero when no
    batch distribution is available.
    """
    import json as _json

    from pathway_tpu_torch.device.bucketing import (
        BucketPolicy,
        next_pow2,
        replay_waste,
        suggest_buckets,
    )

    size_counts: dict[int, int] = {}
    truncated = False
    observed_max_batch: int | None = None
    if root is not None:
        from pathway_tpu_torch.engine.flight_recorder import gather_dumps

        for _wid, payloads in sorted(gather_dumps(root).items()):
            # the accountant's ledger is cumulative per process: count only
            # the newest dump of each attempt, summing across attempts
            newest_per_attempt: dict = {}
            for payload in payloads:
                key = payload.get("attempt")
                prev = newest_per_attempt.get(key)
                if prev is None or (payload.get("dumped_at") or 0) >= (prev.get("dumped_at") or 0):
                    newest_per_attempt[key] = payload
            for payload in newest_per_attempt.values():
                for device_snap in _executor_snapshots(payload.get("device") or {}):
                    try:
                        observed_max_batch = int(device_snap["default_max_batch"])
                    except (KeyError, TypeError, ValueError):
                        pass
                    sizes = (device_snap.get("cost") or {}).get("batch_sizes") or {}
                    for size, count in sizes.items():
                        try:
                            size_counts[int(size)] = size_counts.get(int(size), 0) + int(count)
                        except (TypeError, ValueError):
                            continue
        source = f"flight-recorder dumps under {root}"
    else:
        from pathway_tpu_torch.device.telemetry import BATCH_SIZE_EXPORT_TOP
        from pathway_tpu_torch.engine.metrics import split_labeled_name
        from pathway_tpu_torch.internals.top import StatusUnavailable, fetch_status

        target = _monitoring_url(url, port, process_id, "status")
        try:
            status = fetch_status(target)
        except StatusUnavailable as exc:
            _echo(f"[pathway_tpu_torch] {exc}", err=True)
            return 1
        device_section = status.get("device") or {}
        if device_section.get("device.batch.max"):
            observed_max_batch = int(device_section["device.batch.max"])
        for key, value in device_section.items():
            base, labels = split_labeled_name(key)
            if base != "device.batch.rows" or "rows" not in labels:
                continue
            try:
                size_counts[int(labels["rows"])] = int(value)
            except (TypeError, ValueError):
                continue
        source = target
        # the live feed exports only the most frequent sizes: at the cap
        # the tail was dropped and the report says so
        truncated = len(size_counts) >= BATCH_SIZE_EXPORT_TOP
    if not size_counts:
        _echo(
            f"[pathway_tpu_torch] no batch-size distribution in {source} — the "
            "DeviceExecutor has not dispatched yet (or the dump predates "
            "device observability)",
            err=True,
        )
        return 1
    largest = max(size_counts)
    # the baseline is the analyzed run's default policy (its
    # PATHWAY_DEVICE_MAX_BATCH); the analyst's env is the last resort
    if observed_max_batch is None:
        from pathway_tpu_torch.internals.config import env_int

        observed_max_batch = env_int("PATHWAY_DEVICE_MAX_BATCH")
    current = BucketPolicy(max_bucket=min(next_pow2(largest), int(observed_max_batch))).buckets()
    current_pad, real = replay_waste(size_counts, current)
    suggested = suggest_buckets(size_counts, max_buckets=max_buckets)
    suggested_pad, _ = replay_waste(size_counts, suggested)

    def frac(pad: int) -> float:
        return pad / (pad + real) if (pad + real) else 0.0

    report = {
        "source": source,
        "batches": sum(size_counts.values()),
        "distinct_sizes": len(size_counts),
        "truncated": truncated,
        "largest": largest,
        "real_rows": real,
        "current": {"buckets": list(current), "pad_rows": current_pad,
                    "waste_fraction": frac(current_pad)},
        "suggested": {"buckets": list(suggested), "pad_rows": suggested_pad,
                      "waste_fraction": frac(suggested_pad)},
    }
    if as_json:
        _echo(_json.dumps(report, indent=2, sort_keys=True))
        return 0
    _echo(
        f"batch distribution: {report['batches']} batch(es), "
        f"{report['distinct_sizes']} distinct size(s), largest {largest} ({source})"
    )
    if truncated:
        _echo(
            "  note: the live /status feed exports only the most-frequent "
            "sizes — the tail of the distribution was dropped; read a "
            "flight-recorder root for the full ledger"
        )
    _echo(f"  power-of-two policy {current}: {current_pad} pad row(s) ({frac(current_pad):.1%} waste)")
    _echo(
        f"  suggested buckets   {suggested}: {suggested_pad} pad row(s) "
        f"({frac(suggested_pad):.1%} waste) — {len(suggested)} compile(s) per callable"
    )
    if suggested_pad < current_pad:
        _echo(
            f"  apply with DeviceExecutor.register(..., policy=BucketPolicy("
            f"sizes={suggested})) for the hot callables"
        )
    else:
        _echo("  the power-of-two policy is already near-optimal here")
    return 0


def _executor_snapshots(device: dict) -> list[dict]:
    """The executor snapshots of a dump's ``device`` section: one, as the
    JAX package writes it, or one per device, as the port writes it."""
    if "cost" in device or "queue" in device or "default_max_batch" in device:
        return [device]
    return [snap for snap in device.values() if isinstance(snap, dict)]


def _parser() -> argparse.ArgumentParser:
    """The command line: one subparser a subcommand."""
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
        "reading comes from each worker's freshness tracker",
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

    blackbox = commands.add_parser(
        "blackbox", help="pretty-print flight-recorder dumps under a persistence ROOT",
        description=_blackbox.__doc__,
    )
    blackbox.add_argument("--worker", metavar="N", type=int, default=None,
                          help="show only this worker's dumps")
    blackbox.add_argument("--tail", metavar="N", type=_positive_int, default=20,
                          help="events to show from the end of each dump's ring")
    blackbox.add_argument("--json", dest="as_json", action="store_true",
                          help="emit the raw dumps as JSON")
    blackbox.add_argument("root")

    profile = commands.add_parser(
        "profile", help="render a per-operator attribution tree from profiler output",
        description=_profile.__doc__,
    )
    profile.add_argument("--top", metavar="N", type=_positive_int, default=None,
                         help="operators to show (default: the PATHWAY_PROFILE_TOP knob)")
    profile.add_argument("--json", dest="as_json", action="store_true",
                         help="emit the raw snapshot(s) as JSON")
    profile.add_argument("source")

    top = commands.add_parser(
        "top", help="live backlog, freshness and device view of a running pipeline",
        description=_top.__doc__,
    )
    _add_monitoring_options(top, "status")
    top.add_argument("--interval", metavar="SECONDS", type=float, default=None,
                     help="refresh interval (default: the PATHWAY_STATUS_REFRESH_S knob)")
    top.add_argument("--once", action="store_true",
                     help="render a single frame and exit (no loop)")
    top.add_argument("--json", dest="as_json", action="store_true",
                     help="emit the raw /status JSON")

    requests = commands.add_parser(
        "requests", help="slowest-request waterfalls from the live span buffer or a dump",
        description=_requests.__doc__,
    )
    requests.add_argument("dump", nargs="?", default=None)
    _add_monitoring_options(requests, "status")
    requests.add_argument("-n", "--limit", metavar="N", type=int, default=10,
                          help="waterfalls to render (default 10)")
    requests.add_argument("--recent", action="store_true",
                          help="newest-first instead of slowest-first")
    requests.add_argument("--json", dest="as_json", action="store_true",
                          help="emit the raw trace JSON")

    trace = commands.add_parser(
        "trace", help="capture an on-demand torch.profiler trace from a running worker",
        description=_trace.__doc__,
    )
    _add_monitoring_options(trace, "trace")
    trace.add_argument("--seconds", metavar="S", type=float, default=3.0,
                       help="capture duration (default 3.0)")

    buckets = commands.add_parser(
        "buckets", help="replay the observed batch-size distribution; suggest buckets",
        description=_buckets.__doc__,
    )
    _add_monitoring_options(buckets, "status")
    buckets.add_argument("--max-buckets", metavar="K", type=_positive_int, default=8,
                         help="bucket-set size budget (default 8)")
    buckets.add_argument("--json", dest="as_json", action="store_true",
                         help="emit the report as JSON")
    buckets.add_argument("root", nargs="?", default=None)

    lint = commands.add_parser(
        "lint", help="run the repo-native static analyzer over PATHS",
        description=_lint.__doc__,
    )
    lint.add_argument("--json", dest="as_json", action="store_true",
                      help="emit the report as JSON")
    lint.add_argument("--rules", dest="rule_ids", metavar="ID[,ID...]", default=None,
                      help="run only these rule ids (default: every rule)")
    lint.add_argument("--list-rules", action="store_true",
                      help="print the rule catalogue and exit")
    lint.add_argument("--update-config-docs", action="store_true",
                      help="regenerate docs/torch_configuration.md from the env-knob "
                      "registry (internals/config.py:ENV_KNOBS) and exit")
    lint.add_argument("paths", nargs="*")

    airbyte = commands.add_parser("airbyte", help="Airbyte connection configs")
    airbyte_commands = airbyte.add_subparsers(dest="airbyte_command", required=True)
    create_source = airbyte_commands.add_parser(
        "create-source",
        help="scaffold an Airbyte connection config (requires docker at runtime)",
    )
    create_source.add_argument("connection")
    create_source.add_argument("--image", default="airbyte/source-faker:0.1.4",
                               help="public Airbyte source Docker image")
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.command == "spawn":
        _spawn(args)
    if args.command == "replay":
        _replay(args)
    if args.command == "spawn-from-env":
        return _spawn_from_env()
    if args.command == "profile":
        if not os.path.exists(args.source):
            parser.error(f"SOURCE {args.source!r} does not exist")
        return _profile(args.top, args.as_json, args.source)
    if args.command == "top":
        return _top(args.url, args.port, args.process_id, args.interval, args.once, args.as_json)
    if args.command == "requests":
        if args.dump is not None and not os.path.isfile(args.dump):
            parser.error(f"DUMP {args.dump!r} is not a file")
        return _requests(args.dump, args.url, args.port, args.process_id, args.limit,
                         args.recent, args.as_json)
    if args.command == "trace":
        return _trace(args.url, args.port, args.process_id, args.seconds)
    if args.command == "buckets":
        if args.root is not None and not os.path.isdir(args.root):
            parser.error(f"ROOT {args.root!r} is not a directory")
        return _buckets(args.url, args.port, args.process_id, args.max_buckets,
                        args.as_json, args.root)
    if args.command == "airbyte":
        return _create_source(args.connection, args.image)
    if args.command == "lint":
        missing = [path for path in args.paths if not os.path.exists(path)]
        if missing:
            parser.error(f"PATHS {missing!r} do not exist")
        return _lint(args.as_json, args.rule_ids, args.list_rules, args.update_config_docs, args.paths)
    if not os.path.isdir(args.root):
        parser.error(f"ROOT {args.root!r} is not a directory")
    if args.command == "blackbox":
        return _blackbox(args.worker, args.tail, args.as_json, args.root)
    return _scrub(args.worker, args.as_json, args.repair, args.root)


def _lint(as_json: bool, rule_ids: str | None, list_rules: bool, update_config_docs: bool,
          paths: list[str]) -> int:
    """Run the repo-native static analyzer over PATHS.

    Default paths are the ``pathway_tpu_torch`` package and its sibling
    ``tests/`` tree.  Rules prove thread-context safety (no blocking calls
    on the epoch loop or signal paths, timed waits on supervised background
    threads), lock-order consistency, env-knob and metric-name registry
    discipline, jit recompile discipline, and the chaos-suite sleep policy
    (``docs/static_analysis.md``).

    Exits 1 when any unsuppressed finding remains, 2 on an unknown rule id.
    Suppressions (``# pathway-lint: disable=<rule> — <reason>``) are
    audited: a reasonless or useless suppression is itself a finding.
    """
    from pathway_tpu_torch.analysis import RULES, report_to_text, run_lint

    if list_rules:
        width = max(len(rid) for rid in RULES)
        for rid in sorted(RULES):
            _echo(f"{rid:<{width}}  {RULES[rid].doc}")
        return 0
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    repo_root = os.path.dirname(pkg_dir)
    if update_config_docs:
        from pathway_tpu_torch.internals.config import render_env_docs

        doc_path = os.path.join(repo_root, "docs", "torch_configuration.md")
        os.makedirs(os.path.dirname(doc_path), exist_ok=True)
        with open(doc_path, "w", encoding="utf-8") as f:
            f.write(render_env_docs())
        _echo(f"[pathway_tpu_torch] wrote {doc_path}")
        return 0
    if not paths:
        paths = [pkg_dir]
        tests_dir = os.path.join(repo_root, "tests")
        if os.path.isdir(tests_dir):
            paths.append(tests_dir)
    selected = None
    if rule_ids:
        selected = [r.strip() for r in rule_ids.split(",") if r.strip()]
    try:
        report = run_lint(paths, rules=selected)
    except ValueError as exc:  # unknown rule id
        _echo(f"[pathway_tpu_torch] {exc}", err=True)
        return 2
    _echo(report_to_text(report, as_json=as_json))
    return 0 if report.ok else 1


def _create_source(connection: str, image: str) -> int:
    """Scaffold an Airbyte connection config (``airbyte create-source``)."""
    from pathway_tpu_torch.io.airbyte import write_connection_scaffold

    path = write_connection_scaffold(connection, image)
    _echo(f"Connection `{connection}` with source `{image}` created at {path}")
    return 0


def _positive_int(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"{value} is smaller than 1")
    return value


def _add_monitoring_options(parser: argparse.ArgumentParser, endpoint: str) -> None:
    """``--url``, ``--port`` and ``--process-id``, resolved by
    :func:`_monitoring_url`."""
    parser.add_argument("--url", metavar="URL", default=None,
                        help=f"full /{endpoint} URL (overrides --port/--process-id)")
    parser.add_argument("--port", metavar="PORT", type=int, default=None,
                        help="monitoring HTTP port (default: PATHWAY_MONITORING_HTTP_PORT, "
                        "else 20000 + process id)")
    parser.add_argument("--process-id", metavar="N", type=int, default=0,
                        help="worker whose endpoint to use (port defaults to 20000 + N)")


if __name__ == "__main__":
    sys.exit(main())
