"""Warm-standby workers: tail the persistence root so unplanned worker
loss costs one shard promotion, not a whole-group restart.

A supervised run may spawn K standby processes beside its N workers
(``spawn --supervise --standbys K`` / ``PATHWAY_STANDBY_COUNT``).  A
standby never joins the mesh and never executes the pipeline — it sits
in :func:`standby_main`, tailing the persistence root: every tick it
re-lists each worker's generation manifests and deep-verifies any newly
committed generation (``verify_manifest`` — the PR-2 verify-on-read
machinery), warming its verify cache and the OS page cache with exactly
the artifacts a resume of that shard would read.  Its progress is
published as an apply-cursor beacon (``lease/standby.<sid>``: newest
verified generation per worker + apply lag), which ``pathway_tpu_torch
scrub``/``top`` render and the workers re-export as ``standby.lag.s``.

On a worker death the supervisor posts a PROMOTE request naming one
standby (see ``engine/supervisor.py``).  The chosen standby acks,
adopts the dead worker's identity — process id, per-worker fence token
(``bump_worker_fence``), topology — and returns from
:func:`standby_main` into the normal worker boot path
(``internals/runner.py``), resuming the dead shard from its committed
generations.  Because the tail loop already verified (and page-cached)
everything up to the last commit, the promotion replays only the
uncommitted tail: sub-second where a whole-group restart pays backoff +
full resume.

Everything here is FileBackend/filesystem-root coordination, exactly
like the live-handoff machinery it mirrors; faults ``standby_lag`` and
``promote_crash`` (``engine/faults.py``) inject a starved standby and a
mid-promotion death.
"""

from __future__ import annotations

import logging
import os
import signal
import time as _time

from pathway_tpu_torch.engine import faults as _faults
from pathway_tpu_torch.engine import flight_recorder as _blackbox
from pathway_tpu_torch.engine import persistence as pz

logger = logging.getLogger(__name__)


def standby_id() -> int | None:
    """This process's standby ordinal (``PATHWAY_STANDBY_ID``, exported by
    the supervisor), or None for a normal worker."""
    from pathway_tpu_torch.internals.config import env_int, env_raw

    if env_raw("PATHWAY_STANDBY_ID") is None:
        return None
    return env_int("PATHWAY_STANDBY_ID")


class StandbyTailer:
    """The tail loop's state: per-worker apply cursors + verify cache."""

    def __init__(self, root: str, standby: int):
        self.root = root
        self.standby = standby
        self.backend = pz.FileBackend(root)
        # newest deep-verified generation per worker shard — the apply
        # cursor the beacon publishes and a promotion resumes beyond
        self.cursors: dict[int, int] = {}
        self.verified_chunks = 0
        self.lag_s = 0.0
        self._verify_cache: set[str] = set()

    def tick(self) -> None:
        """One tail pass: verify every generation committed since the
        cursors, then refresh the beacon.  Damage is logged and skipped —
        a standby is an observer; resume-time fallback (and scrub) own
        the damaged-generation story.

        ``lag_s`` is measured at the top of the pass — the age of the
        OLDEST generation committed but not yet verified — so a starved
        standby (``standby_lag`` fault, a slow store) publishes its real
        apply lag rather than 0 the instant it finally catches up."""
        _faults.maybe_standby_lag(standby=self.standby)
        pending: list[tuple[int, int, str]] = []
        oldest_at: float | None = None
        for worker, gens in self._scan().items():
            cursor = self.cursors.get(worker, 0)
            for gen, key in gens:
                if gen <= cursor:
                    continue
                pending.append((worker, gen, key))
                at = self._mtime(key)
                if at is not None:
                    oldest_at = at if oldest_at is None else min(oldest_at, at)
        self.lag_s = (
            max(0.0, _time.time() - oldest_at) if oldest_at is not None
            else 0.0
        )
        held: set[int] = set()
        for worker, gen, key in pending:
            if worker in held:
                continue  # an earlier generation of this worker failed
            manifest, reason = pz._read_manifest(self.backend, key)
            problems = (
                [reason or "manifest unreadable"] if manifest is None
                else pz.verify_manifest(
                    self.backend, worker, manifest,
                    cache=self._verify_cache,
                )
            )
            if problems:
                logger.warning(
                    "standby %d: worker %d generation %d failed "
                    "verification (%s); holding cursor", self.standby,
                    worker, gen, "; ".join(problems[:3]),
                )
                held.add(worker)
                continue
            self.verified_chunks += sum(
                int(meta.get("chunks", 0)) - int(meta.get("chunk_start", 0))
                for meta in (manifest.get("sources") or {}).values()
            )
            self.cursors[worker] = gen
        pz.write_standby_beacon(
            self.root,
            self.standby,
            cursors=self.cursors,
            lag_s=round(self.lag_s, 3),
            verified_chunks=self.verified_chunks,
        )

    def _scan(self) -> dict[int, list[tuple[int, str]]]:
        """{worker: [(generation, key) oldest-first]} for every manifest
        on the root."""
        out: dict[int, list[tuple[int, str]]] = {}
        for key in self.backend.list_keys("manifests/"):
            parts = key.split("/")
            if len(parts) == 3 and parts[1].isdigit() and parts[2].isdigit():
                out.setdefault(int(parts[1]), []).append((int(parts[2]), key))
        for entries in out.values():
            entries.sort()
        return out

    def _mtime(self, key: str) -> float | None:
        try:
            return os.path.getmtime(os.path.join(self.root, *key.split("/")))
        except OSError:
            return None


def state_metrics(root: str) -> dict[str, float]:
    """Numeric ``standby.*`` / ``supervisor.promotions`` gauges derived
    from the root's beacons + promotion history — the registry collector
    each worker registers so the warm-standby panel rides /status,
    /metrics and ``pathway_tpu_torch top`` without new plumbing (the
    supervisor's own registry serves no scrape endpoint)."""
    beacons = pz.read_standby_beacons(root)
    promotions = pz.read_promotions(root)
    if not beacons and not promotions:
        return {}
    out: dict[str, float] = {
        "standby.pool": float(len(beacons)),
        "supervisor.promotions": float(len(promotions)),
    }
    for sid, beacon in sorted(beacons.items()):
        out[f"standby.lag.s{{standby={sid}}}"] = float(
            beacon.get("lag_s") or 0.0
        )
        out[f"standby.verified.chunks{{standby={sid}}}"] = float(
            beacon.get("verified_chunks") or 0
        )
    if promotions:
        last = promotions[-1]
        if isinstance(last.get("worker"), int):
            out["supervisor.promotions.last.worker"] = float(last["worker"])
    return out


def _await_survivor_acks(root: str, req: dict) -> bool:
    """Block until every SURVIVOR has acked promotion ``req`` — i.e. has
    drained its old mesh and is about to rejoin — so the adopting standby
    never dials listeners that still belong to the dying mesh.  Returns
    False when the request is cleared/replaced while waiting (the
    supervisor aborted: fall back to tailing); the supervisor's promote
    deadline bounds the wait from outside."""
    survivors = [w for w in range(req["workers"]) if w != req["worker"]]
    while True:
        acks = pz.read_promote_acks(root, req["workers"])
        if all(
            str(w) in acks and acks[str(w)].get("seq") == req["seq"]
            for w in survivors
        ):
            return True
        live = pz.read_promote_request(root)
        if live is None or live["seq"] != req["seq"]:
            return False
        # bounded 0.05 s poll; the supervisor's promote deadline ends a
        # wedged wait from outside
        _time.sleep(0.05)


def standby_main(root: str, standby: int) -> dict | None:
    """Run the standby tail loop until promoted or told to stop.

    Returns the PROMOTE request dict once this standby has acked it and
    adopted the dead worker's identity (``PATHWAY_PROCESS_ID`` /
    ``PATHWAY_WORKER_FENCE`` / ``PATHWAY_PROCESSES`` re-exported, config
    refreshed) — the caller then falls into the normal worker boot path.
    Returns None on a SIGTERM/SIGINT stop request (supervisor shutdown).
    """
    from pathway_tpu_torch.internals.config import env_float, refresh_config

    poll_s = max(0.05, env_float("PATHWAY_STANDBY_POLL_S"))
    tailer = StandbyTailer(root, standby)
    stop = {"flag": False}

    def _on_stop(signum: int, frame: object) -> None:
        stop["flag"] = True

    prior = {
        sig: signal.signal(sig, _on_stop)
        for sig in (signal.SIGTERM, signal.SIGINT)
    }
    logger.info("standby %d tailing %s (poll %.2fs)", standby, root, poll_s)
    _blackbox.record("standby.start", standby=standby, root=root)
    try:
        next_tick = 0.0
        while not stop["flag"]:
            now = _time.monotonic()
            if now >= next_tick:
                try:
                    tailer.tick()
                except OSError as exc:
                    logger.warning(
                        "standby %d: tail tick failed (%s); retrying",
                        standby, exc,
                    )
                next_tick = now + poll_s
            req = pz.read_promote_request(root)
            if (
                req is not None
                and req["standby"] == standby
                and req["incarnation"] == pz.writer_incarnation()
            ):
                pz.write_promote_ack(
                    root, "standby", seq=req["seq"], worker=req["worker"],
                    incarnation=req["incarnation"],
                )
                # wait for every survivor's drained-and-rejoining ack
                # before binding the dead worker's port: their OLD mesh
                # listeners must be gone before this process dials
                if not _await_survivor_acks(root, req):
                    logger.warning(
                        "standby %d: promotion %d aborted by the "
                        "supervisor while awaiting survivors; resuming "
                        "tail", standby, req["seq"],
                    )
                    continue
                # adopt the dead worker's identity; every config read
                # after refresh_config() sees the promoted topology
                os.environ["PATHWAY_PROCESS_ID"] = str(req["worker"])
                os.environ["PATHWAY_WORKER_FENCE"] = str(req["fence"])
                os.environ["PATHWAY_PROCESSES"] = str(req["workers"])
                os.environ.pop("PATHWAY_STANDBY_ID", None)
                refresh_config()
                # the adopted marker is the supervisor's completion
                # trigger: written strictly after the survivor wait, so
                # the supervisor clearing the promote files can never
                # race this standby's own reads of them
                pz.write_promote_ack(
                    root, "adopted", seq=req["seq"], worker=req["worker"],
                    incarnation=req["incarnation"],
                )
                # the narrowest promote_crash window: ack durable, fence
                # bumped, nothing published yet as the new worker id
                _faults.maybe_crash_promote(
                    standby=standby, worker=req["worker"]
                )
                _blackbox.record(
                    "standby.promoted", standby=standby,
                    worker=req["worker"], seq=req["seq"],
                    fence=req["fence"], lag_s=tailer.lag_s,
                )
                logger.info(
                    "standby %d promoted to worker %d (promotion %d, "
                    "fence %d)", standby, req["worker"], req["seq"],
                    req["fence"],
                )
                return req
            # promote-watch poll, bounded at 0.05 s so a PROMOTE request
            # is seen sub-tick
            _time.sleep(0.05)
    finally:
        for sig, handler in prior.items():
            signal.signal(sig, handler)
    _blackbox.record("standby.stop", standby=standby)
    logger.info("standby %d stopping (supervisor shutdown)", standby)
    return None
