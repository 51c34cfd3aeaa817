"""Engine-side persistence: snapshots, offset frontiers, crash-resume.

Parity target: ``src/persistence/`` —
``WorkerPersistentStorage`` (tracker.rs:49-260), input snapshot event logs
(input_snapshot.rs: Event{Insert, Delete, AdvanceTime, Finished}), offset
antichains (frontier.rs), and the file/S3/memory/mock backends
(backends/*.rs).  Redesigned for this engine's epoch model:

* Each persisted source owns an append-only **event log** of encoded events
  (``engine/codec.py``), written one chunk per committed epoch.
* Every persisted artifact (snapshot chunk, manifest, operator dump) is
  wrapped in a self-checking **integrity frame** (magic + version + length
  + CRC32C, ``engine/codec.py``), so torn writes, truncations and bit rot
  are *detected* at read time instead of silently corrupting recovery.
* Each commit writes a per-generation **manifest** (chunk list + SHA-256
  digests + operator/graph digest) atomically (tmp + rename / object PUT).
  The manifest is the commit point; the last ``PATHWAY_CHECKPOINT_GENERATIONS``
  manifests are retained with deferred GC, so recovery can fall back
  generation-by-generation to the newest FULLY VERIFIED checkpoint when
  the newest one is damaged.  A legacy ``metadata.json.<worker>`` pointer
  is still written for humans and for the supervisor's post-mortems.
* On resume, committed events replay into the input session at artificial
  time 0 (``ARTIFICIAL_TIME_ON_REWIND_START``, connectors/mod.rs:222-258)
  and the reader seeks to the stored frontier before producing new rows.
* Commits are **pipelined**: a bounded background writer pool
  (``PATHWAY_CHECKPOINT_WRITERS``, byte-capped backpressure via
  ``PATHWAY_CHECKPOINT_INFLIGHT_MB``) owns chunk/dump framing + SHA-256 +
  upload, and a committer thread publishes each generation manifest only
  after a **commit barrier** confirms every referenced artifact landed —
  so the epoch loop overlaps durability I/O with compute while the
  manifest-IS-the-commit-point invariant is unchanged (a crash mid-flight
  leaves an unreferenced partial generation that GC/scrub tolerate).

``scrub_root`` audits a persistence root offline (the ``python -m pathway_tpu_torch.cli scrub``
CLI drives it) and reports per-generation health without mutating anything.

Backend selection mirrors ``python/pathway/persistence/__init__.py``:
filesystem / mock (in-memory) / s3 (gated on client library presence).

A copy of ``pathway_tpu/engine/persistence.py``.  The object stores
``S3Backend``, ``GcsBackend`` and ``AzureBackend`` sit on the shared retry
logic of ``_PrefixedObjectStore`` and the standard-library clients of
``io/_s3http.py`` (SigV4), ``io/_gcshttp.py`` (the JSON API) and
``io/_azureblob.py`` (SharedKey).  The lease, handoff, promote and
repartition functions are host code that the supervisor
(``engine/supervisor.py``), the warm standby (``engine/standby.py``) and
the multi-worker runner call.
"""

from __future__ import annotations

import hashlib
import json as _json
import logging
import os
import pickle
import threading
import time as _time
from collections import deque
from contextvars import ContextVar
from typing import Any, Callable

from pathway_tpu_torch.engine import codec
from pathway_tpu_torch.engine import flight_recorder as _blackbox
from pathway_tpu_torch.engine import metrics as _registry

METADATA_FILE = "metadata.json"
MANIFEST_FORMAT = 1

# -- incarnation fencing (split-brain protection) ---------------------------
# The supervisor owns a LEASE on the persistence root: a monotonically
# increasing *incarnation* number bumped before every (re)launch of the
# worker group, exported to workers via PATHWAY_INCARNATION.  Every
# commit-point write re-reads the lease and REFUSES to publish when it
# shows a newer incarnation — a zombie worker from a superseded restart
# attempt (alive but partitioned, SIGKILL not yet delivered) can therefore
# never splice a stale generation into a root the respawned cluster owns.
LEASE_KEY = "lease/LEASE"
LEASE_FORMAT = 1
ENV_INCARNATION = "PATHWAY_INCARNATION"

# -- elastic rescale (topology marker) --------------------------------------
# The root-level record of the CURRENT topology epoch: {"seq", "workers",
# "from_workers", "at"}.  ``seq`` increments on every rescale, and every
# manifest is stamped with the epoch it was published under — that is what
# makes a STALE shard detectable even when its stamped worker count
# coincidentally matches the current one (a 2 -> 1 -> 2 round trip).  The
# marker is written by the repartitioning workers themselves (idempotent:
# every worker of one rescale computes the same successor epoch), so it
# exists on supervised and solo roots alike.
TOPOLOGY_KEY = "topology/CURRENT"
TOPOLOGY_FORMAT = 1

_log = logging.getLogger("pathway_tpu_torch.persistence")


class CheckpointError(RuntimeError):
    """A committed checkpoint artifact is missing or failed verification."""


class FencedError(CheckpointError):
    """A newer cluster incarnation owns this persistence root.

    Raised instead of performing a commit-point write (generation-manifest
    publish, advisory-pointer refresh) when the on-root lease shows an
    incarnation newer than this writer's ``PATHWAY_INCARNATION``.  The only
    correct reaction is to STOP: this process is a zombie from a superseded
    restart attempt, and anything it publishes would corrupt the live
    cluster's recovery provenance.  The runner lets it propagate, so the
    worker exits nonzero and its peers drop it from the mesh.
    """


def writer_incarnation() -> int:
    """This process's cluster incarnation (``PATHWAY_INCARNATION``); 0 when
    unleased — solo runs without a supervisor skip fencing entirely."""
    from pathway_tpu_torch.internals.config import env_int

    return env_int(ENV_INCARNATION)


def _worker_fence() -> int:
    """This process's per-worker fence token (``PATHWAY_WORKER_FENCE``);
    0 for anything but a promoted standby — see bump_worker_fence()."""
    from pathway_tpu_torch.internals.config import env_int

    return env_int("PATHWAY_WORKER_FENCE")


def _decode_lease(raw: bytes | None) -> dict | None:
    """Decode a raw lease blob; None when absent, torn, or malformed."""
    if raw is None:
        return None
    try:
        obj = _json.loads(codec.unframe_blob(raw, what=LEASE_KEY).decode())
    except (codec.IntegrityError, ValueError):
        return None
    if not isinstance(obj, dict) or not isinstance(obj.get("incarnation"), int):
        return None
    return obj


def read_lease(backend: "BlobBackend") -> dict | None:
    """The root's lease object, or None when absent/unreadable.

    Unreadable is treated as absent on the WRITE path (a torn lease must
    not brick every writer); ``scrub_root`` reports it as damage so an
    operator notices."""
    return _decode_lease(backend.get(LEASE_KEY))


def acquire_lease(
    backend: "BlobBackend",
    *,
    owner: str | None = None,
    run_id: str | None = None,
    workers: int | None = None,
) -> int:
    """Bump the root's lease to the next incarnation and return it.

    Monotonic across runs of the same root: a fresh supervisor on a reused
    root starts ABOVE every incarnation that ever wrote there, so any
    lingering zombie from a previous run is fenced on its next publish.
    Single-supervisor protocol — the lease serializes worker incarnations
    under one supervisor, it is not a distributed lock between supervisors.

    ``workers`` records the TARGET TOPOLOGY of this incarnation — the
    worker count the supervisor is about to launch.  The lease is the
    authoritative record an elastic rescale leaves behind: workers verify
    their own ``PATHWAY_PROCESSES`` against it at boot (the topology
    handshake in ``internals/runner.py``), and ``python -m pathway_tpu_torch.cli scrub``
    renders the rescale history kept in ``topology_history`` (bounded to
    the last 16 changes).  ``None`` carries the previous recorded topology
    forward unchanged.
    """
    current = read_lease(backend)
    incarnation = (current["incarnation"] if current else 0) + 1
    history = list((current or {}).get("topology_history") or [])
    recorded = workers if workers is not None else (current or {}).get("workers")
    if workers is not None and (
        not history or history[-1].get("workers") != workers
    ):
        history.append(
            {
                "incarnation": incarnation,
                "workers": workers,
                "at": _time.time(),
            }
        )
    lease = {
        "format": LEASE_FORMAT,
        "incarnation": incarnation,
        "acquired_at": _time.time(),
        "owner": owner or f"pid-{os.getpid()}",
        "run_id": run_id,
        "workers": recorded,
        "topology_history": history[-16:],
    }
    backend.put_atomic(LEASE_KEY, codec.frame_blob(_json.dumps(lease).encode()))
    return incarnation


def read_topology_marker(backend: "BlobBackend") -> dict | None:
    """The root's current topology-epoch marker, or None when absent or
    unreadable (a pre-rescale root has none; an unreadable marker degrades
    to stamp-based detection and scrub reports it)."""
    raw = backend.get(TOPOLOGY_KEY)
    if raw is None:
        return None
    try:
        obj = _json.loads(
            codec.unframe_blob(raw, what=TOPOLOGY_KEY).decode()
        )
    except (codec.IntegrityError, ValueError):
        return None
    if (
        not isinstance(obj, dict)
        or not isinstance(obj.get("seq"), int)
        or not isinstance(obj.get("workers"), int)
    ):
        return None
    return obj


def read_lease_file(root: str) -> dict | None:
    """Read a filesystem root's lease WITHOUT constructing a FileBackend
    (which would mkdir the root as a side effect) — the boot-time topology
    handshake must stay read-only.  None when absent or unreadable."""
    path = os.path.join(root, *LEASE_KEY.split("/"))
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    return _decode_lease(raw)


# -- live shard handoff coordination files --
#
# A planned rescale is coordinated through tiny advisory JSON files under
# the root's ``lease/`` directory — the same location as the lease and the
# progress beacons, and like them PLAIN (unframed) JSON written via
# atomic tmp+rename: they are supervisor↔worker signaling, not recovery
# state, so a torn or stale file degrades to "no handoff" and the
# supervisor falls back to the restart-based rescale.  Protocol:
#
#   1. the supervisor posts ``lease/HANDOFF`` ({incarnation, from_workers,
#      to_workers, reason}); workers ignore requests whose incarnation is
#      not THEIR incarnation (a zombie must not join a handoff).
#   2. worker 0 notices the request at an epoch boundary and broadcasts
#      the handoff decision on the epoch channel; EVERY worker then drains
#      a synchronous commit of its exact frontier (stamped ``handoff_to``),
#      fences its own storage (``fence_for_handoff``), barriers, and
#      writes ``lease/handoff.ack.<worker>`` before exiting cleanly.
#   3. the supervisor sees all workers exit 0 WITH a complete ack set and
#      relaunches at the new topology — the PR-10 repartition machinery
#      replays the moving shard ranges from the acked frontiers.  Any
#      other outcome (death, missing ack, deadline) → restart fallback.
HANDOFF_KEY = "lease/HANDOFF"
HANDOFF_ACK_PREFIX = "lease/handoff.ack."
HANDOFF_FORMAT = 1


def _lease_dir_write_json(root: str, key: str, obj: dict) -> None:
    """Atomically (tmp+rename) write an advisory JSON file under the
    root's lease/ directory without constructing a FileBackend."""
    path = os.path.join(root, *key.split("/"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        _json.dump(obj, f)
    os.replace(tmp, path)


def _lease_dir_read_json(root: str, key: str) -> dict | None:
    """Best-effort read of an advisory lease/ JSON file; None when absent,
    torn, or malformed (advisory contract: damage degrades to absence)."""
    path = os.path.join(root, *key.split("/"))
    try:
        with open(path, "r", encoding="utf-8") as f:
            obj = _json.load(f)
    except (OSError, ValueError):
        return None
    return obj if isinstance(obj, dict) else None


def post_handoff_request(
    root: str,
    *,
    incarnation: int,
    from_workers: int,
    to_workers: int,
    reason: str = "",
) -> None:
    """Supervisor side: ask the CURRENT incarnation's workers to hand the
    root off to ``to_workers`` at their next epoch boundary."""
    _lease_dir_write_json(
        root,
        HANDOFF_KEY,
        {
            "format": HANDOFF_FORMAT,
            "incarnation": incarnation,
            "from_workers": from_workers,
            "to_workers": to_workers,
            "reason": reason,
            "at": _time.time(),
        },
    )


def read_handoff_request(root: str) -> dict | None:
    """The pending handoff request, or None when absent/unreadable/not a
    well-formed request (advisory: malformed never raises)."""
    obj = _lease_dir_read_json(root, HANDOFF_KEY)
    if (
        obj is None
        or not isinstance(obj.get("incarnation"), int)
        or not isinstance(obj.get("to_workers"), int)
        or obj["to_workers"] < 1
    ):
        return None
    return obj


def write_handoff_ack(
    root: str,
    worker: int,
    *,
    incarnation: int,
    to_workers: int,
    frontier: Any = None,
) -> None:
    """Worker side: record that this worker fenced + committed its exact
    frontier for the handoff to ``to_workers`` and is about to exit."""
    _lease_dir_write_json(
        root,
        f"{HANDOFF_ACK_PREFIX}{worker}",
        {
            "format": HANDOFF_FORMAT,
            "worker": worker,
            "incarnation": incarnation,
            "to_workers": to_workers,
            "frontier": frontier,
            "at": _time.time(),
        },
    )


def read_handoff_acks(root: str, workers: int) -> dict[int, dict]:
    """{worker: ack} for every well-formed ack of workers 0..workers-1.
    The supervisor declares a handoff successful only when the set is
    COMPLETE and every ack matches the request's incarnation/target."""
    out: dict[int, dict] = {}
    for w in range(workers):
        obj = _lease_dir_read_json(root, f"{HANDOFF_ACK_PREFIX}{w}")
        if obj is not None and obj.get("worker") == w:
            out[w] = obj
    return out


def clear_handoff(root: str, workers: int) -> None:
    """Remove the request and every ack file — called by the supervisor
    after a handoff concludes (either way), so a stale request can never
    leak into the next incarnation."""
    keys = [HANDOFF_KEY] + [
        f"{HANDOFF_ACK_PREFIX}{w}" for w in range(workers)
    ]
    for key in keys:
        try:
            os.remove(os.path.join(root, *key.split("/")))
        except OSError:
            pass


# -- warm-standby promotion coordination files --
#
# Unplanned worker loss is coordinated through the same advisory lease/
# JSON mechanism as the planned handoff above — but the protocol is the
# mirror image: the group does NOT exit.  On a worker death the
# supervisor bumps the dead worker's PER-WORKER fence in the lease (so a
# half-dead writer can never publish again without fencing the whole
# incarnation — the survivors keep their incarnation and must keep
# publishing), posts ``lease/PROMOTE``, and waits:
#
#   1. the chosen standby acks ``lease/promote.ack.standby``, adopts the
#      dead worker's id + fence token, and falls into the normal worker
#      boot path (resume from the dead shard's committed generations);
#   2. every SURVIVOR's promote sentinel poisons its mesh, drain-commits
#      its consistent frontier in-process, acks
#      ``lease/promote.ack.<worker>``, and re-enters the event loop with
#      a fresh mesh — the OS process never exits;
#   3. the supervisor sees the complete ack set, records the promotion in
#      ``lease/promotions.json`` (scrub/top provenance), and clears the
#      request.  Any other outcome (standby death, missing ack, deadline)
#      → the two-tier fallback: whole-group restart, exactly as before
#      standbys existed.
#
# Standbys additionally maintain ``lease/standby.<sid>`` apply-cursor
# beacons (per-worker verified-generation cursors + lag) so operators —
# and ``python -m pathway_tpu_torch.cli scrub`` — can see how warm the pool is.  All of it is
# advisory: torn or stale files degrade to "no promotion" and the
# restart fallback absorbs the loss.
PROMOTE_KEY = "lease/PROMOTE"
PROMOTE_ACK_PREFIX = "lease/promote.ack."
PROMOTIONS_KEY = "lease/promotions.json"
STANDBY_BEACON_PREFIX = "lease/standby."
PROMOTE_FORMAT = 1


def bump_worker_fence(backend: "BlobBackend", worker: int) -> int:
    """Fence ``worker`` (and only it) out of the root: bump its entry in
    the lease's per-worker fence map and return the new token.

    The promoted standby inherits the new token (``PATHWAY_WORKER_FENCE``)
    and passes ``_check_fence``; anything still writing as this worker
    with an older token — the dead worker's lingering writer threads, a
    zombie that was SIGKILLed but whose async publish is still in flight
    on a remote store — is rejected at its next commit point.  Distinct
    from the INCARNATION bump a whole-group restart performs: survivors
    keep publishing under the same incarnation, so promotion must never
    touch it.  ``acquire_lease`` rebuilds the lease without carrying
    ``fences`` forward, so a later restart-all clears every per-worker
    fence along with the incarnation bump that supersedes them."""
    lease = read_lease(backend)
    if lease is None:
        raise CheckpointError(
            "cannot fence a worker on an unleased root — promotion is a "
            "supervised-run protocol and the supervisor owns the lease"
        )
    fences = dict(lease.get("fences") or {})
    token = int(fences.get(str(worker), 0)) + 1
    fences[str(worker)] = token
    lease["fences"] = fences
    backend.put_atomic(LEASE_KEY, codec.frame_blob(_json.dumps(lease).encode()))
    return token


def post_promote_request(
    root: str,
    *,
    incarnation: int,
    worker: int,
    standby: int,
    fence: int,
    seq: int,
    workers: int,
    reason: str = "",
) -> None:
    """Supervisor side: ask standby ``standby`` to adopt dead ``worker``
    and every survivor to rejoin the mesh in-process."""
    _lease_dir_write_json(
        root,
        PROMOTE_KEY,
        {
            "format": PROMOTE_FORMAT,
            "incarnation": incarnation,
            "worker": worker,
            "standby": standby,
            "fence": fence,
            "seq": seq,
            "workers": workers,
            "reason": reason,
            "at": _time.time(),
        },
    )


def read_promote_request(root: str) -> dict | None:
    """The pending promotion request, or None when absent/unreadable/not
    well-formed (advisory: malformed never raises)."""
    obj = _lease_dir_read_json(root, PROMOTE_KEY)
    if obj is None or not all(
        isinstance(obj.get(k), int)
        for k in ("incarnation", "worker", "standby", "fence", "seq", "workers")
    ):
        return None
    return obj


def write_promote_ack(
    root: str, who: int | str, *, seq: int, worker: int, incarnation: int
) -> None:
    """Record participation in promotion ``seq``: ``who`` is a surviving
    worker id, or the string ``"standby"`` for the adopting standby
    (written BEFORE it takes the dead worker's id, so the ack never
    collides with the survivors' numeric files)."""
    _lease_dir_write_json(
        root,
        f"{PROMOTE_ACK_PREFIX}{who}",
        {
            "format": PROMOTE_FORMAT,
            "who": str(who),
            "seq": seq,
            "worker": worker,
            "incarnation": incarnation,
            "at": _time.time(),
        },
    )


def read_promote_acks(root: str, workers: int) -> dict[str, dict]:
    """{who: ack} for every promotion ack present.  Keys are stringified
    worker ids (survivors), ``"standby"`` (the chosen standby is alive
    and participating), and ``"adopted"`` (the standby finished waiting
    for the survivors and took the dead worker's identity — the
    supervisor's completion trigger, written LAST so clearing the files
    can never race the standby's own wait)."""
    out: dict[str, dict] = {}
    for who in ["standby", "adopted"] + [str(w) for w in range(workers)]:
        obj = _lease_dir_read_json(root, f"{PROMOTE_ACK_PREFIX}{who}")
        if obj is not None and obj.get("who") == who:
            out[who] = obj
    return out


def clear_promote(root: str, workers: int) -> None:
    """Remove the promotion request and every ack — supervisor side,
    after a promotion concludes either way."""
    keys = [
        PROMOTE_KEY,
        f"{PROMOTE_ACK_PREFIX}standby",
        f"{PROMOTE_ACK_PREFIX}adopted",
    ] + [f"{PROMOTE_ACK_PREFIX}{w}" for w in range(workers)]
    for key in keys:
        try:
            os.remove(os.path.join(root, *key.split("/")))
        except OSError:
            pass


_PROMOTIONS_CAP = 64


def append_promotion(root: str, record: dict) -> None:
    """Append one promotion record to the root's bounded promotion
    history (``lease/promotions.json``) — the provenance ``pathway_tpu_torch
    scrub``/``top`` render and the workers re-export as the
    ``supervisor.promotions`` counter."""
    history = read_promotions(root)
    history.append(record)
    _lease_dir_write_json(
        root, PROMOTIONS_KEY, {"promotions": history[-_PROMOTIONS_CAP:]}
    )


def read_promotions(root: str) -> list[dict]:
    """The root's promotion history, oldest first; [] when absent/torn."""
    obj = _lease_dir_read_json(root, PROMOTIONS_KEY)
    if obj is None or not isinstance(obj.get("promotions"), list):
        return []
    return [p for p in obj["promotions"] if isinstance(p, dict)]


def write_standby_beacon(
    root: str,
    standby: int,
    *,
    cursors: dict[int, int],
    lag_s: float,
    verified_chunks: int,
    pid: int | None = None,
) -> None:
    """Standby side: publish this standby's apply cursor — the newest
    verified generation per worker shard — plus its apply lag."""
    _lease_dir_write_json(
        root,
        f"{STANDBY_BEACON_PREFIX}{standby}",
        {
            "format": PROMOTE_FORMAT,
            "standby": standby,
            "cursors": {str(w): g for w, g in cursors.items()},
            "lag_s": lag_s,
            "verified_chunks": verified_chunks,
            "pid": pid if pid is not None else os.getpid(),
            "at": _time.time(),
        },
    )


def read_standby_beacons(root: str) -> dict[int, dict]:
    """{standby id: beacon} for every well-formed standby apply-cursor
    beacon under the root's lease/ directory."""
    lease_dir = os.path.join(root, "lease")
    prefix = STANDBY_BEACON_PREFIX.rsplit("/", 1)[-1]
    out: dict[int, dict] = {}
    try:
        names = os.listdir(lease_dir)
    except OSError:
        return out
    for name in names:
        tail = name[len(prefix):]
        if not name.startswith(prefix) or not tail.isdigit():
            continue
        obj = _lease_dir_read_json(root, f"lease/{name}")
        if obj is not None and obj.get("standby") == int(tail):
            out[int(tail)] = obj
    return out


_BASE_SID_RE = None


def base_source_id(source_id: str) -> str:
    """Strip the per-worker ``-w<N>`` suffix of a snapshot source id.

    Multi-worker runs shard source logs as ``<name>-w<worker>``; a
    topology rescale matches old and new logs by this BASE name, so
    ``src-w3`` of a 4-worker root and ``src-w1`` of its 2-worker successor
    are the same logical source."""
    global _BASE_SID_RE
    if _BASE_SID_RE is None:
        import re

        _BASE_SID_RE = re.compile(r"-w\d+$")
    return _BASE_SID_RE.sub("", source_id)


def merge_offsets(offsets: list[Any], *, source: str = "?") -> Any:
    """Merge the reader offset frontiers of several old-topology workers
    into one frontier the re-striped reader can ``seek`` to.

    Per-file progress maps (the FileReader/S3 shape: ``{path: [mtime,
    units]}``) union — stripes are disjoint, and on the rare overlap (a
    file reassigned mid-rescale) the entry with the larger trailing
    progress value wins.  Row-count frontiers (``{"rows": n}``) cannot be
    re-striped: they are only mergeable when a single old worker held one
    (the non-partitioned-source case, which reads on worker 0 under every
    topology).  Opaque non-dict offsets merge only when identical.
    Raises :class:`CheckpointError` on an unmergeable combination — the
    source then cannot rescale and the operator must intervene.
    """
    present = [o for o in offsets if o is not None]
    if not present:
        return None
    if len(present) == 1:
        return present[0]
    if all(isinstance(o, dict) for o in present):
        if any("rows" in o for o in present):
            rows = [o for o in present if "rows" in o]
            if len(rows) > 1:
                raise CheckpointError(
                    f"persistence: source {source!r} committed row-count "
                    f"offset frontiers on {len(rows)} old workers — "
                    "row-count frontiers cannot be re-striped across a "
                    "topology rescale (give the source an offset-aware "
                    "reader, or clear the persistence root)"
                )
        merged: dict = {}
        for off in present:
            for k, v in off.items():
                if k not in merged:
                    merged[k] = v
                    continue
                prev = merged[k]
                try:
                    # per-file progress entries are [mtime, units]: keep
                    # the one that consumed more
                    if (
                        isinstance(v, (list, tuple))
                        and isinstance(prev, (list, tuple))
                        and len(v) == len(prev) >= 1
                        and v[-1] > prev[-1]
                    ):
                        merged[k] = v
                except TypeError:
                    pass  # incomparable: first wins, deterministically
        return merged
    first = present[0]
    if all(o == first for o in present[1:]):
        return first
    raise CheckpointError(
        f"persistence: source {source!r} committed opaque offset frontiers "
        "that differ across old workers — this source cannot rescale "
        "(clear the persistence root to deliberately re-ingest)"
    )


def _retain_generations() -> int:
    """How many committed generations to keep (deferred GC window)."""
    from pathway_tpu_torch.internals.config import env_int

    return max(1, env_int("PATHWAY_CHECKPOINT_GENERATIONS"))


def _checkpoint_writers() -> int:
    """Background checkpoint writer threads; 0 = fully synchronous commits
    (the pre-pipelining inline path)."""
    from pathway_tpu_torch.internals.config import env_int

    return max(0, env_int("PATHWAY_CHECKPOINT_WRITERS"))


def _inflight_cap_bytes() -> int:
    """Backpressure bound: bytes of raw snapshot data the epoch thread may
    hand to the writer pool before it must stall and let uploads drain."""
    from pathway_tpu_torch.internals.config import env_int

    return max(1, env_int("PATHWAY_CHECKPOINT_INFLIGHT_MB")) << 20


def _publish_interval_s() -> float:
    """Minimum spacing between pipelined manifest publishes
    (``PATHWAY_CHECKPOINT_PUBLISH_INTERVAL_MS``, default 20): staged
    frontiers CONFLATE while the committer waits, so a tighter interval
    buys lower durability lag at the price of more manifest/fsync
    overhead per second.  0 publishes as fast as the store allows.
    Blocking commits (drains, finals) ignore it."""
    from pathway_tpu_torch.internals.config import env_float

    return max(0.0, env_float("PATHWAY_CHECKPOINT_PUBLISH_INTERVAL_MS")) / 1000.0


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _approx_row_size(row: tuple) -> int:
    """Cheap wire-size estimate of one event for admission-cap accounting
    (the exact size is only known after the pool encodes the batch).
    Bulk carriers must be counted at their real size — a 6 KB embedding
    charged as 16 bytes would let the writer pool admit ~100x the
    configured in-flight cap before backpressure ever engaged."""
    n = 48
    if row:
        for v in row:
            if isinstance(v, (str, bytes)):
                n += len(v) + 16
            elif v is None or isinstance(v, (int, float, bool)):
                n += 16
            elif isinstance(v, (tuple, list)):
                n += _approx_row_size(tuple(v))
            else:
                nbytes = getattr(v, "nbytes", None)  # ndarray-likes
                if nbytes is not None:
                    n += int(nbytes) + 16
                else:
                    # Json / wrapped / pickled objects encode to payloads
                    # proportional to their repr — charge that, not a flat
                    # 16 bytes, or bulk documents would sail past the cap
                    try:
                        n += len(str(v)) + 32
                    except Exception:  # noqa: BLE001 - estimate only
                        n += 256
    return n

# Filesystem root of the persistence backend of the currently-running
# pipeline (UDF DiskCache reads it; PersistenceMode::UdfCaching,
# src/connectors/mod.rs:114).  Context-local so concurrent runs in one
# process each see their own root (UDFs execute in the runner's context);
# the process-global fallback — for code that reads the root from a thread
# outside any run context — is first-wins and released only by its owner.
_root_var: ContextVar[str | None] = ContextVar("pathway_tpu_active_root", default=None)
_active_root: str | None = None
_root_owner: object | None = None
_root_lock = threading.Lock()


def acquire_active_root(root: str) -> tuple[object | None, object]:
    """Claim the UDF-cache root for the current run; returns a release token."""
    global _active_root, _root_owner
    var_token = _root_var.set(root)
    with _root_lock:
        if _active_root is None:
            _root_owner = object()
            _active_root = root
            return (_root_owner, var_token)
        return (None, var_token)


def release_active_root(token: tuple[object | None, object] | None) -> None:
    global _active_root, _root_owner
    if token is None:
        return
    owner, var_token = token
    _root_var.reset(var_token)
    if owner is None:
        return
    with _root_lock:
        if owner is _root_owner:
            _active_root = None
            _root_owner = None


def active_root() -> str | None:
    ctx = _root_var.get()
    return ctx if ctx is not None else _active_root


# ---------------------------------------------------------------------------
# Blob backends (backends/{file,memory,mock,s3}.rs)
# ---------------------------------------------------------------------------


class BlobBackend:
    """Key → bytes store; keys are slash-separated paths."""

    def describe(self) -> str:
        """Human-readable location of this store, for error messages."""
        return type(self).__name__

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def list_keys(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def put_atomic(self, key: str, data: bytes) -> None:
        self.put(key, data)

    def put_staged(self, key: str, data: bytes) -> None:
        """A put whose full durability may be DEFERRED to ``sync_staged``:
        the async commit pipeline stages many artifact writes and group-
        syncs them once at the commit barrier, before the manifest that
        references them publishes.  Stores whose ``put`` is already
        durable on return (object stores, memory) inherit this alias."""
        self.put(key, data)

    def sync_staged(self, keys: list[str]) -> None:
        """Make every prior ``put_staged`` of ``keys`` power-cut durable.
        Must complete before a manifest referencing them is published."""


def _fsync_dir(path: str) -> None:
    """Flush a directory's entries (new files, renames) to stable storage.

    Best-effort on filesystems that refuse O_DIRECTORY fsync (some network
    mounts): the entry write is then only as durable as the mount allows.
    """
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class FileBackend(BlobBackend):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def describe(self) -> str:
        return f"file://{os.path.abspath(self.root)}"

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/"))

    def put(self, key: str, data: bytes) -> None:
        # Durability contract: after put() returns, the chunk survives a
        # power-cut — the metadata commit (put_atomic) durably references
        # chunks, so chunks themselves must be durable first.  fsyncing the
        # FILE makes its bytes durable, but a newly-created directory ENTRY
        # lives in the parent directory: without fsyncing the dirfd a crash
        # can persist the metadata yet lose the chunk it points at.
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(os.path.dirname(path))

    def put_atomic(self, key: str, data: bytes) -> None:
        # Durability contract: the rename is the commit point — after
        # put_atomic() returns, a crash yields either the OLD or the NEW
        # content, never a torn file and never a lost rename.  The rename
        # itself is a parent-directory mutation, so the dirfd fsync below
        # is what makes the commit durable (fsyncing the file alone leaves
        # the rename in the page cache).  The staging name is per-process:
        # cluster-shared keys (the topology marker) are written by several
        # workers concurrently, and a shared ``.tmp`` would let one
        # writer's rename consume another's staging file mid-flight.
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path))
        # unlike the old fixed ".tmp" name, a per-pid staging file is
        # never reclaimed by the next writer of its key, so a crash
        # mid-put_atomic would leak it forever; opportunistically sweep
        # stale siblings (a live put_atomic stages and renames within
        # seconds — minutes-old staging files have no owner).  Supervised
        # restarts also settle *.tmp residue; this covers solo runs.
        self._sweep_stale_staging(os.path.dirname(path))

    @staticmethod
    def _sweep_stale_staging(dirname: str, *, max_age_s: float = 300.0) -> None:
        cutoff = _time.time() - max_age_s
        try:
            with os.scandir(dirname) as entries:
                for entry in entries:
                    if not entry.name.endswith(".tmp"):
                        continue
                    try:
                        if entry.stat().st_mtime < cutoff:
                            os.remove(entry.path)
                    except OSError:
                        pass
        except OSError:
            pass

    def put_staged(self, key: str, data: bytes) -> None:
        # file BYTES are made durable here (the writer pool spreads these
        # fsyncs across its threads, overlapped with epoch compute); the
        # parent-directory ENTRY is deferred to sync_staged, which the
        # commit barrier runs once per publish instead of once per chunk —
        # measured ~2x fewer fsync stalls on the upload path.  A/B against
        # deferring the file fsyncs too (write-only puts, batch fsync at
        # the barrier) showed the barrier then serializes the whole fsync
        # burst on the committer thread and loses ~15%.
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    def sync_staged(self, keys: list[str]) -> None:
        for dirname in {os.path.dirname(self._path(k)) for k in keys}:
            _fsync_dir(dirname)

    def get(self, key: str) -> bytes | None:
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def list_keys(self, prefix: str) -> list[str]:
        base = self._path(prefix)
        if not os.path.isdir(base):
            return []
        out = []
        for root, _dirs, files in os.walk(base):
            for f in files:
                if f.endswith(".tmp"):
                    continue
                full = os.path.join(root, f)
                rel = os.path.relpath(full, self.root)
                out.append(rel.replace(os.sep, "/"))
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except OSError:
            pass


class MemoryBackend(BlobBackend):
    """In-memory store; pass a shared dict to survive across runs in-process
    (Backend.mock semantics, persistence/__init__.py:71)."""

    def __init__(self, store: dict[str, bytes] | None = None):
        self.store: dict[str, bytes] = store if store is not None else {}
        self._lock = threading.Lock()

    def describe(self) -> str:
        return "memory"

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self.store[key] = data

    def get(self, key: str) -> bytes | None:
        with self._lock:
            return self.store.get(key)

    def list_keys(self, prefix: str) -> list[str]:
        with self._lock:
            return sorted(k for k in self.store if k.startswith(prefix))

    def delete(self, key: str) -> None:
        with self._lock:
            self.store.pop(key, None)


class _PrefixedObjectStore(BlobBackend):
    """Shared behavior for object-storage backends (S3, Azure, ...): prefix
    handling, 404 → None/no-op on get/delete, and the rule that a transient
    5xx/403 must NOT read as "no snapshot" (that would silently restart the
    pipeline from scratch).  Object PUTs are atomic per object on these
    stores, so ``put_atomic`` is plain ``put``.

    Transient errors (429 / 5xx / client-flagged ``is_transient``) are
    retried with the shared udfs exponential-backoff schedule, bounded by
    ``PATHWAY_BLOB_RETRIES`` (default 3; ``PATHWAY_BLOB_RETRY_INITIAL_MS``
    tunes the first delay).  Auth errors (403) and not-found are NEVER
    retried — a 403 is a configuration problem, and retrying it would only
    delay the operator-visible failure.

    Subclasses set ``_error_cls`` and implement ``_put/_get/_list/_delete``.
    """

    _error_cls: type[Exception] = Exception
    _TRANSIENT_STATUS = (429, 500, 502, 503, 504)

    def __init__(self, client: Any, prefix: str = ""):
        self.client = client
        self.prefix = prefix.strip("/")
        from pathway_tpu_torch.internals.config import env_int

        self.max_retries = max(0, env_int("PATHWAY_BLOB_RETRIES"))
        self.retry_initial_ms = max(1, env_int("PATHWAY_BLOB_RETRY_INITIAL_MS"))

    def _key(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def describe(self) -> str:
        name = type(self).__name__.removesuffix("Backend").lower()
        return f"{name}:{self.prefix}" if self.prefix else name

    @staticmethod
    def _is_not_found(exc: Exception) -> bool:
        # clients that distinguish auth-404s set is_not_found themselves
        return bool(
            getattr(exc, "is_not_found", getattr(exc, "status", 0) == 404)
        )

    def _is_transient(self, exc: Exception) -> bool:
        if not isinstance(exc, self._error_cls):
            return False
        if self._is_not_found(exc):
            return False
        return bool(getattr(exc, "is_transient", False)) or (
            getattr(exc, "status", None) in self._TRANSIENT_STATUS
        )

    def _with_retry(self, op: str, fn: Any, *args: Any) -> Any:
        """Run one store call, retrying transient errors with udfs backoff."""
        from pathway_tpu_torch.internals.udfs.retries import (
            ExponentialBackoffRetryStrategy,
        )

        delays = ExponentialBackoffRetryStrategy(
            max_retries=self.max_retries,
            initial_delay=self.retry_initial_ms,
            backoff_factor=2,
            jitter_ms=max(1, self.retry_initial_ms // 2),
        ).delays()
        attempt = 0
        while True:
            try:
                return fn(*args)
            except Exception as exc:
                if not self._is_transient(exc):
                    raise
                try:
                    delay = next(delays)
                except StopIteration:
                    raise exc  # retry budget exhausted: surface the error
                attempt += 1
                _log.warning(
                    "%s: transient %s error on %s (attempt %d/%d): %s — "
                    "retrying in %.2fs",
                    self.describe(), op, args[0] if args else "?",
                    attempt, self.max_retries, exc, delay,
                )
                _time.sleep(delay)

    def put(self, key: str, data: bytes) -> None:
        self._with_retry("put", self._put, self._key(key), data)

    def get(self, key: str) -> bytes | None:
        try:
            return self._with_retry("get", self._get, self._key(key))
        except Exception as exc:
            if isinstance(exc, self._error_cls) and self._is_not_found(exc):
                return None
            raise

    def list_keys(self, prefix: str) -> list[str]:
        full = self._key(prefix)
        strip = len(self.prefix) + 1 if self.prefix else 0
        return sorted(k[strip:] for k in self._with_retry("list", self._list, full))

    def delete(self, key: str) -> None:
        try:
            self._with_retry("delete", self._delete, self._key(key))
        except Exception as exc:
            if isinstance(exc, self._error_cls) and self._is_not_found(exc):
                return
            raise

    def _put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def _get(self, key: str) -> bytes:
        raise NotImplementedError

    def _list(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def _delete(self, key: str) -> None:
        raise NotImplementedError


class S3Backend(_PrefixedObjectStore):
    """Object-storage persistence (backends/s3.rs analog) over the signed
    REST client in ``io/_s3http.py`` — works against AWS S3 and any
    S3-compatible endpoint (MinIO)."""

    @property
    def _error_cls(self):
        from pathway_tpu_torch.io._s3http import S3Error

        return S3Error

    def _put(self, key: str, data: bytes) -> None:
        self.client.put_object(key, data)

    def _get(self, key: str) -> bytes:
        return self.client.get_object(key)

    def _list(self, prefix: str) -> list[str]:
        return [o["key"] for o in self.client.list_objects(prefix)]

    def _delete(self, key: str) -> None:
        self.client.delete_object(key)


class GcsBackend(_PrefixedObjectStore):
    """Google Cloud Storage persistence over the JSON-API client in
    ``io/_gcshttp.py`` — the natural store for TPU-pod deployments (ambient
    metadata-server identity, no key distribution)."""

    @property
    def _error_cls(self):
        from pathway_tpu_torch.io._gcshttp import GcsError

        return GcsError

    def _put(self, key: str, data: bytes) -> None:
        self.client.put_object(key, data)

    def _get(self, key: str) -> bytes:
        return self.client.get_object(key)

    def _list(self, prefix: str) -> list[str]:
        return self.client.list_objects(prefix)

    def _delete(self, key: str) -> None:
        self.client.delete_object(key)


class AzureBackend(_PrefixedObjectStore):
    """Azure Blob persistence over the SharedKey REST client in
    ``io/_azureblob.py``."""

    @property
    def _error_cls(self):
        from pathway_tpu_torch.io._azureblob import AzureBlobError

        return AzureBlobError

    def _put(self, key: str, data: bytes) -> None:
        self.client.put_blob(key, data)

    def _get(self, key: str) -> bytes:
        return self.client.get_blob(key)

    def _list(self, prefix: str) -> list[str]:
        return list(self.client.list_blobs(prefix))

    def _delete(self, key: str) -> None:
        self.client.delete_blob(key)


def _object_store_cfg(backend_cfg: Any) -> tuple[str, str, Any]:
    """``(bucket_or_container, prefix, client_or_None)`` from a Backend cfg.

    The root_path's ``scheme://bucket/prefix`` applies in BOTH construction
    modes — a pre-built client with a diverging root_path prefix would
    silently resume from a different object location.
    """
    path = getattr(backend_cfg, "path", "") or ""
    rest = path.split("://", 1)[-1]
    bucket, _, prefix = rest.partition("/")
    prefix = getattr(backend_cfg, "prefix", "") or prefix
    return bucket, prefix, getattr(backend_cfg, "client", None)


def backend_from_config(backend_cfg: Any) -> BlobBackend:
    """Build an engine backend from the user-facing ``pw.persistence.Backend``."""
    kind = getattr(backend_cfg, "kind", None)
    if kind == "filesystem":
        return FileBackend(backend_cfg.path)
    if kind == "mock":
        store = getattr(backend_cfg, "store", None)
        return MemoryBackend(store if isinstance(store, dict) else {})
    if kind == "s3":
        from pathway_tpu_torch.io._s3http import AwsS3Settings

        settings = getattr(backend_cfg, "bucket_settings", None) or AwsS3Settings()
        path = getattr(backend_cfg, "path", "") or ""
        if path.startswith("s3://"):
            rest = path[5:]
            bucket, _, prefix = rest.partition("/")
        else:
            bucket, prefix = settings.bucket_name, path
        return S3Backend(settings.client(bucket), prefix)
    if kind == "gcs":
        from pathway_tpu_torch.io._gcshttp import GcsClient

        bucket, prefix, client = _object_store_cfg(backend_cfg)
        if client is None:
            client = GcsClient(
                bucket,
                token_provider=getattr(backend_cfg, "token_provider", None),
                endpoint=getattr(backend_cfg, "endpoint", None),
            )
        return GcsBackend(client, prefix)
    if kind == "azure":
        from pathway_tpu_torch.io._azureblob import AzureBlobClient

        container, prefix, client = _object_store_cfg(backend_cfg)
        if client is None:
            acct = getattr(backend_cfg, "account", None) or {}
            client = AzureBlobClient(
                acct.get("account_name", ""),
                container,
                account_key=acct.get("account_key", ""),
                endpoint=acct.get("endpoint"),
            )
        return AzureBackend(client, prefix)
    raise ValueError(f"unknown persistence backend {backend_cfg!r}")


# ---------------------------------------------------------------------------
# Pipelined async commit: writer pool + commit barrier
# ---------------------------------------------------------------------------


class CommitMetrics:
    """Thread-safe commit-pipeline telemetry: per-stage timings
    (buffer/frame/hash/upload/barrier) and in-flight gauges.

    ``snapshot()`` feeds the telemetry sampler (``engine/telemetry.py``),
    so the async-commit win — and any backpressure stall — is measurable
    on a live pipeline, not only in benchmarks."""

    _STAGES = ("buffer", "frame", "hash", "upload", "barrier")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.stage_s: dict[str, float] = dict.fromkeys(self._STAGES, 0.0)
        self.artifacts = 0
        self.bytes_written = 0
        self.commits_published = 0
        self.commits_noop = 0
        self.backpressure_s = 0.0
        self.inflight_bytes = 0
        self.inflight_jobs = 0
        self.max_inflight_bytes = 0
        # deferred-GC health: sweeps run, artifacts actually deleted, and
        # sweeps deferred because the newest generation failed read-back
        self.gc_runs = 0
        self.gc_deleted = 0
        self.gc_deferred = 0

    def add_stage(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.stage_s[stage] += seconds

    def add_backpressure(self, seconds: float) -> None:
        with self._lock:
            self.backpressure_s += seconds

    def job_started(self, size: int) -> None:
        with self._lock:
            self.inflight_bytes += size
            self.inflight_jobs += 1
            if self.inflight_bytes > self.max_inflight_bytes:
                self.max_inflight_bytes = self.inflight_bytes

    def job_finished(self, size: int, *, ok: bool) -> None:
        with self._lock:
            self.inflight_bytes -= size
            self.inflight_jobs -= 1
            if ok:
                self.artifacts += 1
                self.bytes_written += size

    def commit_published(self, *, noop: bool) -> None:
        with self._lock:
            if noop:
                self.commits_noop += 1
            else:
                self.commits_published += 1

    def snapshot(self) -> dict[str, float]:
        """Gauge dict in telemetry metric-name form."""
        with self._lock:
            out = {
                f"checkpoint.commit.{stage}": value
                for stage, value in self.stage_s.items()
            }
            out["checkpoint.commit.backpressure"] = self.backpressure_s
            out["checkpoint.inflight.bytes"] = float(self.inflight_bytes)
            out["checkpoint.inflight.jobs"] = float(self.inflight_jobs)
            # the same in-flight state under the unified backlog.*
            # backpressure namespace (engine/freshness.py), so one view
            # ranks the commit pipeline against every other wait point
            out["backlog.checkpoint.bytes"] = float(self.inflight_bytes)
            out["backlog.checkpoint.jobs"] = float(self.inflight_jobs)
            out["checkpoint.inflight.bytes.max"] = float(self.max_inflight_bytes)
            out["checkpoint.artifacts"] = float(self.artifacts)
            out["checkpoint.bytes"] = float(self.bytes_written)
            out["checkpoint.commits"] = float(self.commits_published)
            out["checkpoint.commits.noop"] = float(self.commits_noop)
            out["checkpoint.gc.runs"] = float(self.gc_runs)
            out["checkpoint.gc.deleted"] = float(self.gc_deleted)
            out["checkpoint.gc.deferred"] = float(self.gc_deferred)
            return out

    def gc_run(self, *, deferred: bool, deleted: int = 0) -> None:
        with self._lock:
            self.gc_runs += 1
            self.gc_deleted += deleted
            if deferred:
                self.gc_deferred += 1


class _ArtifactJob:
    """Handle for one artifact write owned by the writer pool."""

    __slots__ = ("key", "size", "digest", "error", "_done")

    def __init__(self, key: str, size: int):
        self.key = key
        self.size = size
        self.digest: str | None = None
        self.error: BaseException | None = None
        self._done = threading.Event()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()


class _WriterPool:
    """Bounded background writers for checkpoint artifacts.

    ``submit`` takes ownership of the raw byte parts (zero-copy handoff —
    no ``b"".join`` on the caller's thread) and returns a job handle; a
    pool thread joins, frames, hashes and uploads.  Admission is bounded
    by ``cap_bytes`` of in-flight payload: once exceeded, ``submit``
    blocks — that stall IS the backpressure that keeps a slow store from
    buffering unbounded snapshot data in memory.

    Threads start lazily and exit after ``_IDLE_EXIT_S`` without work, so
    storages that never commit through the pool cost nothing.
    """

    _IDLE_EXIT_S = 10.0

    def __init__(
        self,
        backend: BlobBackend,
        metrics: CommitMetrics,
        *,
        worker: int = 0,
        writers: int = 2,
        cap_bytes: int = 256 << 20,
    ):
        self.backend = backend
        self.metrics = metrics
        self.worker = worker
        self.writers = max(1, writers)
        self.cap_bytes = cap_bytes
        self._cv = threading.Condition()
        self._queue: deque[tuple[_ArtifactJob, list[bytes], Any]] = deque()
        self._threads: list[threading.Thread] = []
        self._idle = 0
        self._inflight = 0  # admitted bytes, released at job completion
        # keys written via put_staged whose group sync is still owed; the
        # commit barrier drains this BEFORE any manifest publishes
        self._staged_keys: list[str] = []

    def submit(
        self,
        key: str,
        parts: list,
        *,
        encode: Callable[[list], bytes] | None = None,
        size_hint: int | None = None,
        sink: Callable[[str], None] | None = None,
    ) -> _ArtifactJob:
        """Queue one artifact write; ``sink(digest)`` runs on the pool
        thread after the upload succeeds, before the job reads done.

        ``parts`` is either byte chunks (joined on the pool) or, with
        ``encode``, raw items the pool encodes first — then ``size_hint``
        feeds the admission cap (accounting is symmetric on the hint, so
        an off estimate never leaks admitted bytes)."""
        size = sum(len(p) for p in parts) if size_hint is None else size_hint
        job = _ArtifactJob(key, size)
        t0 = _time.perf_counter()
        with self._cv:
            # backpressure: a single artifact may exceed the cap on an
            # empty pool (it must be writable at all), anything else waits
            while self._inflight > 0 and self._inflight + size > self.cap_bytes:
                self._cv.wait(0.05)
            waited = _time.perf_counter() - t0
            self._inflight += size
            # gauge BEFORE the job becomes poppable: a fast writer thread
            # could otherwise record job_finished first and drive the
            # exported in-flight gauges negative
            self.metrics.job_started(size)
            self._queue.append((job, parts, encode, sink))
            self._spawn_if_needed()
            self._cv.notify()
        if waited > 0.0005:
            self.metrics.add_backpressure(waited)
        return job

    def sync_staged_now(self) -> None:
        """Group-sync every staged artifact write (the deferred half of
        ``put_staged``).  Called at the commit barrier, strictly before a
        manifest publishes; a key staged concurrently with this call is
        synced by the next barrier, which necessarily precedes the first
        manifest that could reference it."""
        with self._cv:
            if not self._staged_keys:
                return
            keys = self._staged_keys
            self._staged_keys = []
        self.backend.sync_staged(keys)

    def _spawn_if_needed(self) -> None:  # call with self._cv held
        self._threads = [t for t in self._threads if t.is_alive()]
        if len(self._threads) < self.writers and len(self._queue) > self._idle:
            t = threading.Thread(
                target=self._run, daemon=True,
                name=f"pathway:ckpt-writer-{self.worker}",
            )
            t.start()
            self._threads.append(t)

    # pathway-lint: context=writer
    def _run(self) -> None:
        while True:
            with self._cv:
                deadline = _time.monotonic() + self._IDLE_EXIT_S
                while not self._queue:
                    self._idle += 1
                    try:
                        self._cv.wait(max(0.05, deadline - _time.monotonic()))
                    finally:
                        self._idle -= 1
                    if not self._queue and _time.monotonic() >= deadline:
                        # idle exit: DEREGISTER while still holding the cv,
                        # so a submit() racing this decision either enqueued
                        # before it (queue non-empty, no exit) or sees the
                        # pruned thread list and respawns — a job can never
                        # be orphaned behind a thread that decided to die
                        try:
                            self._threads.remove(threading.current_thread())
                        except ValueError:
                            pass
                        return
                job, parts, encode, sink = self._queue.popleft()
            self._execute(job, parts, encode, sink)
            with self._cv:
                self._inflight -= job.size
                self._cv.notify_all()
            self.metrics.job_finished(job.size, ok=job.error is None)
            job._done.set()

    def _execute(
        self, job: _ArtifactJob, parts: list, encode: Any, sink: Any
    ) -> None:
        try:
            t0 = _time.perf_counter()
            if encode is not None:
                data = encode(parts)
            else:
                data = parts[0] if len(parts) == 1 else b"".join(parts)
            t1 = _time.perf_counter()
            framed = codec.frame_blob(data)
            t2 = _time.perf_counter()
            digest = _sha256(framed)
            t3 = _time.perf_counter()
            # chaos hook: a writer_crash fault SIGKILLs here, mid-flight —
            # after hashing, before the upload — so the commit barrier
            # leaves the whole generation unreferenced (lazy import keeps
            # persistence ↔ faults acyclic at module load)
            from pathway_tpu_torch.engine import faults as _faults

            _faults.maybe_crash_writer(worker=self.worker, key=job.key)
            self.backend.put_staged(job.key, framed)
            t4 = _time.perf_counter()
            with self._cv:
                self._staged_keys.append(job.key)
            m = self.metrics
            m.add_stage("buffer", t1 - t0)
            m.add_stage("frame", t2 - t1)
            m.add_stage("hash", t3 - t2)
            m.add_stage("upload", t4 - t3)
            job.digest = digest
            if sink is not None:
                sink(digest)
        except BaseException as exc:  # noqa: BLE001 - surfaced at the barrier
            job.error = exc
            _log.warning(
                "persistence: async write of %s to %s failed: %s",
                job.key, self.backend.describe(), exc,
            )


class _PendingCommit:
    """One staged-but-unpublished generation awaiting its commit barrier.

    ``sources`` maps source id → (manifest meta without digests, log):
    chunk digests resolve on the writer pool, so the committer fills them
    in AFTER the barrier, when every referenced chunk has landed."""

    __slots__ = ("seq", "sources")

    def __init__(self, seq: int, sources: dict[str, tuple[dict, Any]]):
        self.seq = seq
        self.sources = sources


# ---------------------------------------------------------------------------
# Per-source snapshot log
# ---------------------------------------------------------------------------


class SnapshotLog:
    """Append-only event log for one persisted source (input_snapshot.rs).

    Chunks are written inside an integrity frame (``codec.frame_blob``) and
    their SHA-256 digests accumulate in ``chunk_digests`` so the commit can
    pin the exact chunk contents into the generation manifest.  A ``None``
    digest marks a chunk written before framing existed (legacy store):
    it is read permissively but cannot be deep-verified.
    """

    def __init__(
        self,
        backend: BlobBackend,
        worker: int,
        source_id: str,
        *,
        pool: _WriterPool | None = None,
    ):
        self.backend = backend
        self.pool = pool
        self.prefix = f"snapshots/{worker}/{source_id}"
        self.chunks_written = 0
        self.chunk_digests: list[str | None] = []
        # sync mode: encoded event bytes; async mode: raw event tuples
        # (kind, key, row, time) encoded on the pool at flush
        self._buffer: list = []
        self._buffer_bytes = 0  # admission-cap estimate of the raw buffer
        # chunk index → in-flight pool job; reaped by barrier()
        self._inflight: dict[int, _ArtifactJob] = {}

    def record(self, key: int, row: tuple, diff: int) -> None:
        kind = codec.EV_INSERT if diff > 0 else codec.EV_DELETE
        if self.pool is not None:
            # raw-event handoff: the ~12 µs/row event encode runs on the
            # writer pool at flush, not here on the epoch thread; only a
            # cheap size estimate (admission-cap accounting) is paid inline
            ev = (kind, key, row, 0)
            size = _approx_row_size(row)
            for _ in range(abs(diff)):
                self._buffer.append(ev)
                self._buffer_bytes += size
        else:
            for _ in range(abs(diff)):
                self._buffer.append(codec.encode_event(kind, key, row))

    def record_advance(self, time: int) -> None:
        if self.pool is not None:
            self._buffer.append((codec.EV_ADVANCE_TIME, 0, (), time))
            self._buffer_bytes += 16
        else:
            self._buffer.append(
                codec.encode_event(codec.EV_ADVANCE_TIME, time=time)
            )

    @staticmethod
    def _encode_events(events: list[tuple]) -> bytes:
        """Encode a raw-event batch into chunk payload bytes (pool-side)."""
        return codec.encode_events(events)

    def flush_chunk(self) -> None:
        if not self._buffer:
            return
        index = self.chunks_written
        # keep digests index-aligned: a fallback resume overwrites orphaned
        # chunks above the committed prefix, so truncate before appending
        del self.chunk_digests[index:]
        key = f"{self.prefix}/{index:08d}"
        if self.pool is not None:
            # zero-copy handoff: the pool takes ownership of the raw event
            # batch — encode/join/frame/hash/upload all run off this
            # thread; the digest placeholder resolves via the sink before
            # the job reads done, so any barrier observing the job sees it
            parts = self._buffer
            self._buffer = []
            size_hint = self._buffer_bytes
            self._buffer_bytes = 0
            self.chunk_digests.append(None)
            self._inflight[index] = self.pool.submit(
                key, parts,
                encode=self._encode_events,
                size_hint=size_hint,
                sink=lambda digest, i=index: self._resolve_digest(i, digest),
            )
        else:
            framed = codec.frame_blob(b"".join(self._buffer))
            self._buffer.clear()
            self.backend.put(key, framed)
            self.chunk_digests.append(_sha256(framed))
        self.chunks_written = index + 1

    def _resolve_digest(self, index: int, digest: str) -> None:
        self.chunk_digests[index] = digest

    def barrier(self, committed: int) -> None:
        """Block until every in-flight chunk below ``committed`` is durably
        on the store (the per-log half of the commit barrier).  Raises
        :class:`CheckpointError` on the first failed write — the failed job
        stays registered so every later commit referencing that chunk fails
        too, instead of publishing a manifest that pins a missing chunk."""
        # list(dict) is a single C-level snapshot: the epoch thread's
        # flush_chunk inserts into _inflight concurrently, and iterating
        # the live dict here would intermittently raise RuntimeError
        for index in sorted(i for i in list(self._inflight) if i < committed):
            job = self._inflight[index]
            job.wait()
            if job.error is not None:
                raise CheckpointError(
                    f"persistence: async write of chunk {index} of "
                    f"{self.prefix} to backend {self.backend.describe()} "
                    f"failed: {job.error}"
                ) from job.error
            del self._inflight[index]

    def _chunk_context(self, i: int, generation: int) -> str:
        return (
            f"chunk {i} of {self.prefix} (generation {generation}) "
            f"in backend {self.backend.describe()}"
        )

    def read_committed(
        self,
        committed_chunks: int,
        *,
        start: int = 0,
        generation: int = 0,
        digests: list[str | None] | None = None,
        verified: set[str] | None = None,
    ):
        """Yield (kind, key, row, time) from chunks [start, committed_chunks).

        Errors name the backend, the source log prefix and the generation,
        so an operator can locate the damaged artifact directly.

        ``start`` — the first chunk index belonging to this log's own
        range (``SourceState.chunk_start``): a log re-seeded by a topology
        rescale appends ABOVE the superseded topology's committed chunks,
        whose rows are covered by the manifest's ``refs`` instead.

        ``verified`` — the storage's process-lifetime artifact cache: a
        chunk whose ``key:digest`` token is present was already digest-
        verified this process (by ``_load_state``), so replay skips
        re-hashing it; resume then hashes each chunk once, not twice.
        """
        yield from _read_chunks(
            self.backend,
            self.prefix,
            start,
            committed_chunks,
            digests,
            digests_base=0,
            generation=generation,
            verified=verified,
        )


def _read_chunks(
    backend: BlobBackend,
    prefix: str,
    start: int,
    end: int,
    digests: list[str | None] | None,
    *,
    digests_base: int = 0,
    generation: int = 0,
    verified: set[str] | None = None,
):
    """Yield decoded events from chunks ``[start, end)`` of one log prefix.

    The single chunk-read path shared by own-log replay
    (:meth:`SnapshotLog.read_committed`) and cross-worker ``refs`` replay
    after a topology rescale, so integrity handling cannot drift between
    them.  ``digests[i - digests_base]`` pins chunk ``i`` (manifest ref
    entries store digests relative to their own ``start``)."""

    def context(i: int) -> str:
        return (
            f"chunk {i} of {prefix} (generation {generation}) "
            f"in backend {backend.describe()}"
        )

    for i in range(start, end):
        key = f"{prefix}/{i:08d}"
        data = backend.get(key)
        if data is None:
            raise CheckpointError(
                "persistence: missing committed " + context(i)
            )
        j = i - digests_base
        digest = (
            digests[j] if digests is not None and 0 <= j < len(digests) else None
        )
        if (
            digest is not None
            and (verified is None or f"{key}:{digest}" not in verified)
            and _sha256(data) != digest
        ):
            raise CheckpointError(
                "persistence: digest mismatch on committed " + context(i)
            )
        try:
            payload = codec.unframe_blob(
                data,
                what=key,
                allow_legacy=digest is None,
                # a matched SHA-256 digest subsumes the frame CRC
                verify_crc=digest is None,
            )
        except codec.IntegrityError as exc:
            raise CheckpointError(
                f"persistence: corrupt committed {context(i)}: {exc}"
            ) from exc
        try:
            yield from codec.decode_events(payload)
        except ValueError as exc:
            # legacy (digest-less) chunks can rot undetected by any
            # frame; surface decode failures with the same locator
            # context as frame/digest failures
            raise CheckpointError(
                f"persistence: undecodable events in committed "
                f"{context(i)}: {exc}"
            ) from exc


# ---------------------------------------------------------------------------
# Worker storage tracker (tracker.rs WorkerPersistentStorage)
# ---------------------------------------------------------------------------


class SourceState:
    def __init__(self, log: SnapshotLog, committed_chunks: int, offset: Any):
        self.log = log
        self.committed_chunks = committed_chunks
        self.offset = offset  # opaque reader frontier
        self.pending_offset: Any = offset
        self.schema_digest: str | None = None
        # operator-persisting mode: no input event log; offsets commit only
        # once the epoch their rows were staged into has been PROCESSED —
        # operator snapshots cover processed epochs, so an offset past an
        # unprocessed row would lose it on crash
        self.operator_mode = False
        self.pending_offsets: list[tuple[Any, int]] = []  # (offset, epoch)
        # high-water mark of auto-generated row keys: resumed runs continue
        # the sequence so fresh rows never collide with keys that already
        # live inside restored operator state / replayed snapshots
        self.key_seq = 0
        # elastic-rescale state (engine-wide design: docs/fault_tolerance.md
        # "Elastic rescale"): chunk_start is the first chunk index of this
        # log's OWN range — a rescale re-seeds the log above the superseded
        # topology's committed chunks so they are never clobbered; refs are
        # pinned references {worker, source, start, chunks, chunk_digests}
        # to committed chunk ranges of OTHER (old-topology) logs, replayed
        # filtered by shard_to_worker(key, current_topology) and carried
        # forward in every manifest so the scheme composes across chained
        # rescales
        self.chunk_start = 0
        self.refs: list[dict] = []
        # the BASE (worker-suffix-free) source name, recorded in every
        # manifest so rescale matching never has to guess whether a
        # trailing ``-w<N>`` was appended by the engine or is part of the
        # user's own name
        self.base: str | None = None


class PersistentStorage:
    """Coordinates snapshot logs + the consistent-metadata commit for a worker."""

    def __init__(
        self,
        backend: BlobBackend,
        *,
        worker: int = 0,
        snapshot_interval_ms: int = 0,
        mode: Any = None,
    ):
        self.backend = backend
        self.worker = worker
        self.snapshot_interval_ms = snapshot_interval_ms
        self.mode = mode
        self.sources: dict[str, SourceState] = {}
        self.retain_generations = _retain_generations()
        # the cluster incarnation this writer belongs to (0 = unleased solo
        # run, fencing disabled).  Every commit-point write re-checks the
        # on-root lease against it — see FencedError.
        self.incarnation = writer_incarnation()
        # this writer's per-worker fence token (warm-standby promotion):
        # a promoted standby carries the token bump_worker_fence() minted
        # when its predecessor died; the predecessor's zombie writes carry
        # the older token and are rejected at their next commit point
        self.worker_fence = _worker_fence()
        # generational recovery state, filled by _load_state(): the adopted
        # (verified) generation, the generations rejected on the way down,
        # and whether we resumed from a pre-manifest legacy metadata file
        self.generation = 0
        self.recovered_generation = 0
        self.rejected_generations: list[tuple[int, str]] = []
        self.legacy_resume = False
        # artifacts (chunks, operator dumps) that already passed digest +
        # frame verification this process-lifetime; they are immutable once
        # written, so GC's pre-delete re-verification only pays for the
        # delta since the last check
        self._verified_artifacts: set[str] = set()
        # pipelined commit state: the bounded writer pool (None = fully
        # synchronous commits), the queue of staged-but-unpublished
        # generations, the committer thread publishing them in order, and
        # the sticky first async failure (surfaced on the next
        # commit/commit_async/drain call)
        self.metrics = CommitMetrics()
        # the commit-pipeline gauges ride the unified registry too, so the
        # /metrics scrape and OTLP export see them without runner plumbing;
        # WeakMethod registration means a dead storage drops out on its own
        _registry.get_registry().register_collector(
            f"persistence.worker{worker}", self.metrics.snapshot
        )
        # per-publish wall time on ms-scale bounds: the quantile estimates
        # (commit.duration.ms.p95 etc., engine/metrics.py) need buckets
        # that resolve the 0.1-100 ms publishes the pipelined committer
        # actually produces
        self._commit_hist = _registry.get_registry().histogram(
            "commit.duration.ms",
            "wall time of one generation-manifest publish (ms)",
            buckets=_registry.MS_BUCKETS,
            worker=worker,
        )
        writers = _checkpoint_writers()
        self._pool: _WriterPool | None = (
            _WriterPool(
                backend, self.metrics, worker=worker, writers=writers,
                cap_bytes=_inflight_cap_bytes(),
            )
            if writers > 0
            else None
        )
        self._pending: deque[_PendingCommit] = deque()
        self._pending_active = False
        self._pending_cv = threading.Condition()
        self._committer: threading.Thread | None = None
        self._async_error: BaseException | None = None
        self._last_submit_sig: Any = None
        # monotonically increasing durability counter: bumped when a staged
        # frontier becomes durable (manifest published, or confirmed no-op).
        # The runner acks broker offsets on THIS advancing, never on
        # commit_async returning — an async snapshot is not yet durable.
        self.published_seq = 0
        self._seq = 0
        # rate limiters for the BEST-EFFORT halves of a publish — the
        # advisory pointer refresh and the GC sweep.  Pipelined publishes
        # run at epoch cadence; paying 4+ fsyncs of advisory work per
        # generation would put the durability tax right back.  Sync
        # commits (drains, finals, direct callers) always do both.
        self._last_pointer_refresh = 0.0
        self._last_gc = 0.0
        self._publish_interval = _publish_interval_s()
        self._last_publish = 0.0
        # PersistenceMode::OperatorPersisting (mod.rs:108-116): persist
        # operator arrangements instead of input event logs, so resume is
        # O(state) not O(history)
        self.operator_persistence = (
            getattr(mode, "name", None) == "OPERATOR_PERSISTING"
        )
        # incremental GC indexes: this worker shard has exactly one writer
        # (this storage), so the manifest/operator key sets can be
        # maintained in memory after ONE full listing instead of walking
        # the whole persistence root on every published generation.
        # _known_generations seeds from _load_state()'s existing listing;
        # _op_index stays None until the first operator GC pays its single
        # full walk (catching residue from prior runs), then is O(delta).
        self._known_generations: set[int] = set()
        self._op_index: set[str] | None = None
        # elastic rescale: the topology (worker count) THIS process runs
        # under; _load_state compares it against the topology stamped on
        # the root's newest manifests and, on mismatch, enters repartition
        # resume — gathering every old worker's newest verified generation
        # into per-base-source refs replayed by shard range.
        self.topology = max(1, _cluster_processes())
        # the topology EPOCH this storage runs in (see TOPOLOGY_KEY):
        # incremented by every rescale, stamped into every manifest, and
        # the staleness test for shards whose stamped worker count
        # coincidentally matches the current one
        self.topology_seq = 0
        self.repartitioned_from: int | None = None
        # live shard handoff: once this storage has drained its handoff
        # commit (stamped handoff_to), it is FENCED — later commits no-op
        # (returning the already-durable seq) so the shutdown path's final
        # commit cannot advance the frontier past what the acks recorded
        self.handoff_fenced = False
        self.handoff_to: int | None = None
        # base source name -> {"offset", "key_seq", "schema", "refs",
        # "own_chunks"} gathered from the superseded topology's manifests;
        # None outside repartition resume
        self._repartition: dict[str, dict] | None = None
        self._metadata = self._load_state()
        self.replayed_rows = 0
        if (
            self.operator_persistence
            and self.rejected_generations
            and _cluster_processes() > 1
        ):
            # input-log mode tolerates one worker falling back further than
            # its peers (all state recomputes from replayed + re-read
            # input), but restored OPERATOR state on the peers already
            # contains the deltas this worker would re-send — the group
            # would double-apply them.  There is no cross-worker generation
            # consensus yet, so refuse rather than corrupt.
            raise CheckpointError(
                f"persistence: worker {self.worker} fell back past damaged "
                f"generation(s) {[g for g, _ in self.rejected_generations]} "
                "in operator-persisting mode, but the other workers of the "
                "group may hold newer operator state — divergent rollback "
                "would double-apply exchanged deltas. Repair the damaged "
                "generation (see `python -m pathway_tpu_torch.cli scrub`) or clear every "
                "worker's shard to restart the group consistently."
            )
        # fast-fail for zombies: a stale-incarnation worker must not even
        # resume (its replay would feed a run whose every publish will be
        # rejected anyway) — cheap, because the lease is one tiny read
        self._check_fence("resume from")
        self._op_gen = int(self._metadata.get("operators", {}).get("gen", 0))
        # set by the runner: returns {node_id: bytes} of dirty operator
        # states + the graph digest, collected at commit time; confirm is
        # invoked only after the referencing metadata write succeeds
        self.collect_operator_states: Any = None
        self.confirm_operator_commit: Any = None
        # record/replay mode (PATHWAY_SNAPSHOT_ACCESS): None = both
        # directions (ordinary persistence), "record" = write-only,
        # "replay" = read snapshots; continue_after_replay then decides
        # whether live connector data follows the replayed prefix
        self.snapshot_access: str | None = None
        self.continue_after_replay = True

    # -- incarnation fencing --
    def _check_fence(self, what: str) -> None:
        """Refuse ``what`` when the root's lease shows a newer incarnation.

        Called immediately before every commit-point write.  One tiny
        lease read per publish (publishes are already rate-limited); a
        missing or unreadable lease never fences — fencing is only as
        strong as the supervisor that maintains the lease, and a solo run
        (incarnation 0) skips the check entirely."""
        if self.incarnation <= 0:
            return
        lease = read_lease(self.backend)
        if lease is None:
            return
        if lease["incarnation"] > self.incarnation:
            _registry.get_registry().counter(
                "persistence.fenced",
                "commit-point writes rejected because a newer incarnation "
                "owns the root",
                worker=self.worker,
            ).inc()
            _blackbox.record(
                "persistence.fenced", worker=self.worker, what=what,
                incarnation=self.incarnation, lease=lease["incarnation"],
            )
            raise FencedError(
                f"persistence: worker {self.worker} of incarnation "
                f"{self.incarnation} is fenced off {self.backend.describe()}: "
                f"the lease shows incarnation {lease['incarnation']} — a "
                f"newer cluster incarnation owns this root; refusing to "
                f"{what} (this process is a zombie from a superseded restart "
                "attempt and must terminate)"
            )
        # per-worker fence (same incarnation): a warm-standby promotion
        # fenced this worker id specifically — bump_worker_fence() minted
        # a newer token for the promoted standby, and any writer still
        # carrying the older token is the dead worker's zombie
        fences = lease.get("fences") or {}
        fence = fences.get(str(self.worker), 0)
        if isinstance(fence, int) and fence > self.worker_fence:
            _registry.get_registry().counter(
                "persistence.fenced",
                "commit-point writes rejected because a newer incarnation "
                "owns the root",
                worker=self.worker,
            ).inc()
            _blackbox.record(
                "persistence.fenced", worker=self.worker, what=what,
                incarnation=self.incarnation, worker_fence=self.worker_fence,
                lease_fence=fence,
            )
            raise FencedError(
                f"persistence: worker {self.worker} (fence token "
                f"{self.worker_fence}) is fenced off "
                f"{self.backend.describe()}: the lease carries per-worker "
                f"fence {fence} — a standby was promoted into this worker "
                f"id; refusing to {what} (this process is the dead "
                "worker's zombie and must terminate)"
            )

    def fence_for_handoff(self, to_workers: int) -> None:
        """Enter the handoff fence: the NEXT commit is the handoff commit
        (stamped ``handoff_to``), every commit after it silently no-ops.

        Called by the runner immediately before its handoff drain commit;
        the fence guarantees the frontier recorded in the ack files is
        exactly the frontier the successor topology replays — nothing the
        shutdown path does afterwards can move it."""
        self.handoff_to = to_workers

    def _seal_handoff_fence(self) -> None:
        if self.handoff_to is not None:
            self.handoff_fenced = True

    def _zombie_stall(self, spec: Any) -> None:
        """The ``zombie`` fault: wedge this publish until the lease shows a
        NEWER incarnation — the deterministic re-creation of a stale writer
        whose in-flight publish lands after the respawned cluster took
        over.  The fence check that follows must then reject it.  Bounded
        (``delay_ms``, default 30 s) so a mis-set plan cannot hang a run
        forever; gating is on on-disk lease state, never on timing."""
        deadline = _time.monotonic() + (
            float(spec.delay_ms) / 1000.0 if spec.delay_ms else 30.0
        )
        while _time.monotonic() < deadline:
            lease = read_lease(self.backend)
            if lease is not None and lease["incarnation"] > self.incarnation:
                return
            _time.sleep(0.02)

    # -- metadata / manifests --
    def _meta_key(self) -> str:
        return f"{METADATA_FILE}.{self.worker}"

    def _manifest_prefix(self) -> str:
        return f"manifests/{self.worker}/"

    def _manifest_key(self, generation: int) -> str:
        return f"{self._manifest_prefix()}{generation:08d}"

    def _list_generations(self) -> dict[int, str]:
        """{generation: manifest key} for every manifest blob on the store."""
        out: dict[int, str] = {}
        for key in self.backend.list_keys(self._manifest_prefix()):
            tail = key.rsplit("/", 1)[-1]
            if tail.isdigit():
                out[int(tail)] = key
        return out

    def _scan_root_manifests(self) -> dict[int, list[tuple[int, str]]]:
        """{worker: [(generation, key) newest-first]} for EVERY manifest on
        the root — the cross-worker view a topology-rescale resume (and
        orphan-topology GC) reads.  One listing; the common same-topology
        resume never calls this."""
        out: dict[int, list[tuple[int, str]]] = {}
        for key in self.backend.list_keys("manifests/"):
            parts = key.split("/")
            if len(parts) == 3 and parts[1].isdigit() and parts[2].isdigit():
                out.setdefault(int(parts[1]), []).append((int(parts[2]), key))
        for entries in out.values():
            entries.sort(reverse=True)
        return out

    def _write_topology_marker(self, marker: dict | None) -> None:
        """Publish (or refresh) the root's topology-epoch marker for the
        epoch this repartition opened.  Idempotent across the workers of
        one rescale: they all compute the same (seq, workers) and the
        write is a whole-blob atomic put."""
        if (
            marker is not None
            and marker.get("workers") == self.topology
            and marker.get("seq") == self.topology_seq
        ):
            return
        payload = {
            "format": TOPOLOGY_FORMAT,
            "seq": self.topology_seq,
            "workers": self.topology,
            "from_workers": self.repartitioned_from,
            "at": _time.time(),
        }
        self.backend.put_atomic(
            TOPOLOGY_KEY, codec.frame_blob(_json.dumps(payload).encode())
        )

    def _gather_repartition(
        self,
        root: dict[int, list[tuple[int, str]]],
        own_adopted: dict | None,
        *,
        seq: int,
    ) -> dict[str, dict]:
        """Gather the superseded topology's committed state into per-base
        repartition metadata: for every worker prefix on the root, adopt
        its newest fully verified generation, flatten its sources' own
        chunk ranges and carried ``refs`` into one deduplicated ref set per
        BASE source name, and merge the reader offset frontiers.

        A converged worker (manifest already stamped with the CURRENT
        topology — the mixed state a crash mid-rescale leaves) contributes
        only its carried refs: its own post-rescale chunks are replayed by
        that worker itself, unfiltered, and re-routed by the exchange.  An
        unconverged or orphaned worker's own range becomes a ref, replayed
        by every new worker filtered to its shard.  Refs dedup by
        ``(worker, source, start)`` and a containment filter — the same
        old range reached through several manifests must replay once,
        while DISJOINT sub-ranges of one log (a carried ref covering the
        original epoch plus the own range a later epoch appended above
        it) must each survive."""
        if self.operator_persistence:
            raise CheckpointError(
                f"persistence: worker {self.worker} found checkpoints "
                f"written under a different worker topology in backend "
                f"{self.backend.describe()}, but operator-persisting "
                "snapshots are opaque per-node state and cannot be "
                "re-partitioned by shard range. Resume at the original "
                "worker count, or clear the persistence root to start "
                "fresh."
            )
        bases: dict[str, dict] = {}
        refs_seen: dict[tuple[str, int, str, int], dict] = {}
        for w in sorted(root):
            if w == self.worker:
                adopted = own_adopted  # already verified (or absent)
            else:
                adopted = None
                for gen, key in root[w]:
                    manifest, reason = _read_manifest(self.backend, key)
                    if manifest is None:
                        self.rejected_generations.append(
                            (gen, f"worker {w}: {reason or 'unreadable'}")
                        )
                        continue
                    problems = verify_manifest(
                        self.backend, w, manifest,
                        cache=self._verified_artifacts,
                    )
                    if problems:
                        self.rejected_generations.append(
                            (gen, f"worker {w}: " + "; ".join(problems[:3]))
                        )
                        continue
                    adopted = manifest
                    break
            if adopted is None and root[w]:
                # symmetric for every shard, our own included: a worker
                # whose generations all failed verification cannot be
                # silently dropped from the repartition
                raise CheckpointError(
                    f"persistence: topology rescale needs worker {w}'s "
                    f"committed state, but none of its {len(root[w])} "
                    f"generation(s) in backend {self.backend.describe()} "
                    "verified — refusing to repartition with data loss "
                    "(run `python -m pathway_tpu_torch.cli scrub` to inspect the damage)"
                )
            if adopted is None:
                continue
            m_top = adopted.get("topology")
            # converged = already republished in the epoch being joined:
            # that worker replays its own post-rescale chunks itself.  A
            # NEW rescale (seq above every stamp) converges nothing.
            converged = (
                isinstance(m_top, int)
                and m_top == self.topology
                and int(adopted.get("topology_seq", 0)) == seq
            )
            for sid, meta in (adopted.get("sources") or {}).items():
                # the recorded base name is authoritative (a user-chosen
                # name may itself end in -w<N>); the strip heuristic only
                # covers manifests written before base recording
                base = meta.get("base") or base_source_id(sid)
                entry = bases.setdefault(
                    base,
                    {"offsets": [], "key_seq": 0, "schema": None, "own": {}},
                )
                entry["offsets"].append(_offset_from_json(meta.get("offset")))
                if entry["schema"] is None and meta.get("schema") is not None:
                    entry["schema"] = meta["schema"]
                start = int(meta.get("chunk_start", 0))
                chunks = int(meta.get("chunks", 0))
                if w == self.worker:
                    entry["key_seq"] = max(
                        entry["key_seq"], int(meta.get("key_seq", 0))
                    )
                    entry["own"][sid] = chunks
                candidates = list(meta.get("refs") or [])
                if not converged and chunks > start:
                    candidates.append(
                        {
                            "worker": w,
                            "source": sid,
                            "start": start,
                            "chunks": chunks,
                            "chunk_digests": list(
                                meta.get("chunk_digests") or []
                            ),
                        }
                    )
                for ref in candidates:
                    rkey = (
                        base,
                        int(ref["worker"]),
                        str(ref["source"]),
                        int(ref.get("start", 0)),
                    )
                    prev = refs_seen.get(rkey)
                    if prev is None or int(ref["chunks"]) > int(prev["chunks"]):
                        refs_seen[rkey] = dict(ref)
        for base, entry in bases.items():
            # per-log range filter: ranges of one (worker, source) log are
            # generated start-monotone across epochs, so any two are
            # disjoint or nested — keep every range not fully covered by
            # an already-kept one (dedup), never conflate disjoint ones
            groups: dict[tuple[int, str], list[dict]] = {}
            for (b, w, s, _start), ref in refs_seen.items():
                if b == base:
                    groups.setdefault((w, s), []).append(ref)
            refs: list[dict] = []
            for w, s in sorted(groups):
                ranges = sorted(
                    groups[(w, s)],
                    key=lambda r: (int(r.get("start", 0)), -int(r["chunks"])),
                )
                kept: list[dict] = []
                for ref in ranges:
                    rs, rc = int(ref.get("start", 0)), int(ref["chunks"])
                    if any(
                        int(k.get("start", 0)) <= rs and int(k["chunks"]) >= rc
                        for k in kept
                    ):
                        continue
                    kept.append(ref)
                refs.extend(kept)
            entry["refs"] = refs
            entry["offset"] = merge_offsets(entry.pop("offsets"), source=base)
        return bases

    def _load_state(self) -> dict:
        """Adopt the newest FULLY VERIFIED generation, falling back
        generation-by-generation past damaged ones (torn manifest, missing
        or corrupt chunk, digest mismatch).  Raises :class:`CheckpointError`
        when generations exist but none verifies — silently starting fresh
        would break exactly-once for sources with externally committed
        offsets.  The one full manifest listing here also seeds the
        in-memory generation index incremental GC runs against.

        When the adopted manifest (or the rest of the root) was written
        under a DIFFERENT worker topology than this process runs in, the
        resume becomes a **repartition resume**: the committed state of
        every old worker is gathered into shard-filtered ``refs``
        (:meth:`_gather_repartition`) and this worker starts a fresh
        metadata lineage that republishes under the new topology.

        Verification reads every chunk of the candidate generation BEFORE
        adoption, and replay later re-fetches them (the verified-artifact
        cache skips the re-hash, not the re-read): falling back is only
        possible while nothing has been replayed into live input sessions
        yet, so the doubled read is the price of never adopting a
        generation that cannot be fully restored."""
        gens = self._list_generations()
        self._known_generations = set(gens)
        adopted: dict | None = None
        adopted_gen = 0
        for gen in sorted(gens, reverse=True):
            manifest, reason = _read_manifest(self.backend, gens[gen])
            if manifest is None:
                self.rejected_generations.append((gen, reason or "unreadable"))
                continue
            problems = verify_manifest(
                self.backend, self.worker, manifest,
                cache=self._verified_artifacts,
            )
            if problems:
                self.rejected_generations.append(
                    (gen, "; ".join(problems[:3]))
                )
                continue
            adopted, adopted_gen = manifest, gen
            break
        # -- elastic rescale detection ---------------------------------
        own_topo = adopted.get("topology") if adopted is not None else None
        own_seq = (
            int(adopted.get("topology_seq", 0)) if adopted is not None else 0
        )
        marker = read_topology_marker(self.backend)
        repartition_from: int | None = None
        new_seq = 0
        root_manifests: dict[int, list[tuple[int, str]]] = {}
        if marker is not None:
            self.topology_seq = int(marker["seq"])
            if marker["workers"] != self.topology:
                # a NEW rescale of a root that has rescaled before: open
                # the next topology epoch
                repartition_from = int(marker["workers"])
                new_seq = int(marker["seq"]) + 1
            elif (
                adopted is None
                or own_topo != self.topology
                or own_seq != int(marker["seq"])
            ):
                # this shard is STALE for the current epoch (it crashed
                # mid-rescale, or its stamped worker count only
                # coincidentally matches after a round trip) — or absent
                # entirely: re-join the current epoch by gathering refs
                root_manifests = self._scan_root_manifests()
                repartition_from = (
                    own_topo
                    if isinstance(own_topo, int)
                    and own_topo != self.topology
                    else int(marker.get("from_workers") or marker["workers"])
                )
                new_seq = int(marker["seq"])
        elif adopted is None or not isinstance(own_topo, int) or (
            own_topo != self.topology
        ):
            root_manifests = self._scan_root_manifests()
            if isinstance(own_topo, int) and own_topo != self.topology:
                repartition_from = own_topo
            else:
                orphans = [w for w in root_manifests if w >= self.topology]
                stamp = None
                if adopted is None:
                    # no committed state of our own: a rescale is still
                    # recognizable from the peers' topology stamps
                    for w in sorted(root_manifests):
                        if w == self.worker:
                            continue
                        for _gen, key in root_manifests[w]:
                            m, _r = _read_manifest(self.backend, key)
                            if m is None:
                                continue
                            t = m.get("topology")
                            if isinstance(t, int):
                                stamp = t
                            break
                        if stamp is not None:
                            break
                if stamp is not None and stamp != self.topology:
                    repartition_from = stamp
                elif orphans:
                    # worker prefixes outside the current topology: the
                    # root was written by a larger (possibly pre-stamp)
                    # cluster — their shards must be re-partitioned, not
                    # silently dropped
                    repartition_from = max(orphans) + 1
            if repartition_from is not None:
                new_seq = 1  # the root's first rescale opens epoch 1
            elif (
                adopted is not None
                and not isinstance(own_topo, int)
                and self.topology > 1
            ):
                # a pre-topology-stamp root resumed multi-worker: a GROW
                # of such a root is undetectable (stamps are what make the
                # old stripe layout provable), so it would resume
                # mis-striped silently.  We cannot distinguish it from a
                # legitimate same-count resume — warn loudly instead of
                # breaking legacy roots.
                _log.warning(
                    "persistence: worker %d resumes a legacy checkpoint "
                    "root (no topology stamps) under %d workers — if this "
                    "root was written by a DIFFERENT worker count, the "
                    "resume is mis-striped; legacy roots can only be "
                    "resumed at their original count (this run's commits "
                    "add the stamps that make future rescales safe)",
                    self.worker, self.topology,
                )
        if repartition_from is not None:
            # a zombie from a superseded incarnation must not even begin
            # re-partitioning (let alone write the topology marker below)
            self._check_fence("repartition the root")
            if not root_manifests:
                root_manifests = self._scan_root_manifests()
            self.repartitioned_from = repartition_from
            self.topology_seq = new_seq
            self.generation = self.recovered_generation = adopted_gen
            self._repartition = self._gather_repartition(
                root_manifests, own_adopted=adopted, seq=new_seq
            )
            self._write_topology_marker(marker)
            _registry.get_registry().counter(
                "persistence.repartition.sources",
                "base sources re-partitioned by a topology-rescale resume",
                worker=self.worker,
            ).inc(max(1, len(self._repartition)))
            _blackbox.record(
                "checkpoint.repartition", worker=self.worker,
                from_topology=repartition_from, to_topology=self.topology,
                bases=sorted(self._repartition),
            )
            _log.warning(
                "persistence: worker %d resumes under topology %d from a "
                "root written by %d worker(s) in %s — re-partitioning %d "
                "source(s) by shard range",
                self.worker, self.topology, repartition_from,
                self.backend.describe(), len(self._repartition),
            )
            return {"sources": {}}
        if adopted is not None:
            gen = adopted_gen
            self.generation = self.recovered_generation = gen
            _blackbox.record(
                "checkpoint.recovery", worker=self.worker, generation=gen,
                rejected=[g for g, _ in self.rejected_generations],
            )
            if self.rejected_generations:
                _log.warning(
                    "persistence: worker %d fell back to generation %d in "
                    "%s — rejected newer generation(s): %s",
                    self.worker, gen, self.backend.describe(),
                    "; ".join(f"{g}: {r}" for g, r in self.rejected_generations),
                )
            return adopted
        # no manifest verified — try the pre-generational metadata file
        raw = self.backend.get(self._meta_key())
        if raw is not None:
            try:
                obj = _json.loads(raw.decode())
            except ValueError as exc:
                raise CheckpointError(
                    f"persistence: metadata file {self._meta_key()} in "
                    f"backend {self.backend.describe()} is undecodable "
                    f"({exc}) and no verified generation manifest exists"
                ) from exc
            if "generation" not in obj and "sources" in obj:
                self.legacy_resume = True
                return obj
            if "generation" in obj and not gens:
                # a new-format pointer survived but the manifests it points
                # at are GONE (partial restore, deleted prefix): this root
                # HAD committed state — starting fresh would silently
                # duplicate processing for externally-committed offsets
                raise CheckpointError(
                    f"persistence: {self._meta_key()} in backend "
                    f"{self.backend.describe()} records committed generation "
                    f"{obj.get('generation')} but no generation manifests "
                    "exist under "
                    f"{self._manifest_prefix()!r} — the root was partially "
                    "restored or its manifests were deleted (clear the "
                    "persistence directory to deliberately start fresh)"
                )
        if self.rejected_generations:
            raise CheckpointError(
                f"persistence: worker {self.worker} has "
                f"{len(self.rejected_generations)} checkpoint generation(s) "
                f"in backend {self.backend.describe()} but NONE verified — "
                "refusing to silently restart from scratch (run "
                "`python -m pathway_tpu_torch.cli scrub` on the root to inspect the damage; "
                "clear the persistence directory to deliberately start "
                "fresh). Rejected: "
                + "; ".join(f"{g}: {r}" for g, r in self.rejected_generations)
            )
        return {"sources": {}}

    def _advance_sources(self, processed_up_to: int | None) -> None:
        """Advance each source's committed frontier to its flushed state."""
        for sid, st in self.sources.items():
            if st.operator_mode:
                while st.pending_offsets and (
                    processed_up_to is None
                    or st.pending_offsets[0][1] <= processed_up_to
                ):
                    st.offset = st.pending_offsets.pop(0)[0]
                st.pending_offset = st.offset
            else:
                st.committed_chunks = st.log.chunks_written
                st.offset = st.pending_offset

    def _state_sig(self) -> list:
        """Cheap equality token for the advanced commit frontier: lets
        ``commit_async`` skip staging a generation when nothing moved
        (a false inequality only costs one no-op pending commit)."""
        return [
            (sid, st.committed_chunks, st.offset, st.key_seq)
            for sid, st in sorted(self.sources.items())
        ]

    @staticmethod
    def _source_meta(st: SourceState) -> dict:
        """Manifest source entry WITHOUT chunk digests (the async path
        fills those in post-barrier).  ``chunk_start``/``refs`` ride every
        manifest so a rescaled root stays self-describing across resumes."""
        meta: dict[str, Any] = {
            "chunks": st.committed_chunks,
            "offset": _offset_to_json(st.offset),
            "schema": st.schema_digest,
            "key_seq": st.key_seq,
        }
        if st.base is not None:
            meta["base"] = st.base
        if st.chunk_start:
            meta["chunk_start"] = st.chunk_start
        if st.refs:
            meta["refs"] = st.refs
        return meta

    def commit(
        self, processed_up_to: int | None = None, full_operator_dump: bool = False
    ) -> int:
        """Atomically commit the current consistent frontier as a new
        checkpoint generation, BLOCKING until it is durable.  Returns the
        durability sequence of this commit (already published on return).

        Only chunks flushed at offset markers are committed — the mid-batch
        event buffer stays out, so the committed (chunks, offset) pair always
        refers to the same row prefix.  No-op when nothing advanced.

        Any generations previously staged via :meth:`commit_async` are
        drained (published in order) first, and the commit barrier waits
        for every in-flight chunk of the committed prefix — so direct
        callers keep exact pre-pipelining semantics: when this returns,
        everything flushed so far is durably committed.

        The atomically-written generation manifest (chunk list + digests +
        operator/graph digest) IS the commit point; the legacy
        ``metadata.json.<worker>`` pointer is refreshed afterwards for
        humans and post-mortem tooling.  Superseded generations are GC'd
        only once they fall out of the retention window
        (``PATHWAY_CHECKPOINT_GENERATIONS``), so recovery always has
        verified fallbacks.

        Operator-persisting mode additionally dumps dirty operator states
        (via ``collect_operator_states``) — hashed and uploaded in parallel
        on the writer pool — and gates source offsets on ``processed_up_to``
        (the last epoch the engine ran; None = all).
        """
        if self.handoff_fenced:
            # the handoff commit already landed and its frontier is what
            # the ack files (and the successor topology) recorded — any
            # later commit (the shutdown path's final full dump) must not
            # move it.  Silent no-op by contract, not an error: the
            # shutdown path is shared with ordinary clean finishes.
            return self.published_seq
        self._drain_pending()
        self._advance_sources(processed_up_to)
        # commit barrier: every in-flight chunk of the committed prefix
        # must be durable before a manifest may reference it
        t0 = _time.perf_counter()
        for st in self.sources.values():
            if not st.operator_mode:
                st.log.barrier(st.committed_chunks)
        self.metrics.add_stage("barrier", _time.perf_counter() - t0)
        metadata: dict[str, Any] = {
            "sources": {
                sid: {
                    **self._source_meta(st),
                    "chunk_digests": st.log.chunk_digests[
                        st.chunk_start : st.committed_chunks
                    ],
                }
                for sid, st in self.sources.items()
            }
        }
        if self.operator_persistence and self.collect_operator_states is not None:
            dirty, digest = self.collect_operator_states(full_operator_dump)
            op_meta = {
                node_id: _op_ref(ref)
                for node_id, ref in (
                    self._metadata.get("operators", {}).get("nodes", {}).items()
                )
            }
            if dirty:
                self._op_gen += 1
                if self._pool is not None:
                    # the dirty dumps of one commit frame/hash/upload in
                    # PARALLEL on the writer pool instead of serially
                    jobs: list[tuple[str, _ArtifactJob]] = []
                    for node_id, blob in dirty.items():
                        key = f"operators/{self.worker}/{self._op_gen}/{node_id}"
                        if self._op_index is not None:
                            self._op_index.add(key)
                        ref = {"key": key, "digest": None}
                        op_meta[str(node_id)] = ref
                        jobs.append(
                            (
                                key,
                                self._pool.submit(
                                    key,
                                    [blob],
                                    sink=lambda d, r=ref: r.__setitem__(
                                        "digest", d
                                    ),
                                ),
                            )
                        )
                    t0 = _time.perf_counter()
                    for key, job in jobs:
                        job.wait()
                        if job.error is not None:
                            raise CheckpointError(
                                f"persistence: async write of operator dump "
                                f"{key} to backend "
                                f"{self.backend.describe()} failed: "
                                f"{job.error}"
                            ) from job.error
                    self.metrics.add_stage(
                        "barrier", _time.perf_counter() - t0
                    )
                else:
                    for node_id, blob in dirty.items():
                        key = f"operators/{self.worker}/{self._op_gen}/{node_id}"
                        if self._op_index is not None:
                            self._op_index.add(key)
                        framed = codec.frame_blob(blob)
                        self.backend.put(key, framed)
                        op_meta[str(node_id)] = {
                            "key": key,
                            "digest": _sha256(framed),
                        }
            metadata["operators"] = {
                "gen": self._op_gen,
                "digest": digest,
                "nodes": op_meta,
            }
        if self._pool is not None:
            # deferred group sync: directory entries of every staged
            # artifact write become durable here, before the manifest that
            # references them can publish
            t0 = _time.perf_counter()
            self._pool.sync_staged_now()
            self.metrics.add_stage("barrier", _time.perf_counter() - t0)
        if self.handoff_to is None and (
            _manifest_core(metadata) == _manifest_core(self._metadata)
        ):
            # (a handoff commit always publishes, even when nothing
            # advanced: the handoff_to stamp must land on a manifest)
            if self.confirm_operator_commit is not None:
                self.confirm_operator_commit()  # nothing new: dumps are moot
            self.metrics.commit_published(noop=True)
        else:
            self._publish_manifest(
                metadata, confirm=self.confirm_operator_commit
            )
            self.metrics.commit_published(noop=False)
        self._last_submit_sig = self._state_sig()
        self._seal_handoff_fence()
        with self._pending_cv:
            self._seq += 1
            self.published_seq = self._seq
            return self._seq

    def commit_async(self, processed_up_to: int | None = None) -> int:
        """Stage the current consistent frontier as a pipelined commit and
        return WITHOUT waiting for durability: the writer pool uploads the
        chunks while the epoch loop keeps computing, and the committer
        thread publishes the generation manifest once the commit barrier
        confirms every referenced artifact landed.

        Returns the staged durability sequence: the snapshot is durable
        once :attr:`published_seq` reaches it — a caller acking external
        offsets must wait for that (and only ack what was drained at
        STAGING time), never treat this method returning as durability.
        Falls back to the blocking :meth:`commit` when the pool is
        disabled (``PATHWAY_CHECKPOINT_WRITERS=0``) and in
        operator-persisting mode, where ``confirm_operator_commit`` may
        only mark nodes clean once the manifest referencing their dumps is
        durably published (the drain-on-confirm rule).
        """
        if self.handoff_fenced:
            return self.published_seq  # see commit(): frontier is sealed
        if self._pool is None or (
            self.operator_persistence
            and self.collect_operator_states is not None
        ):
            return self.commit(processed_up_to=processed_up_to)
        self._raise_async_error()
        self._advance_sources(processed_up_to)
        sig = self._state_sig()
        sources = {
            sid: (
                self._source_meta(st),
                None if st.operator_mode else st.log,
            )
            for sid, st in self.sources.items()
        }
        with self._pending_cv:
            if sig == self._last_submit_sig:
                # nothing advanced since the last staged frontier; if that
                # frontier already published, refresh the durability seq so
                # idle streams keep acking their drained commit markers
                if not self._pending and not self._pending_active:
                    self._seq += 1
                    self.published_seq = self._seq
                return self._seq
            self._seq += 1
            if self._pending:
                # commit CONFLATION: a newer frontier subsumes any queued,
                # not-yet-active staging (chunks are append-only prefixes,
                # offsets monotone), so replace the tail instead of
                # queueing per-epoch generations.  Under a commit cadence
                # faster than the store can publish, durability lag stays
                # one publish cycle, the queue length stays <= 1, and the
                # epoch loop never stalls behind superseded generations —
                # the writer pool's byte cap is the one backpressure.
                tail = self._pending[-1]
                tail.seq = self._seq
                tail.sources = sources
            else:
                self._pending.append(_PendingCommit(self._seq, sources))
            self._last_submit_sig = sig
            self._ensure_committer()
            self._pending_cv.notify_all()
            return self._seq

    def drain(self) -> None:
        """Block until every staged async commit has published (or failed)
        and surface the first failure — the explicit shutdown/final-commit
        drain.  ``commit()`` drains implicitly, so direct synchronous
        callers never observe a half-published pipeline."""
        self._drain_pending()

    def _drain_pending(self) -> None:
        with self._pending_cv:
            while self._pending or self._pending_active:
                self._pending_cv.wait(0.1)
        self._raise_async_error()

    def _raise_async_error(self) -> None:
        exc = self._async_error
        if exc is not None:
            if isinstance(exc, CheckpointError):
                raise exc
            raise CheckpointError(
                f"persistence: a pipelined commit failed; generation "
                f"{self.generation} remains the newest published recovery "
                f"point: {exc}"
            ) from exc

    def _ensure_committer(self) -> None:  # call with self._pending_cv held
        if self._committer is None or not self._committer.is_alive():
            self._committer = threading.Thread(
                target=self._committer_loop, daemon=True,
                name=f"pathway:ckpt-commit-{self.worker}",
            )
            self._committer.start()

    # pathway-lint: context=committer
    def _committer_loop(self) -> None:
        """Single consumer of the pending queue: generations publish in
        submission order, so the manifest sequence on the store is exactly
        the staging sequence (no reordering across a slow upload)."""
        while True:
            with self._pending_cv:
                deadline = _time.monotonic() + _WriterPool._IDLE_EXIT_S
                while not self._pending:
                    self._pending_cv.wait(
                        max(0.05, deadline - _time.monotonic())
                    )
                    if not self._pending and _time.monotonic() >= deadline:
                        # idle exit: null the handle while still holding the
                        # cv — commit_async stages and calls _ensure_committer
                        # under this same cv, so it either enqueued before
                        # this check (no exit) or sees None and respawns; a
                        # staged generation can never be orphaned behind a
                        # thread that decided to die (is_alive() lies for a
                        # moment after return)
                        self._committer = None
                        return
                # pace publishes: newer frontiers keep CONFLATING into the
                # queue tail while we hold off, so one manifest (and one
                # set of fsyncs) covers the whole burst — the interval is
                # the durability-lag / publish-overhead tradeoff knob
                until = self._last_publish + self._publish_interval
                while self._pending and _time.monotonic() < until:
                    self._pending_cv.wait(
                        max(0.001, until - _time.monotonic())
                    )
                pc = self._pending.popleft()
                self._pending_active = True
                self._pending_cv.notify_all()
            try:
                self._publish_pending(pc)
            except BaseException as exc:  # noqa: BLE001 - sticky, surfaced later
                with self._pending_cv:
                    if self._async_error is None:
                        self._async_error = exc
                _log.error(
                    "persistence: pipelined commit (worker %d, seq %d) "
                    "failed — generation %d remains the newest published "
                    "recovery point: %s",
                    self.worker, pc.seq, self.generation, exc,
                )
            finally:
                self._last_publish = _time.monotonic()
                with self._pending_cv:
                    self._pending_active = False
                    self._pending_cv.notify_all()

    def _publish_pending(self, pc: _PendingCommit) -> None:
        # the commit barrier: every chunk the manifest will reference must
        # be durable BEFORE put_atomic publishes the manifest — the
        # manifest-IS-the-commit-point invariant of the sync path, kept.
        # A crash anywhere before the put_atomic leaves an unreferenced
        # partial generation; resume ignores it and the next run's commits
        # overwrite the orphaned chunk slots.
        t0 = _time.perf_counter()
        for meta, log in pc.sources.values():
            if log is not None:
                log.barrier(meta["chunks"])
        if self._pool is not None:
            self._pool.sync_staged_now()  # deferred dir-entry durability
        self.metrics.add_stage("barrier", _time.perf_counter() - t0)
        metadata: dict[str, Any] = {
            "sources": {
                sid: {
                    **meta,
                    # digests resolved on the pool before each job reads
                    # done, so post-barrier they are all present; the
                    # manifest stores them for the log's OWN range only
                    "chunk_digests": (
                        list(
                            log.chunk_digests[
                                meta.get("chunk_start", 0) : meta["chunks"]
                            ]
                        )
                        if log is not None
                        else []
                    ),
                }
                for sid, (meta, log) in pc.sources.items()
            }
        }
        if _manifest_core(metadata) == _manifest_core(self._metadata):
            self.metrics.commit_published(noop=True)
        else:
            now = _time.monotonic()
            self._publish_manifest(
                metadata,
                refresh_pointer=now - self._last_pointer_refresh >= 1.0,
                run_gc=now - self._last_gc >= 2.0,
            )
            self.metrics.commit_published(noop=False)
        with self._pending_cv:
            self.published_seq = pc.seq

    def _publish_manifest(
        self,
        metadata: dict,
        confirm: Callable[[], None] | None = None,
        *,
        refresh_pointer: bool = True,
        run_gc: bool = True,
    ) -> None:
        """Bump the generation and atomically publish its manifest — THE
        commit point — then confirm, refresh the advisory pointer, GC.

        ``refresh_pointer``/``run_gc`` let the pipelined publish path
        rate-limit the two best-effort follow-ups (both are advisory /
        deferred by contract; a lagging pointer or a temporarily oversized
        retention window changes no recovery semantics)."""
        _publish_t0 = _time.perf_counter()
        # chaos hook: a `zombie` fault wedges this publish until the lease
        # is superseded, modelling a stale writer publishing late (lazy
        # import keeps persistence ↔ faults acyclic at module load)
        from pathway_tpu_torch.engine import faults as _faults

        spec = _faults.check(
            "zombie", worker=self.worker,
            key=self._manifest_key(self.generation + 1),
        )
        if spec is not None:
            self._zombie_stall(spec)
        # incarnation fence: THE split-brain gate.  Checked here, after the
        # barrier and immediately before the commit point, so a zombie
        # worker can never splice a stale generation (or refresh the
        # advisory pointer, which follows below) into a root a newer
        # incarnation owns.
        self._check_fence("publish a generation manifest")
        self.generation += 1
        metadata["format"] = MANIFEST_FORMAT
        metadata["generation"] = self.generation
        # recovery provenance rides every manifest so the supervisor (and
        # scrub) can reconstruct which generation a restart resumed from —
        # the incarnation stamp lets scrub cross-check every generation
        # against the lease (a stamp above the lease means fencing was
        # bypassed and the root deserves operator attention)
        metadata["recovered_from"] = self.recovered_generation
        metadata["attempt"] = _restart_attempt()
        metadata["incarnation"] = self.incarnation
        # the topology stamp is what makes elastic rescale detectable: a
        # resume under a different worker count sees the mismatch and
        # re-partitions (see _load_state); repartitioned_from records the
        # rescale provenance the supervisor surfaces on
        # SupervisorResult.recovery
        metadata["topology"] = self.topology
        metadata["topology_seq"] = self.topology_seq
        if self.repartitioned_from is not None:
            metadata["repartitioned_from"] = self.repartitioned_from
        if self.handoff_to is not None:
            # live-handoff provenance: this manifest is the exact frontier
            # the worker fenced before the coordinated drain — the
            # successor topology's repartition replay starts here
            metadata["handoff_to"] = self.handoff_to
        metadata["rejected"] = [[g, r] for g, r in self.rejected_generations]
        self.backend.put_atomic(
            self._manifest_key(self.generation),
            codec.frame_blob(_json.dumps(metadata).encode()),
        )
        self._known_generations.add(self.generation)
        self._metadata = metadata
        _blackbox.record(
            "checkpoint.publish", worker=self.worker,
            generation=self.generation,
        )
        if confirm is not None:
            confirm()
        # advisory pointer: unframed JSON, deliberately human-readable.
        # Best-effort — the manifest above IS the durable commit, so a
        # pointer write failure must not fail the commit (same rule as GC)
        if refresh_pointer:
            self._last_pointer_refresh = _time.monotonic()
            try:
                self.backend.put_atomic(
                    self._meta_key(),
                    _json.dumps(
                        {
                            "format": MANIFEST_FORMAT,
                            "generation": self.generation,
                            "manifest": self._manifest_key(self.generation),
                            "recovered_from": self.recovered_generation,
                            "attempt": metadata["attempt"],
                            "incarnation": self.incarnation,
                            "topology": self.topology,
                            "rejected": metadata["rejected"],
                        }
                    ).encode(),
                )
            except Exception as exc:  # noqa: BLE001 - advisory artifact only
                _log.warning(
                    "persistence: failed to refresh the advisory metadata "
                    "pointer %s (generation %d is committed regardless): %s",
                    self._meta_key(), self.generation, exc,
                )
        if run_gc:
            self._last_gc = _time.monotonic()
            self._gc_generations()
        self._commit_hist.observe(
            (_time.perf_counter() - _publish_t0) * 1000.0
        )

    def _verify_current_generation(self) -> bool:
        """Read back the just-committed generation and deep-verify it (with
        the process-lifetime artifact cache, so steady state only pays for
        the new delta).  This is the gate that keeps deferred GC honest: a
        generation that was mangled on its way to stable storage (torn
        write, bit rot in the write path) must never cause the deletion of
        the older generations recovery would fall back to."""
        key = self._manifest_key(self.generation)
        raw = self.backend.get(key)
        if raw is None:
            return False
        try:
            codec.unframe_blob(raw, what=key)
        except codec.IntegrityError:
            return False
        return not verify_manifest(
            self.backend, self.worker, self._metadata,
            cache=self._verified_artifacts,
        )

    def _gc_generations(self) -> None:
        """Deferred GC: drop manifests past the retention window, then drop
        operator chunks no retained (parseable) manifest references.  Input
        log chunks are append-only prefixes shared by every retained
        generation, so they are never deleted here.

        Nothing is deleted unless the NEWEST generation passes read-back
        verification: if what actually landed on the store is damaged, the
        older generations are the only recovery points left and the window
        simply grows until a sound commit lands.  GC failure must never
        fail a commit — the commit is already durable.

        Steady-state cost is O(delta): the generation set is the in-memory
        index maintained by ``_load_state``/``_publish_manifest`` (this
        storage is the shard's only writer), and the operator-chunk set
        pays ONE full listing on the first sweep (prior-run residue), then
        is maintained per dump write — no per-publish walk of the
        persistence root (``python -m pathway_tpu_torch.cli scrub`` still walks everything)."""
        try:
            gens = {
                g: self._manifest_key(g) for g in self._known_generations
            }
            horizon = self.generation - self.retain_generations
            doomed = [g for g in sorted(gens) if g <= horizon]
            rejected_stale = {
                g for g, _ in self.rejected_generations
                if g > self.generation and g in gens
            }
            # a rescaled root (topology epoch > 0) owes one orphan-shard
            # sweep per process on worker 0; never-rescaled roots skip at
            # zero cost and the sticky done-flag ends it after one pass
            orphan_pending = (
                self.worker == 0
                and self.topology_seq > 0
                and not getattr(self, "_orphan_gc_done", False)
            )
            if (
                not doomed
                and not rejected_stale
                and not orphan_pending
                and not self.operator_persistence
            ):
                return
            if not self._verify_current_generation():
                self.metrics.gc_run(deferred=True)
                _log.warning(
                    "persistence: generation %d failed read-back "
                    "verification on %s — deferring GC, keeping %d older "
                    "generation(s) as recovery fallbacks",
                    self.generation, self.backend.describe(), len(doomed),
                )
                return
            deleted = 0
            retained: list[tuple[int, str]] = []
            for gen, key in sorted(gens.items()):
                if gen in doomed:
                    self.backend.delete(key)
                    self._known_generations.discard(gen)
                    deleted += 1
                else:
                    retained.append((gen, key))
            # stale damaged manifests ABOVE the current generation (the ones
            # this resume rejected, minus slots already overwritten): this
            # run's verified commit supersedes them, and leaving them would
            # make every later resume re-reject them — and permanently trip
            # the loud-failure guards (external-resume sources, operator
            # multi-worker) even though a verified generation exists
            for gen, key in retained:
                if gen in rejected_stale:
                    self.backend.delete(key)
                    self._known_generations.discard(gen)
                    deleted += 1
            retained = [
                (g, k) for g, k in retained if g not in rejected_stale
            ]
            deleted += self._gc_orphan_topology()
            if not self.operator_persistence:
                self.metrics.gc_run(deferred=False, deleted=deleted)
                return
            live: set[str] = set()
            for gen, key in retained:
                if gen == self.generation:
                    manifest: Any = self._metadata
                else:
                    manifest, _reason = _read_manifest(self.backend, key)
                    if manifest is None:
                        continue  # corrupt manifest pins nothing
                for ref in (
                    (manifest.get("operators") or {}).get("nodes") or {}
                ).values():
                    live.add(_op_ref(ref)["key"])
            if self._op_index is None:
                # first sweep: the single full walk that folds in operator
                # chunks left behind by previous runs of this root
                self._op_index = set(
                    self.backend.list_keys(f"operators/{self.worker}/")
                )
            for key in sorted(self._op_index - live):
                self.backend.delete(key)
                self._op_index.discard(key)
                deleted += 1
            self.metrics.gc_run(deferred=False, deleted=deleted)
        except Exception as exc:  # noqa: BLE001 - GC is best-effort
            _log.warning(
                "persistence: generation GC failed (will retry next "
                "commit): %s", exc,
            )

    def _gc_orphan_topology(self) -> int:
        """Sweep the shard debris a SHRINK leaves behind: manifests,
        advisory pointers and progress beacons of worker ids outside the
        current topology.  Their snapshot chunks are deliberately KEPT —
        every live worker's manifests pin them through ``refs``.

        Worker 0 only, and only once EVERY live worker's newest readable
        manifest is stamped with the current topology: until then a crash
        could still force a live worker back into repartition resume,
        which reads the orphaned manifests.  A sticky done-flag keeps the
        post-sweep steady state at zero extra listings (the O(delta) GC
        contract)."""
        if (
            self.worker != 0
            or self.topology_seq <= 0  # never-rescaled roots: zero cost
            or self.operator_persistence
            or getattr(self, "_orphan_gc_done", False)
        ):
            return 0
        root = self._scan_root_manifests()
        orphans = sorted(w for w in root if w >= self.topology)
        if not orphans:
            self._orphan_gc_done = True
            return 0
        for w in range(self.topology):
            entries = root.get(w) or []
            if not entries:
                continue  # a worker that never committed pins nothing
            if w == 0:
                converged = True  # our own publish carries the stamp
            else:
                newest, _reason = _read_manifest(self.backend, entries[0][1])
                converged = (
                    newest is not None
                    and newest.get("topology") == self.topology
                    and int(newest.get("topology_seq", 0))
                    == self.topology_seq
                )
            if not converged:
                return 0  # defer: the root has not converged yet
        deleted = 0
        for w in orphans:
            for _gen, key in root[w]:
                self.backend.delete(key)
                deleted += 1
            self.backend.delete(f"{METADATA_FILE}.{w}")
            self.backend.delete(f"lease/progress.{w}")
        self._orphan_gc_done = True
        _log.info(
            "persistence: GC'd %d orphaned manifest(s) of superseded "
            "worker(s) %s (snapshot chunks stay pinned by refs)",
            deleted, orphans,
        )
        return deleted

    def load_operator_states(self, digest: str) -> dict[int, bytes]:
        """Committed operator snapshots keyed by node id; {} on first run."""
        meta = self._metadata.get("operators")
        if not meta or not meta.get("nodes"):
            return {}
        if meta.get("digest") != digest:
            raise ValueError(
                "persistence: operator snapshots were written by a different "
                "program shape — the dataflow graph changed between runs "
                "(clear the persistence directory to start fresh)"
            )
        out = {}
        for node_id, ref in meta["nodes"].items():
            ref = _op_ref(ref)
            key = ref["key"]
            blob = self.backend.get(key)
            if blob is None:
                raise CheckpointError(
                    f"persistence: missing operator chunk {key} "
                    f"(generation {self.generation}) in backend "
                    f"{self.backend.describe()}"
                )
            if ref.get("digest") is not None and _sha256(blob) != ref["digest"]:
                raise CheckpointError(
                    f"persistence: digest mismatch on operator chunk {key} "
                    f"(generation {self.generation}) in backend "
                    f"{self.backend.describe()}"
                )
            try:
                out[int(node_id)] = codec.unframe_blob(
                    blob,
                    what=key,
                    allow_legacy=ref.get("digest") is None,
                    verify_crc=ref.get("digest") is None,
                )
            except codec.IntegrityError as exc:
                raise CheckpointError(
                    f"persistence: corrupt operator chunk {key} "
                    f"(generation {self.generation}) in backend "
                    f"{self.backend.describe()}: {exc}"
                ) from exc
        return out

    @property
    def input_snapshots_enabled(self) -> bool:
        """False for UDF-caching-only mode (PersistenceMode::UdfCaching,
        src/connectors/mod.rs:114): the persistence root backs UDF caches but
        sources are neither snapshotted nor replayed."""
        name = getattr(self.mode, "name", None)
        return name != "UDF_CACHING"

    # -- sources --
    def has_repartition_state(
        self, source_id: str, base: str | None = None
    ) -> bool:
        """True when ``source_id`` must register on THIS worker even if its
        reader partitions to nothing here: either a repartition resume
        holds gathered state for its base name, or the adopted manifest
        carries ``refs`` for it (a root that rescaled in its past keeps
        every worker replaying its shard of the referenced old logs)."""
        if self._repartition is not None:
            return (base or base_source_id(source_id)) in self._repartition
        meta = self._metadata.get("sources", {}).get(source_id)
        return bool(meta and meta.get("refs"))

    def register_source(
        self,
        source_id: str,
        schema_digest: str | None = None,
        *,
        base: str | None = None,
    ) -> SourceState:
        if source_id in self.sources:
            raise ValueError(
                f"persistence: duplicate source name {source_id!r}; give each "
                "persisted connector a unique name="
            )
        base = base or base_source_id(source_id)
        log = SnapshotLog(self.backend, self.worker, source_id, pool=self._pool)
        if self._repartition is not None:
            return self._register_repartitioned(
                source_id, log, schema_digest, base
            )
        meta = self._metadata["sources"].get(source_id, {})
        stored_digest = meta.get("schema")
        if (
            schema_digest is not None
            and stored_digest is not None
            and stored_digest != schema_digest
        ):
            # positional ids shift when unnamed sources are added/reordered;
            # refuse to replay another source's snapshot into this input
            raise ValueError(
                f"persistence: source {source_id!r} has a snapshot with a "
                "different schema — the program changed between runs. Give "
                "persisted connectors stable name= arguments (or clear the "
                "persistence directory)."
            )
        committed = int(meta.get("chunks", 0))
        start = min(int(meta.get("chunk_start", 0)), committed)
        offset = _offset_from_json(meta.get("offset"))
        log.chunks_written = committed  # append after the committed prefix
        digests = meta.get("chunk_digests")
        # the manifest stores digests for the log's OWN range
        # [chunk_start, chunks); below chunk_start live superseded-topology
        # chunks covered by refs — pad so the list stays absolute-indexed
        log.chunk_digests = [None] * start + (
            list(digests[: committed - start])
            if isinstance(digests, list)
            else [None] * (committed - start)
        )
        state = SourceState(log, committed, offset)
        state.schema_digest = schema_digest
        state.operator_mode = self.operator_persistence
        state.key_seq = int(meta.get("key_seq", 0))
        state.chunk_start = start
        state.refs = [dict(r) for r in (meta.get("refs") or [])]
        state.base = base
        self.sources[source_id] = state
        return state

    def _register_repartitioned(
        self,
        source_id: str,
        log: SnapshotLog,
        schema_digest: str | None,
        base: str,
    ) -> SourceState:
        """Repartition-resume registration: seed the state from the gathered
        cross-worker base metadata instead of this worker's own manifest.
        The fresh log appends ABOVE this worker's own superseded committed
        range (when the old and new source ids coincide), so old chunks —
        still referenced by every new worker's refs — are never clobbered."""
        entry = (self._repartition or {}).get(base)
        if entry is None:
            # a source the old topology never committed: genuinely fresh
            state = SourceState(log, 0, None)
            state.schema_digest = schema_digest
            state.operator_mode = self.operator_persistence
            state.base = base
            self.sources[source_id] = state
            return state
        stored_digest = entry.get("schema")
        if (
            schema_digest is not None
            and stored_digest is not None
            and stored_digest != schema_digest
        ):
            raise ValueError(
                f"persistence: source {source_id!r} has a snapshot with a "
                "different schema — the program changed between runs. Give "
                "persisted connectors stable name= arguments (or clear the "
                "persistence directory)."
            )
        start = int(entry["own"].get(source_id, 0))
        # refs under MY OWN prefix also pin chunk ranges the fresh log
        # must not clobber — e.g. a round-tripped sid (src-w0 at N=2,
        # again at N=2 after a 2 -> 1 -> 2 trip) whose old range is only
        # reachable through carried refs, not my newest manifest
        for ref in entry.get("refs") or []:
            if (
                int(ref["worker"]) == self.worker
                and str(ref["source"]) == source_id
            ):
                start = max(start, int(ref["chunks"]))
        log.chunks_written = start
        log.chunk_digests = [None] * start
        state = SourceState(log, start, entry.get("offset"))
        state.schema_digest = schema_digest
        state.operator_mode = self.operator_persistence
        state.key_seq = int(entry.get("key_seq", 0))
        state.chunk_start = start
        state.refs = [dict(r) for r in entry.get("refs") or []]
        state.base = base
        self.sources[source_id] = state
        return state

    def replay_into(self, state: SourceState, insert) -> int:
        """Feed committed events into an input session at rewind time 0.

        Returns the number of replayed row events (mod.rs:222-258 rewind).
        Operator-persisting mode replays nothing — restored operator states
        already contain the effect of every committed row.

        Two row populations replay, in order:

        * **refs** — committed chunk ranges of superseded-topology logs
          (this worker's own old range included), read FILTERED to this
          worker's shard (``shard_to_worker(key, topology) == worker``).
          Every worker of the new topology replays every ref the same way,
          so the shard union covers the old row set exactly once and each
          row lands directly on its owner — the read amplification the
          rescale benchmark (``benchmarks/rescale_recovery.py``) prices;
        * **own chunks** ``[chunk_start, committed)`` — this worker's own
          (current-topology) ingest log, replayed UNfiltered; the
          coordinated epoch loop's post-ingest exchange re-routes them by
          key shard exactly like live rows.
        """
        if state.operator_mode:
            return 0
        from pathway_tpu_torch.engine.types import shard_to_worker

        n = 0
        if state.refs:
            reg = _registry.get_registry()
            rows_kept = reg.counter(
                "persistence.repartition.rows",
                "rows replayed from superseded-topology logs (post shard "
                "filter)",
                worker=self.worker,
            )
            chunks_read = reg.counter(
                "persistence.repartition.chunks",
                "superseded-topology chunks read during refs replay",
                worker=self.worker,
            )
            for ref in state.refs:
                start = int(ref.get("start", 0))
                end = int(ref["chunks"])
                chunks_read.inc(end - start)
                for kind, key, row, _t in _read_chunks(
                    self.backend,
                    f"snapshots/{int(ref['worker'])}/{ref['source']}",
                    start,
                    end,
                    ref.get("chunk_digests"),
                    digests_base=start,
                    generation=self.generation,
                    verified=self._verified_artifacts,
                ):
                    if shard_to_worker(key, self.topology) != self.worker:
                        continue
                    if kind == codec.EV_INSERT:
                        insert(key, row, 1)
                        n += 1
                    elif kind == codec.EV_DELETE:
                        insert(key, row, -1)
                        n += 1
            rows_kept.inc(n)
        for kind, key, row, _t in state.log.read_committed(
            state.committed_chunks,
            start=state.chunk_start,
            generation=self.generation,
            digests=state.log.chunk_digests,
            verified=self._verified_artifacts,
        ):
            if kind == codec.EV_INSERT:
                insert(key, row, 1)
                n += 1
            elif kind == codec.EV_DELETE:
                insert(key, row, -1)
                n += 1
        self.replayed_rows += n
        return n


def _read_manifest(
    backend: BlobBackend, key: str
) -> tuple[dict | None, str | None]:
    """Fetch + unframe + parse one generation manifest.

    Returns ``(manifest, None)`` on success, ``(None, reason)`` when the
    blob is gone or fails integrity/parsing — the single implementation
    behind resume, GC and scrub so the three paths cannot drift.
    """
    raw = backend.get(key)
    if raw is None:
        return None, "manifest vanished"
    try:
        return _json.loads(codec.unframe_blob(raw, what=key).decode()), None
    except (codec.IntegrityError, ValueError) as exc:
        return None, f"manifest undecodable: {exc}"


def _manifest_core(meta: dict) -> dict:
    """The state-bearing part of a manifest: provenance fields (generation,
    attempt, recovery trail) are excluded so "nothing advanced" commits stay
    no-ops."""
    return {k: meta[k] for k in ("sources", "operators") if k in meta}


def _op_ref(ref: Any) -> dict:
    """Normalize an operator-chunk reference (legacy plain key vs dict)."""
    if isinstance(ref, dict):
        return ref
    return {"key": ref, "digest": None}


def _restart_attempt() -> int:
    """Supervisor restart attempt (dup of faults.restart_attempt; reading
    the env registry directly avoids a persistence ↔ faults import cycle)."""
    from pathway_tpu_torch.internals.config import env_int

    return env_int("PATHWAY_RESTART_ATTEMPT")


def _cluster_processes() -> int:
    """Live ``PATHWAY_PROCESSES`` read (not the cached PathwayConfig:
    resume may run before the config snapshot of a freshly-spawned worker
    exists, and tests repoint the env between runs)."""
    from pathway_tpu_torch.internals.config import env_int

    return env_int("PATHWAY_PROCESSES")


def verify_manifest(
    backend: BlobBackend,
    worker: int,
    manifest: dict,
    *,
    cache: set[str] | None = None,
) -> list[str]:
    """Deep-verify every artifact a generation manifest references.

    Returns a list of problem descriptions (empty = generation is sound):
    missing chunks, frame integrity failures (torn write / truncation /
    bit rot), and digest mismatches, each naming the damaged key so an
    operator can locate it in the store.

    ``cache`` (optional) is a set of ``"key:digest"`` entries that already
    verified; sound artifacts are added to it and skipped next time —
    artifacts are immutable once written, so repeated in-process scans
    (resume probing, per-commit GC gating) only pay for the new delta.
    Offline audits (``scrub_root``) pass no cache and re-read everything.
    """
    problems: list[str] = []

    def check(key: str, digest: str | None, label: str) -> None:
        token = f"{key}:{digest}"
        if cache is not None and digest is not None and token in cache:
            return
        data = backend.get(key)
        if data is None:
            problems.append(f"missing {label} {key}")
            return
        if digest is not None and _sha256(data) != digest:
            problems.append(f"{label} {key}: digest mismatch")
            return
        try:
            # a matched SHA-256 digest subsumes the frame CRC; still parse
            # the header so torn frames are reported precisely
            codec.unframe_blob(
                data, what=key, allow_legacy=digest is None,
                verify_crc=digest is None,
            )
        except codec.IntegrityError as exc:
            problems.append(str(exc))
            return
        if cache is not None and digest is not None:
            cache.add(token)

    for sid, meta in (manifest.get("sources") or {}).items():
        n = int(meta.get("chunks", 0))
        start = min(int(meta.get("chunk_start", 0)), n)
        own = n - start
        digests = meta.get("chunk_digests")
        if not isinstance(digests, list):
            digests = [None] * own
        elif len(digests) < own:
            problems.append(
                f"source {sid!r}: manifest lists {len(digests)} digest(s) "
                f"for {own} committed chunk(s)"
            )
        for i in range(start, n):
            j = i - start
            check(
                f"snapshots/{worker}/{sid}/{i:08d}",
                digests[j] if j < len(digests) else None,
                "chunk",
            )
        # refs pin superseded-topology chunk ranges this generation's
        # replay still reads — damage there is damage HERE
        for ref in meta.get("refs") or []:
            try:
                rworker = int(ref["worker"])
                rsource = str(ref["source"])
                rstart = int(ref.get("start", 0))
                rn = int(ref["chunks"])
            except (KeyError, TypeError, ValueError):
                problems.append(
                    f"source {sid!r}: malformed repartition ref {ref!r}"
                )
                continue
            rdigests = ref.get("chunk_digests")
            if not isinstance(rdigests, list):
                rdigests = []
            for i in range(rstart, rn):
                j = i - rstart
                check(
                    f"snapshots/{rworker}/{rsource}/{i:08d}",
                    rdigests[j] if j < len(rdigests) else None,
                    f"ref chunk (source {sid!r})",
                )
    ops = manifest.get("operators") or {}
    for node_id, ref in (ops.get("nodes") or {}).items():
        ref = _op_ref(ref)
        check(ref["key"], ref.get("digest"), f"operator chunk (node {node_id})")
    return problems


def scrub_root(
    backend: BlobBackend, *, worker: int | None = None
) -> dict[str, Any]:
    """Offline audit of a persistence root: per-worker, per-generation
    health, without mutating anything.  Drives ``python -m pathway_tpu_torch.cli scrub``.

    Report shape::

        {"backend": "...", "ok": bool,
         "workers": {w: {"generations": [{"generation": g, "ok": bool,
                                          "problems": [...]}, ...],  # newest first
                         "newest": g | None,
                         "newest_verified": g | None,
                         "legacy_metadata": bool,
                         "pointer": {...} | None}}}

    ``ok`` is True iff every audited worker's NEWEST generation verifies
    (a root whose newest checkpoint is damaged recovers — via fallback —
    but deserves operator attention: that is the non-zero-exit condition).
    A worker with no generations at all is only healthy if it also has no
    broken legacy metadata.

    The ``lease/`` directory (incarnation fencing) and ``blackbox/`` dumps
    (crash flight recorder) are first-class residents of a persistence
    root, not foreign keys: the lease is unframed + validated (an
    unreadable lease, or any generation manifest stamped with an
    incarnation ABOVE the lease's, fails the audit — the latter means a
    fencing bypass), and flight-recorder dumps are parse-checked
    best-effort (they are torn-tolerant by design, so damage is reported
    but never fails the root).
    """
    all_keys = backend.list_keys("")
    workers: set[int] = set()
    for key in all_keys:
        parts = key.split("/")
        if parts[0] in ("manifests", "snapshots", "operators") and len(parts) > 1:
            if parts[1].isdigit():
                workers.add(int(parts[1]))
        elif parts[0].startswith(METADATA_FILE + "."):
            tail = parts[0].rsplit(".", 1)[-1]
            if tail.isdigit():
                workers.add(int(tail))
    report: dict[str, Any] = {
        "backend": backend.describe(),
        "ok": True,
        "workers": {},
    }
    # -- lease (incarnation fencing) audit --
    lease_report: dict[str, Any] | None = None
    lease_incarnation: int | None = None
    lease_raw = backend.get(LEASE_KEY)  # one read: presence AND decode
    if lease_raw is not None:
        lease = _decode_lease(lease_raw)
        if lease is None:
            # an unreadable lease is the fencing authority gone dark:
            # writers treat it as absent (and stop fencing), so the audit
            # must fail loudly instead of reading as clean
            lease_report = {
                "ok": False,
                "error": "lease undecodable (torn or corrupt frame)",
            }
            report["ok"] = False
        else:
            lease_incarnation = lease["incarnation"]
            lease_report = {
                "ok": True,
                "incarnation": lease_incarnation,
                "owner": lease.get("owner"),
                "run_id": lease.get("run_id"),
                # elastic-rescale provenance: the target topology of the
                # current incarnation and the recorded rescale history
                "workers": lease.get("workers"),
                "topology_history": lease.get("topology_history") or [],
            }
    if lease_report is not None:
        # progress beacons live beside the lease; count them so the audit
        # acknowledges them as first-class rather than unexplained keys
        lease_report["progress_workers"] = sorted(
            int(k.rsplit(".", 1)[-1])
            for k in all_keys
            if k.startswith("lease/progress.")
            and k.rsplit(".", 1)[-1].isdigit()
        )
        # autoscaler residue (load beacons, a handoff request/acks left by
        # a crash mid-handoff, the controller state file) is advisory by
        # contract — reported so the audit explains the keys, never a
        # failure: the supervisor clears it and falls back on relaunch
        lease_report["load_workers"] = sorted(
            int(k.rsplit(".", 1)[-1])
            for k in all_keys
            if k.startswith("lease/load.")
            and k.rsplit(".", 1)[-1].isdigit()
        )
        handoff_acks = sorted(
            int(k.rsplit(".", 1)[-1])
            for k in all_keys
            if k.startswith(HANDOFF_ACK_PREFIX)
            and k.rsplit(".", 1)[-1].isdigit()
        )
        if HANDOFF_KEY in all_keys or handoff_acks:
            lease_report["handoff"] = {
                "pending_request": HANDOFF_KEY in all_keys,
                "acks": handoff_acks,
            }
        # warm-standby residue: apply-cursor beacons, the promotion
        # history, per-worker fences, and any PROMOTE request/acks a
        # crash left behind.  All advisory (never a failure): a standby
        # that stops beaconing just means the pool is cold, and the
        # supervisor clears a stale PROMOTE on relaunch.
        standbys: dict[int, dict[str, Any]] = {}
        for key in all_keys:
            tail = key.rsplit(".", 1)[-1]
            if not key.startswith(STANDBY_BEACON_PREFIX) or not tail.isdigit():
                continue
            try:
                beacon = _json.loads((backend.get(key) or b"").decode())
            except (ValueError, AttributeError):
                continue  # torn beacon: the next tick rewrites it
            if isinstance(beacon, dict):
                standbys[int(tail)] = {
                    "lag_s": beacon.get("lag_s"),
                    "cursors": beacon.get("cursors"),
                    "verified_chunks": beacon.get("verified_chunks"),
                    "at": beacon.get("at"),
                }
        if standbys:
            lease_report["standbys"] = standbys
        if PROMOTIONS_KEY in all_keys:
            try:
                hist = _json.loads(
                    (backend.get(PROMOTIONS_KEY) or b"").decode()
                )
            except (ValueError, AttributeError):
                hist = None
            if isinstance(hist, dict) and isinstance(
                hist.get("promotions"), list
            ):
                lease_report["promotions"] = hist["promotions"]
        if lease_report.get("ok") and lease_raw is not None:
            lease_obj = _decode_lease(lease_raw)
            if lease_obj is not None and lease_obj.get("fences"):
                lease_report["fences"] = lease_obj["fences"]
        promote_acks = sorted(
            k[len(PROMOTE_ACK_PREFIX):]
            for k in all_keys
            if k.startswith(PROMOTE_ACK_PREFIX)
        )
        if PROMOTE_KEY in all_keys or promote_acks:
            lease_report["promote"] = {
                "pending_request": PROMOTE_KEY in all_keys,
                "acks": promote_acks,
            }
        report["lease"] = lease_report
    # -- flight-recorder dump audit (best-effort, never fails the root) --
    dump_keys = [
        k for k in all_keys
        if k.startswith("blackbox/") and k.endswith(".json")
    ]
    if dump_keys:
        unreadable: list[str] = []
        dump_workers: set[int] = set()
        for key in dump_keys:
            raw = backend.get(key)
            try:
                payload = _json.loads((raw or b"").decode())
                if not isinstance(payload.get("dumped_at"), (int, float)):
                    raise ValueError("missing dumped_at stamp")
                dump_workers.add(int(payload.get("worker", -1)))
            except (ValueError, TypeError, AttributeError):
                unreadable.append(key)
        report["blackbox"] = {
            "dumps": len(dump_keys),
            "workers": sorted(dump_workers),
            "unreadable": unreadable,
        }
    if worker is not None:
        if worker not in workers:
            # a filter that matches nothing must not read as "clean" —
            # the operator asked about a shard that does not exist
            report["ok"] = False
            report["error"] = (
                f"worker {worker} has no checkpoint state on this root "
                f"(workers present: {sorted(workers) or 'none'})"
            )
            return report
        workers &= {worker}
    # per-invocation verification cache: retained generations share their
    # append-only chunk prefix, so without it a K-generation audit would
    # fetch and hash most chunks K times (artifacts are immutable and
    # tokens are key:digest, so the cache cannot mask real damage)
    audit_cache: set[str] = set()
    newest_stamps: list[tuple[int, int]] = []  # (incarnation, topology)
    for w in sorted(workers):
        prefix = f"manifests/{w}/"
        gens = sorted(
            (
                int(k.rsplit("/", 1)[-1])
                for k in all_keys
                if k.startswith(prefix) and k.rsplit("/", 1)[-1].isdigit()
            ),
            reverse=True,
        )
        entries = []
        newest_verified = None
        for gen in gens:
            manifest, reason = _read_manifest(backend, f"{prefix}{gen:08d}")
            stamp = None
            topo = None
            if manifest is None:
                problems = [reason or "unreadable"]
            else:
                problems = verify_manifest(
                    backend, w, manifest, cache=audit_cache
                )
                stamp = manifest.get("incarnation")
                topo = manifest.get("topology")
                if gen == gens[0] and isinstance(stamp, int) and isinstance(
                    topo, int
                ):
                    newest_stamps.append((stamp, topo))
                if (
                    lease_incarnation is not None
                    and isinstance(stamp, int)
                    and stamp > lease_incarnation
                ):
                    # a generation stamped ABOVE the lease means a writer
                    # published without holding a current incarnation —
                    # the fencing protocol was bypassed or the lease was
                    # rolled back; either way the root needs an operator
                    problems = problems + [
                        f"manifest stamped with incarnation {stamp} above "
                        f"the lease's {lease_incarnation} (fencing bypass)"
                    ]
            if not problems and newest_verified is None:
                newest_verified = gen
            entries.append(
                {
                    "generation": gen,
                    "ok": not problems,
                    "problems": problems,
                    "incarnation": stamp,
                    "topology": topo,
                    "topology_seq": (
                        manifest.get("topology_seq", 0)
                        if manifest is not None
                        else None
                    ),
                    "repartitioned_from": (
                        manifest.get("repartitioned_from")
                        if manifest is not None
                        else None
                    ),
                }
            )
        pointer = None
        raw = backend.get(f"{METADATA_FILE}.{w}")
        legacy = False
        if raw is not None:
            try:
                pointer = _json.loads(raw.decode())
                legacy = "generation" not in pointer and "sources" in pointer
            except ValueError:
                pointer = {"error": "metadata file undecodable"}
            if pointer is not None and "generation" in pointer and not gens:
                # resume refuses this root (partial restore: committed
                # state recorded, manifests gone) — scrub must agree
                pointer = dict(pointer)
                pointer["error"] = (
                    f"pointer records committed generation "
                    f"{pointer.get('generation')} but no generation "
                    "manifests exist (partially restored root)"
                )
        worker_ok = (
            (entries[0]["ok"] if entries else True)
            and not (pointer or {}).get("error")
        )
        report["workers"][w] = {
            "generations": entries,
            "newest": gens[0] if gens else None,
            "newest_verified": newest_verified,
            "legacy_metadata": legacy,
            "pointer": pointer,
            "ok": worker_ok,
        }
        report["ok"] = report["ok"] and worker_ok
    # -- topology audit (elastic rescale) -----------------------------------
    # The cluster's CURRENT worker count: the data plane's topology-epoch
    # marker first (written by the repartitioning workers themselves),
    # then the lease's recorded target, then the topology stamped by the
    # most recent (highest-incarnation) writer.
    marker = read_topology_marker(backend)
    current_workers = None
    if marker is not None:
        current_workers = marker["workers"]
    elif lease_report is not None and isinstance(
        lease_report.get("workers"), int
    ):
        current_workers = lease_report["workers"]
    elif newest_stamps:
        current_workers = max(newest_stamps)[1]
    if current_workers is not None:
        report["topology"] = {
            "workers": current_workers,
            "seq": (marker or {}).get("seq", 0),
            "repartitioned_from": (marker or {}).get("from_workers"),
            "history": (lease_report or {}).get("topology_history") or [],
        }
        for w, wrep in report["workers"].items():
            entries = wrep["generations"]
            newest_topo = entries[0].get("topology") if entries else None
            if w >= current_workers:
                # a shard of a superseded (larger) topology: its manifests
                # are fenced debris awaiting orphan GC, never damage — the
                # live workers' refs pin its CHUNKS, and damage there is
                # reported on the live manifests that reference them
                wrep["orphaned"] = True
                wrep["status"] = "fenced, pending GC"
                if not wrep["ok"]:
                    wrep["ok"] = True
                    report["ok"] = all(
                        rep["ok"] for rep in report["workers"].values()
                    ) and (lease_report is None or lease_report["ok"])
            elif entries and (
                (
                    isinstance(newest_topo, int)
                    and newest_topo != current_workers
                )
                or (
                    marker is not None
                    and entries[0].get("topology_seq") is not None
                    and entries[0]["topology_seq"] != marker["seq"]
                )
            ):
                # a live worker that has not republished under the current
                # topology epoch yet: mid-rescale, not damage
                wrep["pending_repartition"] = True
    reg = _registry.get_registry()
    reg.counter("persistence.scrub.runs", "offline scrub audits run").inc()
    if not report["ok"]:
        reg.counter(
            "persistence.scrub.damaged", "scrub audits that found damage"
        ).inc()
    return report


def repair_root(
    backend: BlobBackend, *, worker: int | None = None
) -> list[str]:
    """Quarantine damaged generations that sit ABOVE a worker's newest
    fully verified one (``python -m pathway_tpu_torch.cli scrub --repair``).

    Resume already falls back past damaged generations, but configurations
    where fallback would silently lose data (broker-offset sources,
    operator-persisting multi-worker groups) refuse to start while damaged
    newer generations exist.  This is the deliberate operator action those
    errors point at: each damaged manifest is MOVED to
    ``quarantine/<worker>/<generation>`` (kept for forensics, invisible to
    resume), leaving the newest verified generation as the newest on the
    root.  Returns a description of every action taken.
    """
    actions: list[str] = []
    audit = scrub_root(backend, worker=worker)
    for w, wrep in audit.get("workers", {}).items():
        newest_verified = wrep.get("newest_verified")
        if newest_verified is None and wrep["generations"]:
            # nothing verifies: quarantining everything would turn a
            # repairable-looking root into a refused partial restore —
            # that calls for a human, not a tool
            actions.append(
                f"worker {w}: NO generation verifies — not quarantining "
                "(clear the shard deliberately to start fresh)"
            )
            continue
        for entry in wrep["generations"]:
            gen = entry["generation"]
            if entry["ok"] or gen < (newest_verified or 0):
                continue  # sound, or a damaged gen fallback never reaches
            src = f"manifests/{w}/{gen:08d}"
            dst = f"quarantine/{w}/{gen:08d}"
            blob = backend.get(src)
            if blob is not None:
                backend.put(dst, blob)
            backend.delete(src)
            actions.append(
                f"worker {w}: quarantined damaged generation {gen} "
                f"({'; '.join(entry['problems'][:2]) or 'unreadable'}) "
                f"-> {dst}"
            )
    return actions


def _offset_to_json(offset: Any) -> Any:
    if offset is None:
        return None
    try:
        _json.dumps(offset)
        return {"j": offset}
    except (TypeError, ValueError):
        return {"p": pickle.dumps(offset).hex()}


def _offset_from_json(obj: Any) -> Any:
    if obj is None:
        return None
    if "j" in obj:
        return obj["j"]
    return pickle.loads(bytes.fromhex(obj["p"]))
