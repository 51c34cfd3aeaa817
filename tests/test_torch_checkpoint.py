"""The port's verified generational checkpoints held to the JAX package's.

Each case gives the same damage to the same root in each package's
``engine/persistence.py`` (``MemoryBackend``, ``FileBackend``) and both
must reach the same outcome, the one ``tests/test_checkpoint_integrity.py``
pins for the JAX package: the generational fallback, the async commit's
barrier, drain and failure isolation, the ``FlakyBackend`` injectors, the
object-store retry budget against a fake client, and ``scrub`` (the JAX
package's ``click`` command against the port's ``argparse`` one, whose
output must be the same but for the root's path).
"""

from __future__ import annotations

import json
import threading
import time

import pytest
from click.testing import CliRunner

from pathway_tpu import cli as jcli
from pathway_tpu.engine import codec as jcodec
from pathway_tpu.engine import faults as jfaults
from pathway_tpu.engine import persistence as jpz
from pathway_tpu_torch import cli as tcli
from pathway_tpu_torch.engine import codec as tcodec
from pathway_tpu_torch.engine import faults as tfaults
from pathway_tpu_torch.engine import persistence as tpz

PACKAGES = {"jax": (jpz, jfaults, jcodec), "torch": (tpz, tfaults, tcodec)}


class Mode:
    name = "OPERATOR_PERSISTING"


def commit_generation(pz, backend, key, row, offset):
    st = pz.PersistentStorage(backend)
    state = st.register_source("src")
    state.log.record(key, row, 1)
    state.pending_offset = {"rows": offset}
    state.log.flush_chunk()
    st.commit()
    return st


def resume(pz, backend):
    st = pz.PersistentStorage(backend)
    state = st.register_source("src")
    rows: list = []
    st.replay_into(state, lambda k, r, d: rows.append((k, r, d)))
    return st, rows, state.offset


def flip_bit(store: dict, key: str, bit: int = 40) -> None:
    data = bytearray(store[key])
    data[bit // 8] ^= 1 << (bit % 8)
    store[key] = bytes(data)


def same_words(text: str) -> str:
    """``text`` with the port's command and package names as the JAX
    package's, where the two messages name their own."""
    return text.replace("python -m pathway_tpu_torch.cli scrub", "pathway_tpu scrub").replace(
        "pathway_tpu_torch", "pathway_tpu")


def outcome(fn):
    """``fn()``'s result, or the name of what it raised and its message."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the outcome under comparison
        return (type(exc).__name__, same_words(str(exc)))


def both(case, *args):
    """``{package: outcome of case(package's modules, *args)}``."""
    return {name: outcome(lambda mods=mods: case(*mods, *args)) for name, mods in PACKAGES.items()}


# ---------------------------------------------------------------------------
# Generational fallback
# ---------------------------------------------------------------------------


def _delete(store, key):
    del store[key]


def _tear(store, key):
    store[key] = store[key][: len(store[key]) // 2]


def _drop_manifests(store, _key):
    for key in [k for k in store if k.startswith("manifests/")]:
        del store[key]


DAMAGE = {
    "clean": [],
    "manifest": [(flip_bit, "manifests/0/00000003")],
    "chunk": [(flip_bit, "snapshots/0/src/00000002")],
    "torn_chunk": [(_tear, "snapshots/0/src/00000002")],
    "missing_chunk": [(_delete, "snapshots/0/src/00000002")],
    "two_generations": [(flip_bit, "manifests/0/00000003"),
                        (lambda store, key: store.__setitem__(key, b""), "snapshots/0/src/00000001")],
    "all_generations": [(flip_bit, f"manifests/0/{g:08d}") for g in (1, 2, 3)],
    "partially_restored": [(_drop_manifests, None)],
    "recommit_after_fallback": [(flip_bit, "snapshots/0/src/00000002")],
}

# what tests/test_checkpoint_integrity.py pins: (generation, rejected, replayed keys, offset)
EXPECTED = {
    "clean": (3, [], [1, 2, 3], 3),
    "manifest": (2, [3], [1, 2], 2),
    "chunk": (2, [3], [1, 2], 2),
    "torn_chunk": (2, [3], [1, 2], 2),
    "missing_chunk": (2, [3], [1, 2], 2),
    "two_generations": (1, [3, 2], [1], 1),
    "all_generations": "NONE verified",
    "partially_restored": "partially restored",
    "recommit_after_fallback": (3, [], [1, 2, 9], 9),
}


def fallback_case(pz, faults, codec, damage):
    store: dict = {}
    backend = pz.MemoryBackend(store)
    for i in range(1, 4):
        commit_generation(pz, backend, i, (f"row{i}",), i)
    for fn, key in DAMAGE[damage]:
        fn(store, key)
    st, rows, offset = resume(pz, backend)
    if damage == "recommit_after_fallback":
        state = st.sources["src"]
        state.log.record(9, ("fresh",), 1)
        state.pending_offset = {"rows": 9}
        state.log.flush_chunk()
        st.commit()
        st, rows, offset = resume(pz, backend)
    return (st.generation, [g for g, _ in st.rejected_generations], [k for k, _r, _d in rows], offset["rows"])


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_generational_fallback_matches_jax(damage):
    got = both(fallback_case, damage)
    assert got["torch"] == got["jax"], got
    want = EXPECTED[damage]
    if isinstance(want, str):
        assert got["jax"][0] == "CheckpointError" and want in got["jax"][1], got
    else:
        assert got["jax"] == want, got


def operator_case(pz, faults, codec, case):
    store: dict = {}
    backend = pz.MemoryBackend(store)

    def commit_ops(payload):
        st = pz.PersistentStorage(backend, mode=Mode())
        st.collect_operator_states = lambda full: ({5: payload}, "g")
        st.commit()

    commit_ops(b"state-v1")
    commit_ops(b"state-v2")
    if case == "corrupt_dump":
        [key2] = [k for k in store if k.startswith("operators/0/2/")]
        flip_bit(store, key2)
        st = pz.PersistentStorage(backend, mode=Mode())
        return st.generation, [g for g, _ in st.rejected_generations], st.load_operator_states("g")
    kept = any(k.startswith("operators/0/1/") for k in store)
    commit_ops(b"state-v3")
    return kept, any(k.startswith("operators/0/1/") for k in store), any(k.startswith("operators/0/2/") for k in store)


@pytest.mark.parametrize("case,want", [
    ("corrupt_dump", (1, [2], {5: b"state-v1"})),
    ("deferred_gc", (True, False, True)),
])
def test_operator_generations_match_jax(case, want, monkeypatch):
    monkeypatch.setenv("PATHWAY_CHECKPOINT_GENERATIONS", "2")
    got = both(operator_case, case)
    assert got["torch"] == got["jax"] == want, got


# ---------------------------------------------------------------------------
# Pipelined async commit
# ---------------------------------------------------------------------------


def gated_backend(pz, store, hold_prefix="snapshots/"):
    class Gated(pz.MemoryBackend):
        """Snapshot-chunk puts block until released: the manifest must not
        publish while a chunk it references is in flight."""

        def __init__(self):
            super().__init__(store)
            self.release = threading.Event()

        def put(self, key, data):
            if key.startswith(hold_prefix) and not self.release.wait(10):
                raise RuntimeError("gated put never released")
            super().put(key, data)

    return Gated()


def stage_row(state, key, row, offset):
    state.log.record(key, row, 1)
    state.pending_offset = {"rows": offset}
    state.log.flush_chunk()


def manifests(store):
    return sorted(k for k in store if k.startswith("manifests/"))


def async_case(pz, faults, codec, case):
    store: dict = {}
    if case == "barrier":
        backend = gated_backend(pz, store)
        st = pz.PersistentStorage(backend)
        stage_row(st.register_source("src"), 1, ("row1",), 1)
        st.commit_async()
        time.sleep(0.15)  # the chunk is held: the manifest must not appear meanwhile
        held = manifests(store)
        backend.release.set()
        st.drain()
        st2, rows, offset = resume(pz, pz.MemoryBackend(store))
        return held, manifests(store), st2.generation, rows, offset
    if case == "drain_on_shutdown":
        backend = pz.MemoryBackend(store)
        st = pz.PersistentStorage(backend)
        state = st.register_source("src")
        for i in range(7):
            stage_row(state, i, (f"row{i}",), i)
            if i % 2 == 0:
                st.commit_async()
        st.commit()  # the runner's shutdown drain + final commit
        st2, rows, offset = resume(pz, backend)
        return ([k for k, _r, _d in rows], offset, st2.generation == st.generation,
                st2.rejected_generations, st2.sources["src"].committed_chunks)
    if case == "failed_write":
        flaky = faults.FlakyBackend(
            pz.MemoryBackend(store), faults.FaultPlan([{"kind": "blob_put", "key": "snapshots", "nth": 2}])
        )
        st = pz.PersistentStorage(flaky)
        state = st.register_source("src")
        stage_row(state, 1, ("a",), 1)
        st.commit_async()
        st.drain()
        stage_row(state, 2, ("b",), 2)
        st.commit_async()
        first = outcome(st.drain)
        sticky = outcome(st.commit)
        st2, rows, offset = resume(pz, pz.MemoryBackend(store))
        return (first[0], "async write" in first[1], sticky[0], st2.generation, rows, offset,
                pz.scrub_root(pz.MemoryBackend(store))["ok"])
    if case == "idle_commit_acks":
        st = pz.PersistentStorage(pz.MemoryBackend(store))
        stage_row(st.register_source("src"), 1, ("a",), 1)
        st.commit_async()
        st.drain()
        seq = st.published_seq
        st.commit_async()
        refreshed = st.published_seq > seq
        st.drain()
        return refreshed, st.generation, manifests(store)
    assert case == "operator_inline"
    st = pz.PersistentStorage(pz.MemoryBackend(store), mode=Mode())
    confirmed = []
    st.collect_operator_states = lambda full: ({5: b"state-a", 7: b"state-b"}, "g")
    st.confirm_operator_commit = lambda: confirmed.append(True)
    st.commit_async()
    return confirmed, manifests(store), pz.PersistentStorage(pz.MemoryBackend(store), mode=Mode()).load_operator_states("g")


ASYNC_EXPECTED = {
    "barrier": ([], ["manifests/0/00000001"], 1, [(1, ("row1",), 1)], {"rows": 1}),
    "drain_on_shutdown": (list(range(7)), {"rows": 6}, True, [], 7),
    "failed_write": ("CheckpointError", True, "CheckpointError", 1, [(1, ("a",), 1)], {"rows": 1}, True),
    "idle_commit_acks": (True, 1, ["manifests/0/00000001"]),
    "operator_inline": ([True], ["manifests/0/00000001"], {5: b"state-a", 7: b"state-b"}),
}


@pytest.mark.parametrize("case", sorted(ASYNC_EXPECTED))
def test_async_commit_matches_jax(case, monkeypatch):
    monkeypatch.setenv("PATHWAY_CHECKPOINT_WRITERS", "2")
    got = both(async_case, case)
    assert got["torch"] == got["jax"] == ASYNC_EXPECTED[case], got


def backpressure_case(pz, faults, codec):
    store: dict = {}
    backend = gated_backend(pz, store)
    st = pz.PersistentStorage(backend)
    state = st.register_source("src")
    blob = "x" * (700 << 10)
    feeder = threading.Thread(target=lambda: [stage_row(state, i, (blob,), i) for i in range(3)], daemon=True)
    feeder.start()
    feeder.join(0.5)
    stalled = feeder.is_alive()  # ~700 KiB a chunk against a 1 MiB cap
    bounded = st.metrics.inflight_bytes <= (1 << 20) + (701 << 10)
    backend.release.set()
    feeder.join(10)
    st.commit()
    return stalled, bounded, feeder.is_alive(), len(resume(pz, backend)[1]), st.metrics.backpressure_s > 0


def test_backpressure_matches_jax(monkeypatch):
    monkeypatch.setenv("PATHWAY_CHECKPOINT_WRITERS", "2")
    monkeypatch.setenv("PATHWAY_CHECKPOINT_INFLIGHT_MB", "1")
    got = both(backpressure_case)
    assert got["torch"] == got["jax"] == (True, True, False, 3, True), got


# ---------------------------------------------------------------------------
# FlakyBackend injectors
# ---------------------------------------------------------------------------


def injector_case(pz, faults, codec, kind):
    if kind == "from_nth":
        plan = faults.FaultPlan([{"kind": "blob_bitflip", "key": "m/", "from_nth": 3}])
        return [plan.check("blob_bitflip", key="m/x") is not None for _ in range(6)]
    store: dict = {}
    flaky = faults.FlakyBackend(pz.MemoryBackend(store), faults.FaultPlan([{"kind": kind}], seed=11))
    framed = codec.frame_blob(b"the checkpoint payload" * 3)
    flaky.put("snapshots/0/src/00000000", framed)
    stored = store["snapshots/0/src/00000000"]
    return stored.hex(), outcome(lambda: codec.unframe_blob(stored, what="chunk"))[0]


@pytest.mark.parametrize("kind", ["blob_bitflip", "blob_torn", "blob_truncate", "from_nth"])
def test_injectors_match_jax(kind):
    got = both(injector_case, kind)
    assert got["torch"] == got["jax"], got
    if kind == "from_nth":
        assert got["jax"] == [False, False, True, True, True, True]
    else:
        assert got["jax"][1] == "IntegrityError", got


def test_wrap_backend_follows_the_plan():
    for _name, (pz, faults, _codec) in PACKAGES.items():
        backend = pz.MemoryBackend({})
        faults.install_plan(faults.FaultPlan([{"kind": "blob_get", "nth": 1}]))
        try:
            wrapped = faults.wrap_backend(backend)
            assert isinstance(wrapped, faults.FlakyBackend)
            with pytest.raises(faults.InjectedFault):
                wrapped.get("x")
            assert wrapped.get("x") is None
        finally:
            faults.install_plan(None)
        assert faults.wrap_backend(backend) is backend
        faults.clear_plan()


# ---------------------------------------------------------------------------
# Object-store transient retry
# ---------------------------------------------------------------------------


class StoreError(Exception):
    def __init__(self, status):
        super().__init__(f"status {status}")
        self.status = status


class FlakyClient:
    """Fails each op with ``failures`` errors of ``status`` before succeeding."""

    def __init__(self, failures, status=503):
        self.failures = failures
        self.status = status
        self.calls = 0
        self.objects: dict[str, bytes] = {}

    def maybe_fail(self):
        self.calls += 1
        if self.failures > 0:
            self.failures -= 1
            raise StoreError(self.status)


def fake_store(pz, client, prefix=""):
    class FakeObjectStore(pz._PrefixedObjectStore):
        _error_cls = StoreError

        def _put(self, key, data):
            self.client.maybe_fail()
            self.client.objects[key] = data

        def _get(self, key):
            self.client.maybe_fail()
            if key not in self.client.objects:
                raise StoreError(404)
            return self.client.objects[key]

        def _list(self, prefix):
            self.client.maybe_fail()
            return [k for k in self.client.objects if k.startswith(prefix)]

        def _delete(self, key):
            self.client.maybe_fail()
            self.client.objects.pop(key, None)

    return FakeObjectStore(client, prefix)


def retry_case(pz, faults, codec, case):
    if case == "within_budget":
        store = fake_store(pz, FlakyClient(failures=2), prefix="p")
        store.put("k", b"v")
        return store.get("k"), store.list_keys(""), store.client.calls
    client = {"exhausted": FlakyClient(failures=99), "not_found": FlakyClient(failures=0),
              "auth": FlakyClient(failures=5, status=403)}[case]
    store = fake_store(pz, client)
    got = outcome(lambda: store.put("k", b"v") if case == "exhausted" else store.get("k"))
    return got, client.calls


@pytest.mark.parametrize("case,want", [
    ("within_budget", (b"v", ["k"], 5)),
    ("exhausted", (("StoreError", "status 503"), 4)),
    ("not_found", (None, 1)),
    ("auth", (("StoreError", "status 403"), 1)),
])
def test_object_store_retry_matches_jax(case, want, monkeypatch):
    monkeypatch.setenv("PATHWAY_BLOB_RETRY_INITIAL_MS", "1")
    monkeypatch.setenv("PATHWAY_BLOB_RETRIES", "3")
    got = both(retry_case, case)
    assert got["torch"] == got["jax"] == want, got


# ---------------------------------------------------------------------------
# scrub
# ---------------------------------------------------------------------------


def flip_file(path, at=None):
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        data[len(data) // 2 if at is None else at] ^= 0x20 if at is None else 0x10
        f.seek(0)
        f.write(bytes(data))


def scrub_root_of(name, tmp_path, case) -> str:
    pz, faults, _codec = PACKAGES[name]
    root = str(tmp_path / name / "pstore")
    if case == "bitflipped_commits":
        flaky = faults.FlakyBackend(
            pz.FileBackend(root),
            faults.FaultPlan([{"kind": "blob_bitflip", "key": "manifests/", "from_nth": 2}], seed=5),
        )
        for i in (1, 2, 3):
            commit_generation(pz, flaky, i, (f"row{i}",), i)
        return root
    for i in range(1, 4):
        commit_generation(pz, pz.FileBackend(root), i, (f"row{i}",), i)
    if case == "damaged_chunk":
        flip_file(f"{root}/snapshots/0/src/00000002")
    elif case in ("repair", "damaged_manifest"):
        flip_file(f"{root}/manifests/0/00000003", at=20)
    elif case == "partially_restored":
        import shutil

        shutil.rmtree(f"{root}/manifests")
    return root


def run_scrub(name, argv, capsys):
    """``(exit code, stdout, stderr)`` of one package's scrub command."""
    if name == "jax":
        result = CliRunner().invoke(jcli.cli, ["scrub", *argv])
        return result.exit_code, result.stdout, result.stderr
    code = tcli.main(["scrub", *argv])
    out = capsys.readouterr()
    return code, out.out, out.err


SCRUB_CASES = {
    "clean": ([], 0, ["worker 0: OK"]),
    "json": (["--json"], 0, []),
    "damaged_chunk": ([], 1, ["generation 3: CORRUPT", "newest verified 2"]),
    "bitflipped_commits": ([], 1, ["generation 2: CORRUPT", "newest verified 1"]),
    "partially_restored": ([], 1, ["partially restored"]),
    "missing_worker": (["--worker", "5"], 1, ["no checkpoint state"]),
    "repair": (["--repair"], 0, ["worker 0: OK"]),
}


@pytest.mark.parametrize("case", sorted(SCRUB_CASES))
def test_scrub_matches_jax(case, tmp_path, capsys):
    argv, want_code, want_lines = SCRUB_CASES[case]
    got = {}
    for name in PACKAGES:
        root = scrub_root_of(name, tmp_path, case)
        code, out, err = run_scrub(name, [*argv, root], capsys)
        got[name] = (code, same_words(out.replace(root, "ROOT")), same_words(err.replace(root, "ROOT")))
    assert got["torch"] == got["jax"], got
    code, out, err = got["torch"]
    assert code == want_code, got
    assert ("clean" if want_code == 0 else "DAMAGE FOUND") in err
    for line in want_lines:
        assert line in out, out
    if case == "json":
        report = json.loads(out)
        assert report["ok"] is True and report["workers"]["0"]["newest_verified"] == 3
    if case == "repair":
        assert "quarantined damaged generation 3" in err
        assert (tmp_path / "torch" / "pstore" / "quarantine" / "0" / "00000003").exists()
        st, rows, _ = resume(tpz, tpz.FileBackend(str(tmp_path / "torch" / "pstore")))
        assert st.generation == 2 and not st.rejected_generations and len(rows) == 2


def test_scrub_runs_as_a_module(tmp_path):
    import subprocess
    import sys

    root = scrub_root_of("torch", tmp_path, "damaged_chunk")
    proc = subprocess.run([sys.executable, "-m", "pathway_tpu_torch.cli", "scrub", root],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert "generation 3: CORRUPT" in proc.stdout and "DAMAGE FOUND" in proc.stderr
