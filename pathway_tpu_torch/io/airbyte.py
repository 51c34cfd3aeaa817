"""Airbyte sources connector (parity: python/pathway/io/airbyte +
third_party/airbyte_serverless).

Speaks the documented Airbyte protocol directly: a source connector is any
command that emits JSON messages on stdout (``RECORD`` / ``STATE`` /
``LOG``) in response to ``read --config ... --catalog ...``.  The
reference launches connectors as Docker images via airbyte-serverless;
this build additionally supports ``exec`` mode — a locally runnable
connector command (e.g. a pip-installed ``source-faker``) — which is also
how the connector runs in environments without Docker.  STATE messages
checkpoint the stream: they persist in the offset frontier and are passed
back via ``--state`` on resume, the protocol's incremental-sync contract.
"""

from __future__ import annotations

import json as _json
import os
import shlex
import subprocess
import tempfile
from typing import Any

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._utils import COMMIT, Offset, Reader

__all__ = ["read", "write_connection_scaffold"]


class AirbyteError(RuntimeError):
    pass


class _AirbyteReader(Reader):
    supports_offsets = True

    def __init__(
        self,
        exec_command: str | None,
        docker_image: str | None,
        config: dict,
        streams: list[str],
        mode: str,
        refresh_interval: float,
        env_vars: dict | None,
    ):
        self.exec_command = exec_command
        self.docker_image = docker_image
        self.config = config
        self.streams = streams
        self.mode = mode
        self.refresh_interval = refresh_interval
        self.env_vars = env_vars or {}
        self._state: Any = None  # serializable aggregate of STATE payloads

    def seek(self, offset: Any) -> None:
        self._state = offset.get("state")

    def _record_state(self, st: Any) -> None:
        """Fold one STATE message into the resumable aggregate.

        Modern sources emit one STREAM-typed message *per stream*; keeping
        only the latest would drop every other stream's cursor, so they are
        accumulated keyed by stream descriptor.  GLOBAL-typed and legacy
        blobs cover all streams at once and replace the aggregate.
        """
        if isinstance(st, dict) and st.get("type") == "STREAM":
            if not (isinstance(self._state, dict) and "per_stream" in self._state):
                self._state = {"per_stream": {}}
            desc = st.get("stream", {}).get("stream_descriptor", {})
            key = f"{desc.get('namespace', '')}:{desc.get('name', '')}"
            self._state["per_stream"][key] = st
        else:
            self._state = st

    def _offset(self) -> Offset:
        return Offset({"state": self._state})

    def _command(self, args: list[str], mount_dir: str | None = None) -> list[str]:
        if self.exec_command:
            return shlex.split(self.exec_command) + args
        if self.docker_image:
            # docker mode (the reference's default); the temp dir holding
            # config/catalog/state must be mounted so the container can
            # read the paths the args reference
            mounts = (
                ["-v", f"{mount_dir}:{mount_dir}:ro"] if mount_dir else []
            )
            return [
                "docker",
                "run",
                "--rm",
                "-i",
                *mounts,
                self.docker_image,
            ] + args
        raise AirbyteError("provide exec_command= or a source docker image")

    def _catalog(self) -> dict:
        """Configured catalog: discover, keep the requested streams."""
        with tempfile.TemporaryDirectory() as td:
            cfg = os.path.join(td, "config.json")
            with open(cfg, "w") as f:
                _json.dump(self.config, f)
            proc = subprocess.run(
                self._command(["discover", "--config", cfg], mount_dir=td),
                capture_output=True,
                text=True,
                timeout=300,
                env={**os.environ, **self.env_vars},
            )
        catalog = None
        for line in proc.stdout.splitlines():
            try:
                msg = _json.loads(line)
            except _json.JSONDecodeError:
                continue
            if msg.get("type") == "CATALOG":
                catalog = msg["catalog"]
        if catalog is None:
            raise AirbyteError(
                f"source discover produced no catalog (rc={proc.returncode}): "
                f"{proc.stderr[-300:]}"
            )
        configured = []
        for stream in catalog.get("streams", []):
            if self.streams and stream["name"] not in self.streams:
                continue
            modes = stream.get("supported_sync_modes", ["full_refresh"])
            sync_mode = "incremental" if "incremental" in modes else "full_refresh"
            configured.append(
                {
                    "stream": stream,
                    "sync_mode": sync_mode,
                    "destination_sync_mode": "append",
                }
            )
        if not configured:
            raise AirbyteError(f"no matching streams in catalog: {self.streams}")
        return {"streams": configured}

    def run(self, emit) -> None:
        import time as _time

        catalog = self._catalog()
        while True:
            self._sync_once(catalog, emit)
            if self.mode == "static":
                return
            _time.sleep(self.refresh_interval)

    def _sync_once(self, catalog: dict, emit) -> None:
        with tempfile.TemporaryDirectory() as td:
            cfg = os.path.join(td, "config.json")
            cat = os.path.join(td, "catalog.json")
            with open(cfg, "w") as f:
                _json.dump(self.config, f)
            with open(cat, "w") as f:
                _json.dump(catalog, f)
            args = ["read", "--config", cfg, "--catalog", cat]
            if self._state is not None:
                st = os.path.join(td, "state.json")
                with open(st, "w") as f:
                    _json.dump(self._state_file_payload(self._state), f)
                args += ["--state", st]
            emitted_after_state = False
            with open(os.path.join(td, "stderr.log"), "w+") as errlog:
                proc = subprocess.Popen(
                    self._command(args, mount_dir=td),
                    stdout=subprocess.PIPE,
                    stderr=errlog,
                    text=True,
                    env={**os.environ, **self.env_vars},
                )
                try:
                    for line in proc.stdout:
                        try:
                            msg = _json.loads(line)
                        except _json.JSONDecodeError:
                            continue
                        kind = msg.get("type")
                        if kind == "RECORD":
                            rec = msg["record"]
                            emit(
                                {
                                    "stream": rec.get("stream", ""),
                                    "data": Json(rec.get("data", {})),
                                }
                            )
                            emitted_after_state = True
                        elif kind == "STATE":
                            # checkpoint: everything before this STATE is
                            # covered by it (the protocol's contract)
                            self._record_state(msg["state"])
                            emit(self._offset())
                            emit(COMMIT)
                            emitted_after_state = False
                except BaseException:
                    # reader died mid-stream: don't block on a connector
                    # that may be wedged writing to a full pipe
                    proc.kill()
                    proc.wait()
                    raise
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                    raise AirbyteError(
                        "source kept running 60s after closing its stdout"
                    )
                rc = proc.returncode
                errlog.seek(0)
                errtail = errlog.read()[-300:]
            if emitted_after_state:
                # rows after the connector's last STATE have no covering
                # checkpoint: close the epoch so they are visible, but emit
                # NO offset marker — they must not persist under a stale
                # state (the restart would redeliver them: at-least-once,
                # the strongest guarantee the protocol offers here)
                emit(COMMIT)
            if rc not in (0, None):
                raise AirbyteError(f"source read exited with rc={rc}: {errtail}")

    @staticmethod
    def _state_file_payload(state):
        """Shape the captured STATE payload the way sources expect --state.

        Modern CDK sources take a JSON *list* of AirbyteStateMessage objects
        (``{"type": "STREAM"|"GLOBAL", ...}``); legacy sources take the bare
        ``state.data`` blob.  Anything else passes through unchanged.
        """
        if isinstance(state, dict) and "per_stream" in state:
            return [state["per_stream"][k] for k in sorted(state["per_stream"])]
        if isinstance(state, dict) and "type" in state:
            return [state]
        if isinstance(state, dict) and set(state) == {"data"}:
            return state["data"]
        return state


def read(
    config: dict | str | None = None,
    streams: list[str] | None = None,
    *,
    config_file_path: str | None = None,
    mode: str = "streaming",
    refresh_interval_ms: int = 60_000,
    execution_type: str | None = None,
    enforce_method: str | None = None,
    env_vars: dict | None = None,
    gcp_region: str | None = None,
    gcp_job_name: str | None = None,
    service_user_credentials_file: str | None = None,
    autocommit_duration_ms: int | None = 1500,
    debug_data: Any = None,
    name: str | None = None,
) -> Table:
    """Run an Airbyte source and stream its records.

    ``config_file_path`` is the reference's spelling for a YAML config
    path (equivalent to passing the path as ``config``).  The GCP Cloud
    Run execution tier (``enforce_method``/``gcp_*``) is not available in
    this build — requesting it raises instead of silently running the
    connector locally.

    ``config``: the connection mapping (or a path to the YAML written by
    ``pathway_tpu_torch airbyte create-source``) with ``source.exec_command`` (a
    locally runnable connector) or ``source.docker_image``, plus
    ``source.config`` for the connector's own settings.  Rows have columns
    ``stream`` (str) and ``data`` (json), like the reference connector.
    """
    if config_file_path is not None:
        if config is not None:
            raise ValueError("pass config= or config_file_path=, not both")
        config = config_file_path
    if config is None:
        raise ValueError("airbyte.read requires config= (mapping or YAML path)")
    if enforce_method not in (None, "venv", "local"):
        raise NotImplementedError(
            f"airbyte.read: execution method {enforce_method!r} (GCP Cloud "
            "Run) is not available in this build; the connector protocol "
            "runs locally"
        )
    if execution_type not in (None, "local"):
        raise ValueError(
            f"execution_type={execution_type!r} is not supported in this "
            "build (local subprocess / docker only)"
        )
    if isinstance(config, str):
        conn = _load_yaml_connection(config)
    else:
        conn = config
    source = conn.get("source", conn)
    reader = _AirbyteReader(
        exec_command=source.get("exec_command"),
        docker_image=source.get("docker_image"),
        config=source.get("config", {}),
        streams=list(streams or conn.get("streams", []) or []),
        mode=mode,
        refresh_interval=refresh_interval_ms / 1000.0,
        env_vars=env_vars,
    )
    schema = schema_mod.schema_from_columns(
        {
            "stream": schema_mod.ColumnSchema(name="stream", dtype=dt.STR),
            "data": schema_mod.ColumnSchema(name="data", dtype=dt.JSON),
        }
    )
    return _utils.make_input_table(
        schema,
        lambda: reader,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        debug_data=debug_data,
    )


def _load_yaml_connection(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def write_connection_scaffold(connection: str, image: str) -> str:
    """Create the connection config skeleton ``pathway_tpu_torch airbyte
    create-source`` edits by hand (reference: ``cli.py create_source`` /
    airbyte-serverless ``ConnectionFromFile.init_yaml_config``).
    """
    path = connection if connection.endswith((".yml", ".yaml")) else f"{connection}.yaml"
    name = os.path.splitext(os.path.basename(path))[0]
    with open(path, "x") as f:  # atomic create: refuses to overwrite
        f.write(
            "source:\n"
            f"  docker_image: {image}\n"
            "  # or: exec_command: source-faker   (a locally runnable connector)\n"
            "  config:\n"
            "    # fill in the source's spec fields here\n"
            "streams: []\n"
            f"name: {name}\n"
        )
    return path
